"""Routed-vs-exact assignment A/B on the siftlike corpus (VERDICT r4
item 4).

The routed two-level assigner (ops.hierarchical) exact-matches ~99.9% of
assignments on clustered Gaussian corpora (scale3: 0.9998) but only
~0.73-0.76 on the SIFT-statistics corpus at nc=2^17..2^20 — which is why
the 0.98 pre-build gate falls back to exact assignment there
(bench.build_scale3sl / build_grouping_scale; the flagship indexes ARE
exact-assigned). This tool measures what routed assignment WOULD cost in
recall if the gate did not exist: two index twins over the same 16.7M
stream, same centroids (grouping_scale's cached 2^17 set), same PQ —
differing ONLY in assignment (exact vs routed w=4 vs routed w=16) — then
R@1/10/100 at the reference operating point, plus the in-stream
routed-vs-exact match-rate series (the router-health drift probe) and
list-balance stats.

Reference analog: assignment is exact by construction in the reference
(IndexIVF_HNSW.cpp:68-72, efSearch=220 precompute).

Usage: python tools/assign_ab.py [--nb 16777216]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import bench  # noqa: E402
from ivfhnsw_tpu import IVFADCIndex, IndexConfig, SearchParams  # noqa: E402
from ivfhnsw_tpu.ops.distances import streaming_topk_l2  # noqa: E402
from ivfhnsw_tpu.ops.hierarchical import TwoLevelAssigner  # noqa: E402
from ivfhnsw_tpu.utils.recall import recall_at_k  # noqa: E402
from ivfhnsw_tpu.utils.siftlike import SiftLikeDeviceGen  # noqa: E402


def main():
    bench.force_cpu_backend()
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=16_777_216)
    ap.add_argument("--nprobe", type=int, default=128)
    ap.add_argument("--max-codes", type=int, default=100_000)
    args = ap.parse_args()
    NB = min(args.nb, bench.GS_NB)

    gs = os.path.join(bench.CACHE, "grouping_scale")
    p_cent = os.path.join(gs, "centroids.npy")
    if not os.path.exists(p_cent):
        sys.exit("missing grouping_scale/centroids.npy — run the "
                 "grouping_scale bench stage first (the A/B reuses its "
                 "siftlike 2^17 centroid set)")
    cents = np.load(p_cent)
    nc = cents.shape[0]
    gen = SiftLikeDeviceGen(n_classes=bench.S3SL_NCLS,
                            sigma=bench.S3SL_SIGMA, seed=13,
                            skew=bench.S3SL_SKEW)
    queries = np.asarray(gen.batch_device(jr.PRNGKey(777_777),
                                          bench.GS_NQ))
    key = jax.random.PRNGKey(0)
    hi = jax.lax.Precision.HIGH
    n_sup = min(2048, nc // 4)

    # Shared quantizers: plain residual PQ trained with EXACT assignment
    # (both twins encode with the same codebooks; only the assignment of
    # base vectors differs — isolating the variable under test).
    proto = IVFADCIndex(IndexConfig(d=bench.D, nc=nc,
                                    code_size=bench.CODE_SIZE))
    proto.set_centroids(cents)
    p_pq = os.path.join(gs, "ab.pq")
    p_npq = os.path.join(gs, "ab.norm_pq")
    if os.path.exists(p_pq):
        proto.load_quantizers(p_pq, p_npq)
    else:
        learn = np.asarray(gen.batch_device(jr.PRNGKey(777_003),
                                            min(262_144, NB)))
        print("training shared PQ ...", flush=True)
        proto.train_pq(key, learn)
        proto.save_quantizers(p_pq, p_npq)
        del learn

    routers = {
        "routed_w4": TwoLevelAssigner(cents, n_super=n_sup, w=4,
                                      key=jr.PRNGKey(295)),
        "routed_w16": TwoLevelAssigner(cents, n_super=n_sup, w=16,
                                       key=jr.PRNGKey(295)),
    }
    variants = ["exact"] + list(routers)
    idxs = {}
    for v in variants:
        ix = IVFADCIndex(IndexConfig(d=bench.D, nc=nc,
                                     code_size=bench.CODE_SIZE))
        ix.set_centroids(cents)
        ix.pq, ix.norm_pq = proto.pq, proto.norm_pq
        idxs[v] = ix

    bs = 1_048_576
    qj = jnp.asarray(queries)
    best_d = np.full((queries.shape[0], 1), np.inf, np.float32)
    best_l = np.full((queries.shape[0], 1), -1, np.int64)
    drift = {v: [] for v in routers}
    match_sum = {v: 0.0 for v in routers}
    t0 = time.time()
    assign_s = {v: 0.0 for v in variants}
    print(f"A/B stream: {NB} vectors x {len(variants)} assignment "
          "variants ...", flush=True)
    for bi, off in enumerate(range(0, NB, bs)):
        blk = gen.batch_device(jr.PRNGKey(4_000_000 + bi),
                               min(bs, NB - off))
        n = int(blk.shape[0])
        xids = np.arange(off, off + n, dtype=np.int32)
        t = time.time()
        keys_ex = idxs["exact"]._assign_device_exact(blk)
        assign_s["exact"] += time.time() - t
        keys_v = {"exact": keys_ex}
        for v, router in routers.items():
            t = time.time()
            kv = np.asarray(router.assign_device(blk), np.int32)
            assign_s[v] += time.time() - t
            keys_v[v] = kv
            rate = float((kv == keys_ex).mean())
            match_sum[v] += rate
            drift[v].append({"batch": bi, "match_rate": round(rate, 4)})
        for v in variants:
            codes, ncodes = idxs[v]._encode_batch(
                blk, jnp.asarray(keys_v[v]))
            idxs[v].builder.add(keys_v[v], xids, np.asarray(codes),
                                np.asarray(ncodes))
        d_, i_ = streaming_topk_l2(qj, blk, 1, block=131_072, precision=hi)
        d_, i_ = np.asarray(d_), np.asarray(i_) + off
        upd = d_[:, 0] < best_d[:, 0]
        best_d[upd] = d_[upd]
        best_l[upd] = i_[upd]
        print(f"  {off + n}/{NB} ({time.time()-t0:.0f}s)", flush=True)

    out = {"nb": NB, "nc": nc, "nprobe": args.nprobe,
           "max_codes": args.max_codes,
           "corpus": "siftlike (grouping_scale centroids, seed 13)",
           "variants": {}}
    for v in variants:
        ix = idxs[v]
        ix.finalize()
        sizes = np.diff(np.asarray(ix.store.list_offsets))
        sp = SearchParams(k=100, nprobe=args.nprobe,
                          max_codes=args.max_codes)
        dem = int(ix.scan_slot_demand(queries, sp).max())
        sp = SearchParams(k=100, nprobe=args.nprobe,
                          max_codes=args.max_codes,
                          scan_budget=dem * ix.scan_unit())
        t = time.time()
        _, labels = ix.search(queries, sp, batch=256)
        search_s = time.time() - t
        rec = recall_at_k(labels, best_l, ks=(1, 10, 100))
        ventry = {
            "recall_at_1": round(rec[1], 4),
            "recall_at_10": round(rec[10], 4),
            "recall_at_100": round(rec[100], 4),
            "assign_seconds": round(assign_s[v], 1),
            "search_seconds_unpipelined": round(search_s, 1),
            "list_size_max": int(sizes.max()),
            "list_size_p99": int(np.percentile(sizes, 99)),
            "empty_lists": int((sizes == 0).sum()),
        }
        if v in routers:
            ventry["mean_match_rate"] = round(
                match_sum[v] / len(drift[v]), 4)
            ventry["drift_min_match_rate"] = round(
                min(d["match_rate"] for d in drift[v]), 4)
            ventry["drift_series"] = drift[v]
        out["variants"][v] = ventry
        print(f"{v}: R@1={rec[1]:.4f} R@10={rec[10]:.4f} "
              f"R@100={rec[100]:.4f} assign={assign_s[v]:.0f}s",
              flush=True)
        ix.release_device()

    print(json.dumps({k: v for k, v in out.items() if k != "variants"}
                     | {"variants": {vv: {kk: x for kk, x in e.items()
                                          if kk != "drift_series"}
                                     for vv, e in out["variants"].items()}}),
          flush=True)
    p = os.path.join(bench.CACHE, "assign_ab.json")
    with open(p + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(p + ".tmp", p)


if __name__ == "__main__":
    main()
