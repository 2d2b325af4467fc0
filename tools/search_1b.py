"""Search the 1B index on ONE chip by streaming posting-list shards.

The 1B index (tools/build_1b.py's spill: 1e9 encoded vectors at nc=2^20,
~21 GB) was sized past one small chip's memory, so this driver runs
the EXACT math `parallel/sharded.py` runs concurrently on a mesh —
sequentially, one shard at a time, on the one available chip:

  1. GLOBAL coarse top-nprobe over all 2^20 centroids (one exact matmul
     sweep; sharded.py phase 1+2: local top-nprobe, all_gather, global
     re-top-nprobe — the composition is exactly a global top-nprobe).
  2. Per centroid-range shard: mask the global probe set to this shard's
     range, scan its posting lists via `IVFADCIndex.search_precomputed`
     (the search2 surface, IndexIVF_HNSW.h:178) with the same
     max_codes-crossing budget semantics, local top-k.
     (sharded.py phase 3-4: per-device masked scan + local top-k.)
  3. Merge per-shard top-k by (distance, label) — sharded.py phase 5's
     all_gather + global top-k, as a host reduction.

Probe-set equivalence to the single-chip search is exact: a probe in the
global top-nprobe lands in exactly one shard, pads carry +inf
query-centroid distance and point at an EMPTY pad list (zero codes, zero
budget), and each shard applies the global max_codes budget to its probes
in global ascending-distance order — a superset-free, overlap-free
partition of the single-chip scan.

Recall is evaluated against the in-stream exact groundtruth
tools/build_1b.py merges while building (workdir/gt.npy). Reference
analog: search at nb=10^9 is the reference's reason to exist
(IndexIVF_HNSW.cpp:234-296, test_ivfhnsw_sift1b.cpp:188-215).

Usage:
    python tools/search_1b.py [--shards 4] [--nprobe 128]
        [--max-codes 100000] [--k 100] [--workdir .bench_cache/build1b]
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

import bench  # noqa: E402
from ivfhnsw_tpu import IVFADCIndex, IndexConfig, SearchParams  # noqa: E402
from ivfhnsw_tpu.models.storage import PostingListStore  # noqa: E402
from ivfhnsw_tpu.ops.distances import streaming_topk_l2  # noqa: E402
from ivfhnsw_tpu.utils.recall import recall_at_k  # noqa: E402


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def shard_store(keys, ids, codes, ncodes, offsets_global, lo, hi, M):
    """Build shard [lo, hi)'s local store + one EMPTY pad list at local id
    (hi-lo). The spill is unsorted by key, so select by mask; the
    per-shard sort is PostingListBuilder's sort restricted to the range."""
    nc_loc = hi - lo
    sel = np.flatnonzero((keys >= lo) & (keys < hi))
    k_loc = keys[sel] - lo
    order = np.argsort(k_loc, kind="stable")
    sel = sel[order]
    k_loc = k_loc[order]
    sizes = np.bincount(k_loc, minlength=nc_loc + 1)  # pad list stays 0
    offs = np.zeros(nc_loc + 2, np.int64)
    np.cumsum(sizes, out=offs[1:])
    return PostingListStore(codes=codes[sel], ids=ids[sel],
                            norm_codes=ncodes[sel],
                            list_offsets=offs.astype(np.int32),
                            nc=nc_loc + 1)


def main():
    bench.force_cpu_backend()   # honor BENCH_FORCE_CPU (CI smoke runs
                                # must not block on a busy real chip)
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--nprobe", type=int, default=128)
    ap.add_argument("--max-codes", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--workdir",
                    default=os.path.join(bench.CACHE, "build1b"))
    args = ap.parse_args()
    S, nprobe, k = args.shards, args.nprobe, args.k

    sdir = os.path.join(bench.CACHE, "scale3")
    cents = np.load(os.path.join(sdir, "centroids.npy"))
    nc, d = cents.shape
    wd = args.workdir
    with open(os.path.join(wd, "cursor.json")) as f:
        cursor = json.load(f)
    ntotal = cursor["processed"]
    queries = np.load(os.path.join(wd, "queries.npy"))
    gt = np.load(os.path.join(wd, "gt.npy"))
    nq = queries.shape[0]
    M = bench.CODE_SIZE
    print(f"1B search: ntotal={ntotal} nc={nc} shards={S} nq={nq} "
          f"nprobe={nprobe} max_codes={args.max_codes} k={k}", flush=True)

    t_load = time.time()
    keys = np.fromfile(os.path.join(wd, "keys.i32"), "<i4", count=ntotal)
    ids = np.fromfile(os.path.join(wd, "ids.i32"), "<i4", count=ntotal)
    ncodes = np.fromfile(os.path.join(wd, "norm_codes.u8"), "u1",
                         count=ntotal)
    codes = np.memmap(os.path.join(wd, "codes.u8"), "u1", mode="r",
                      shape=(ntotal, M))
    print(f"spill mapped in {time.time()-t_load:.0f}s", flush=True)

    # Model state (shared by every shard).
    proto = IVFADCIndex(IndexConfig(d=d, nc=nc, code_size=M))
    proto.set_centroids(cents)
    proto.load_quantizers(os.path.join(sdir, "scale3.pq"),
                          os.path.join(sdir, "scale3.norm_pq"))

    # --- Phase 1: global coarse top-nprobe (one sweep over all 2^20
    # centroids — identical to the single-chip exact coarse path).
    t1 = time.time()
    qj = jnp.asarray(queries)
    qc_d, probes_g = streaming_topk_l2(
        qj, proto.centroids, nprobe, block=proto._cb(),
        point_sqnorms=proto.centroid_norms,
        precision=jax.lax.Precision.HIGH)
    qc_d, probes_g = np.asarray(qc_d), np.asarray(probes_g)
    coarse_s = time.time() - t1
    print(f"global coarse top-{nprobe}: {coarse_s:.1f}s "
          f"({coarse_s*1e6/nq:.1f} us/q)", flush=True)

    # Global max-list bound for the static scan width.
    sizes_g = np.bincount(keys, minlength=nc)
    L = _round_up(args.max_codes + int(sizes_g.max()), 128)

    per_shard = []
    all_d = np.full((nq, S * k), np.inf, np.float32)
    all_l = np.full((nq, S * k), -1, np.int64)
    nc_per = -(-nc // S)
    for s in range(S):
        lo, hi = s * nc_per, min((s + 1) * nc_per, nc)
        nc_loc = hi - lo
        t_s = time.time()
        store = shard_store(keys, ids, codes, ncodes, None, lo, hi, M)
        gather_s = time.time() - t_s
        # Shard-local index: local centroids + one zero pad centroid for
        # the empty pad list (term1 = inf - 0 stays +inf for pads).
        cfg = IndexConfig(d=d, nc=nc_loc + 1, code_size=M)
        sidx = IVFADCIndex(cfg)
        c_loc = np.vstack([cents[lo:hi], np.zeros((1, d), np.float32)])
        sidx.set_centroids(c_loc)
        sidx.pq, sidx.norm_pq = proto.pq, proto.norm_pq
        sidx.store = store

        # Shard-masked probe set in GLOBAL ascending-distance order; pads
        # (probes owned by other shards) point at the empty list with
        # +inf distance and zero scan cost.
        m = (probes_g >= lo) & (probes_g < hi)
        order = np.argsort(~m, axis=1, kind="stable")
        p_sh = (np.take_along_axis(probes_g, order, 1) - lo).astype(np.int32)
        d_sh = np.take_along_axis(qc_d, order, 1).astype(np.float32)
        msk = np.take_along_axis(m, order, 1)
        p_sh[~msk] = nc_loc          # empty pad list
        d_sh[~msk] = np.inf

        sp = SearchParams(k=k, nprobe=nprobe, max_codes=args.max_codes,
                          scan_budget=L)
        t_q = time.time()
        B = 128
        for off in range(0, nq, B):
            d_o, l_o = sidx.search_precomputed(
                queries[off:off + B], p_sh[off:off + B],
                d_sh[off:off + B], sp)
            all_d[off:off + B, s * k:(s + 1) * k] = d_o
            all_l[off:off + B, s * k:(s + 1) * k] = l_o
        search_s = time.time() - t_q
        shard_codes = int(store.codes.shape[0])
        per_shard.append({
            "shard": s, "nc": nc_loc, "codes": shard_codes,
            "host_assemble_seconds": round(gather_s, 1),
            "search_seconds": round(search_s, 1),
            "us_per_query": round(search_s * 1e6 / nq, 1),
            "qps": round(nq / search_s, 1)})
        print(f"shard {s}: {shard_codes} codes, assemble {gather_s:.0f}s, "
              f"search {search_s:.1f}s ({search_s*1e6/nq:.0f} us/q)",
              flush=True)
        store.release_device()
        del store, sidx
        import gc
        gc.collect()

        # Progressive publish: a run cut short by a wall clock or a
        # device stall still leaves the shards it DID stream as a
        # parseable artifact. The cumulative merge over shards 0..s is a
        # search of the sub-corpus those centroid ranges own
        # (codes_covered says how much), and its recall vs the full
        # groundtruth is a lower bound that reaches the full-corpus
        # number when shards_done == shards.
        sel_p = np.lexsort((all_l, all_d), axis=1)[:, :k]
        rec_p = recall_at_k(np.take_along_axis(all_l, sel_p, axis=1),
                            gt, ks=(1, 10, 100))
        prog = {
            "nb": ntotal, "nc": nc, "shards": S,
            "shards_done": s + 1, "partial": s + 1 < S, "nq": nq,
            "nprobe": nprobe, "max_codes": args.max_codes, "k": k,
            "codes_covered": int(sum(p["codes"] for p in per_shard)),
            "recall_at_1": round(rec_p[1], 4),
            "recall_at_10": round(rec_p[10], 4),
            "recall_at_100": round(rec_p[100], 4),
            "coarse_seconds": round(coarse_s, 1),
            "per_shard": per_shard,
        }
        p_prog = os.path.join(bench.CACHE, "search1b.json")
        with open(p_prog + ".tmp", "w") as f:
            json.dump(prog, f)
        os.replace(p_prog + ".tmp", p_prog)

    # --- Phase 3: global top-k merge, (distance, label) tiebreak
    # (sharded.py phase 5 / utils.cpp:193-202).
    sel = np.lexsort((all_l, all_d), axis=1)[:, :k]
    fin_d = np.take_along_axis(all_d, sel, axis=1)
    fin_l = np.take_along_axis(all_l, sel, axis=1)
    rec = recall_at_k(fin_l, gt, ks=(1, 10, 100))
    total_search = sum(p["search_seconds"] for p in per_shard)
    out = {
        "nb": ntotal, "nc": nc, "shards": S, "shards_done": S,
        "partial": False,
        "codes_covered": int(sum(p["codes"] for p in per_shard)),
        "nq": nq,
        "nprobe": nprobe, "max_codes": args.max_codes, "k": k,
        "recall_at_1": round(rec[1], 4),
        "recall_at_10": round(rec[10], 4),
        "recall_at_100": round(rec[100], 4),
        "coarse_seconds": round(coarse_s, 1),
        "per_shard": per_shard,
        "total_search_seconds": round(total_search, 1),
        "us_per_query_total": round(
            (coarse_s + total_search) * 1e6 / nq, 1),
        "qps_effective": round(nq / (coarse_s + total_search), 2),
        "engine": "search_precomputed (search2 XLA path), sequential "
                  "shard streaming; merge math = parallel/sharded.py",
    }
    print(json.dumps(out), flush=True)
    p = os.path.join(bench.CACHE, "search1b.json")
    with open(p + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(p + ".tmp", p)


if __name__ == "__main__":
    main()
