"""Smoke run of the IVFADC build-and-search path on one GPU.

Builds an IVFADC index of 2^25 SIFT-statistics vectors (nc = 2^15, PQ16 + a
1-byte norm code) through the public API the drivers use, searches 1,000
held-out queries at the reference's operating points, checks the GPU scan
kernel against the XLA scan at real width, and builds and searches a
Grouping+OPQ index on the XLA path. Data is generated on the device from
``--seed``; nothing is read from disk.

    python chip_smoke.py                  # one GPU
    python chip_smoke.py --four-cards     # only the sharded phase, 4 GPUs
    python chip_smoke.py --rehearse-cpu --n 16384 --nc 64 ...   # CPU dry run

Every phase raises on failure, so the process exits non-zero; the last line
of standard output is one JSON object, printed only after every phase
passed. ``--rehearse-cpu`` runs the same phases on the CPU backend with the
kernel in the Pallas interpreter and never claims a GPU. The times printed
are smoke timings of a single run, not benchmark numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# (nprobe, max_codes): examples/run_sift1b.sh:18 and examples/run_deep1b.sh:18.
OPERATING_POINTS = ((64, 30_000), (128, 100_000))
# examples/run_sift1b_grouping_OPQ.sh:17-18.
GROUPING_POINT = (32, 10_000)
K = 100
BATCH = 1 << 20        # vectors generated and added per device batch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 25, help="base vectors")
    ap.add_argument("--nc", type=int, default=1 << 15, help="coarse lists")
    ap.add_argument("--train", type=int, default=1 << 20,
                    help="training sample (centroids and PQ)")
    ap.add_argument("--nq", type=int, default=1000, help="held-out queries")
    ap.add_argument("--group-n", type=int, default=1 << 23)
    ap.add_argument("--group-nc", type=int, default=1 << 13)
    ap.add_argument("--group-pq-train", type=int, default=65536,
                    help="grouping PQ/OPQ training sample (the reference "
                         "drivers' nsubt)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase over a 4-device mesh")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="CPU dry run: kernel in the Pallas interpreter")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def device_check(args) -> dict:
    import jax
    from ivfhnsw_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    want = "cpu" if args.rehearse_cpu else "gpu"
    if devs[0].platform != want:
        raise RuntimeError(f"no GPU: JAX's first device is {devs[0]} "
                           f"(platform {devs[0].platform!r})")
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        raise RuntimeError(f"need {need} devices, JAX sees {len(devs)}")
    log(f"device_kind: {devs[0].device_kind}  count: {len(devs)}  "
        f"jax: {jax.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache} ({_cache_entries(cache)} entries at start)")
    if not args.rehearse_cpu:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        log("nvidia-smi --query-gpu=name,power.limit:")
        log(smi.stdout.strip())
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "cache": cache}


def _cache_entries(path: str) -> int:
    return len(os.listdir(path)) if os.path.isdir(path) else 0


def _memory(tag: str) -> None:
    import jax
    stats = jax.devices()[0].memory_stats()
    peak = stats.get("peak_bytes_in_use") if stats else None
    log(f"{tag}: peak_bytes_in_use="
        + (f"{peak} ({peak / 2**30:.2f} GiB)" if peak is not None
           else "not reported by this backend"))


# ---------------------------------------------------------------------------
# Shared: data, exact ground truth, agreement
# ---------------------------------------------------------------------------

def _keys(seed: int):
    import jax
    base = jax.random.PRNGKey(seed)
    names = ("train", "base", "queries", "centroids", "pq", "gtrain", "gbase",
             "gcentroids", "gpq")
    return dict(zip(names, jax.random.split(base, len(names))))


def base_batches(gen, key, n: int, batch: int):
    """(offset, device batch) over the n base vectors; the same key always
    regenerates the same bytes, so a pass can be repeated."""
    import jax
    for i, off in enumerate(range(0, n, batch)):
        yield off, gen.batch_device(jax.random.fold_in(key, i),
                                    min(batch, n - off))


def exact_topk(gen, key, n: int, batch: int, queries, k: int):
    """Exact top-k ids of every query over the regenerated base, on the
    device at Precision.HIGHEST."""
    import jax
    import jax.numpy as jnp
    from ivfhnsw_tpu.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu.ops.topk import merge_topk
    hp = jax.lax.Precision.HIGHEST
    best_d = jnp.full((queries.shape[0], k), jnp.inf, jnp.float32)
    best_i = jnp.zeros((queries.shape[0], k), jnp.int32)
    for off, x in base_batches(gen, key, n, batch):
        d, i = streaming_topk_l2(queries, x, k, block=65536, precision=hp)
        best_d, best_i = merge_topk(best_d, best_i, d, i + off, k)
    return np.asarray(best_i)


def agreement(d_a, l_a, d_b, l_b, tol: float, excused=None) -> dict:
    """Two engines' (dists, labels) agree when every rank's distance is
    within ``tol`` and every label one side returns the other lacks sits at
    a distance within ``tol`` of the other side's k-th (a tie at the
    boundary); labels both return must carry distances within ``tol``.

    ``excused`` marks queries whose scanned lists are themselves a tie
    (:func:`coarse_ties`): their violations are counted, not failed."""
    d_a, d_b = np.asarray(d_a), np.asarray(d_b)
    l_a, l_b = np.asarray(l_a), np.asarray(l_b)
    if excused is None:
        excused = np.zeros(l_a.shape[0], bool)
    fin = np.isfinite(d_a) & np.isfinite(d_b)
    if not np.array_equal(np.isfinite(d_a), np.isfinite(d_b)):
        raise AssertionError("engines return different result counts")
    bad = np.zeros(l_a.shape[0], np.int64)
    for q in range(l_a.shape[0]):
        pos_b = {int(l): j for j, l in enumerate(l_b[q]) if l >= 0}
        kth_b = d_b[q][np.isfinite(d_b[q])].max(initial=np.inf)
        for j, l in enumerate(l_a[q]):
            if l < 0:
                continue
            if int(l) in pos_b:
                if abs(d_a[q, j] - d_b[q, pos_b[int(l)]]) > tol:
                    bad[q] += 1
            elif d_a[q, j] < kth_b - tol:
                bad[q] += 1
    dd = np.where(fin, np.abs(d_a - d_b), 0.0).max(axis=1, initial=0.0)
    max_dd = float(dd[~excused].max(initial=0.0))
    failing = np.flatnonzero(~excused & ((bad > 0) | (dd > tol)))
    return {"max_abs_ddist": max_dd, "tol": tol,
            "label_equal": float(np.mean(l_a == l_b)),
            "violations": int(bad[~excused].sum()),
            "excused": int(excused.sum()),
            "excused_violations": int(bad[excused].sum()),
            "failing": [(int(q), int(bad[q]), float(dd[q]))
                        for q in failing[:10]],
            "ok": failing.size == 0}


def coarse_ties(idx, queries, nprobe: int, max_codes: int):
    """Queries whose scanned set of lists is decided by a near-tie of
    coarse distances: at the nprobe cut, or around the probe that crosses
    the max_codes budget. Two programs that compute the coarse distances
    in another summation order (another engine, batch or shard, or another
    matmul algorithm picked by the autotuner) may order such a pair
    differently and so scan other lists. A tie is a gap below twice the
    worst-case f32 error of ||q||^2 + ||c||^2 - 2<q, c> summed in any
    order, d * 2^-24 * (||q||^2 + max ||c||^2) per distance."""
    import jax
    from ivfhnsw_tpu.ops.distances import streaming_topk_l2
    nprobe = min(nprobe, idx.nc - 1)
    q = np.asarray(queries, np.float32)
    d, p = streaming_topk_l2(q, idx.centroids, nprobe + 1,
                             point_sqnorms=idx.centroid_norms,
                             precision=jax.lax.Precision.HIGHEST)
    d, p = np.asarray(d, np.float64), np.asarray(p)
    eps = 2 * idx.d * 2.0 ** -24 * (
        (q.astype(np.float64) ** 2).sum(1)
        + float(np.max(np.asarray(idx.centroid_norms))))
    sizes = idx.store.list_sizes()[p[:, :nprobe]]
    cum_before = np.cumsum(sizes, axis=1) - sizes
    inc = (cum_before < max_codes) if max_codes > 0 else np.ones_like(
        sizes, bool)
    last = inc.sum(axis=1) - 1                     # budget-crossing probe
    gaps = np.diff(d, axis=1)                      # [nq, nprobe]
    rows = np.arange(q.shape[0])
    tie = gaps[:, nprobe - 1] <= eps
    for off in (-1, 0):
        j = np.clip(last + off, 0, nprobe - 1)
        tie |= gaps[rows, j] <= eps
    return tie


def _check(tag: str, res: dict) -> None:
    log(f"{tag}: max|dd|={res['max_abs_ddist']:.6g} (tol {res['tol']:.6g}) "
        f"labels equal {res['label_equal']:.6f} "
        f"violations {res['violations']}; coarse-tie queries "
        f"{res['excused']} with {res['excused_violations']} violations")
    if not res["ok"]:
        raise AssertionError(
            f"{tag}: engines disagree beyond tolerance; (query, violations, "
            f"max|dd|) of the first failing queries: {res['failing']}")


def _tol(*dists) -> float:
    m = max(float(np.max(np.abs(d), where=np.isfinite(d), initial=0.0))
            for d in dists)
    return 1e-4 * m


# ---------------------------------------------------------------------------
# Phase 2: IVFADC build + search
# ---------------------------------------------------------------------------

def build_ivfadc(args, gen, keys):
    import jax
    import jax.numpy as jnp
    from ivfhnsw_tpu import IndexConfig, IVFADCIndex
    from ivfhnsw_tpu.ops.distances import ARGMIN_PRECISION, streaming_topk_l2

    idx = IVFADCIndex(IndexConfig(d=128, nc=args.nc, code_size=16))
    t0 = time.perf_counter()
    train = gen.batch_device(keys["train"], args.train)
    idx.train_centroids(keys["centroids"], train, niter=15)
    idx.train_pq(keys["pq"], np.asarray(train))
    t_train = time.perf_counter() - t0

    # ARGMIN_PRECISION's assignment agreement with HIGHEST on this data.
    sample = train[:min(1 << 17, args.train)]
    _, a_fast = streaming_topk_l2(sample, idx.centroids, 1,
                                  point_sqnorms=idx.centroid_norms,
                                  precision=ARGMIN_PRECISION)
    _, a_exact = streaming_topk_l2(sample, idx.centroids, 1,
                                   point_sqnorms=idx.centroid_norms,
                                   precision=jax.lax.Precision.HIGHEST)
    agree = float(jnp.mean(a_fast[:, 0] == a_exact[:, 0]))
    log(f"phase2: assignment agreement {ARGMIN_PRECISION} vs HIGHEST on "
        f"{sample.shape[0]} vectors: {agree:.6f}")
    del train, sample

    t1 = time.perf_counter()
    for off, x in base_batches(gen, keys["base"], args.n, args.batch):
        idx.add_batch_device(
            x, np.arange(off, off + x.shape[0], dtype=np.int32))
    idx.finalize()
    t_add = time.perf_counter() - t1
    sizes = idx.store.list_sizes()
    log(f"phase2: built n={idx.store.ntotal} nc={idx.nc} "
        f"({idx.store.ntotal / idx.nc:.0f} codes/list, max {sizes.max()}, "
        f"empty {int((sizes == 0).sum())}) — train {t_train:.1f} s, "
        f"add {t_add:.1f} s (smoke timings)")
    return idx


def search_phase(args, idx, gen, keys, engines):
    """Recall of the default engine at both operating points against exact
    search, and its agreement with the XLA engine on the same index."""
    import jax.numpy as jnp
    from ivfhnsw_tpu import SearchParams
    from ivfhnsw_tpu.utils.recall import recall_at_k

    queries = gen.batch_device(keys["queries"], args.nq)
    gt = exact_topk(gen, keys["base"], args.n, args.batch, queries, K)
    q_host = np.asarray(queries)
    kernel = engines["kernel"]
    for nprobe, mc in OPERATING_POINTS:
        p = SearchParams(k=K, nprobe=nprobe, max_codes=mc)
        tag = f"phase2 (nprobe {nprobe}, max_codes {mc})"
        idx.engine = kernel
        t0 = time.perf_counter()
        d, l = idx.search(q_host, p)
        log(f"{tag} {kernel}: first call {time.perf_counter() - t0:.2f} s "
            "(compile included)")
        rec = recall_at_k(l, gt, ks=(1, 10, 100))
        log(f"{tag}: recall@1={rec[1]:.4f} recall@10={rec[10]:.4f} "
            f"recall@100={rec[100]:.4f} (engine {kernel}, vs exact search)")
        # Both engines at one launch batch, so both run the same coarse
        # program (ops.adc.select_probes) on the same shapes.
        b = min([args.nq] + [idx._batch_cap(e, p, min(nprobe, idx.nc))
                             for e in (kernel, "xla")])
        runs = {}
        for eng in (kernel, "xla"):
            idx.engine = eng
            runs[eng] = idx.search(q_host, p, batch=b)
        idx.engine = kernel
        (dk, lk), (dx, lx) = runs[kernel], runs["xla"]
        _check(f"{tag} {kernel} vs xla at batch {b}",
               agreement(dk, lk, dx, lx, _tol(dk, dx),
                         coarse_ties(idx, q_host, nprobe, mc)))
        for eng in (kernel, "xla"):
            b = min(args.nq, idx._batch_cap(eng, p, min(nprobe, idx.nc)))
            fn, a, kw = idx.search_step(p, b, eng)
            mem = fn.lower(jnp.asarray(q_host[:b]), *a,
                           **kw).compile().memory_analysis()
            log(f"{tag} {eng} step at batch {b}: {mem}")
        _memory(tag)
    return q_host, gt


# ---------------------------------------------------------------------------
# Phase 3: kernel vs adc_scan at real width, and both engines end to end
# ---------------------------------------------------------------------------

def kernel_phase(args, idx, q_host, engines):
    import jax
    import jax.numpy as jnp
    from ivfhnsw_tpu import SearchParams
    from ivfhnsw_tpu.ops import adc_kernel
    from ivfhnsw_tpu.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu.ops.pq import _pq_ip_luts

    kernel = engines["kernel"]
    hp = jax.lax.Precision.HIGHEST
    store = idx.store
    q = jnp.asarray(q_host[:min(256, q_host.shape[0])])
    for nprobe, mc in OPERATING_POINTS:
        nprobe = min(nprobe, idx.nc)
        p = SearchParams(k=K, nprobe=nprobe, max_codes=mc)
        qc, probes = streaming_topk_l2(q, idx.centroids, nprobe,
                                       point_sqnorms=idx.centroid_norms,
                                       precision=hp)
        term1 = qc - jnp.take(idx.centroid_norms, probes)
        row_start = jnp.take(store.list_offsets_d, probes)
        sizes = jnp.take(store.list_offsets_d, probes + 1) - row_start
        start, length, bias = adc_kernel.slot_schedule(
            row_start, adc_kernel.budget_sizes(sizes, mc), term1,
            n_slots=idx._n_slots(p, nprobe))
        luts = _pq_ip_luts(q, idx.pq.codebooks, precision=hp)
        dists = adc_kernel.adc_block_scan(
            -2.0 * luts, idx.norm_pq.centroids, store.codes_d,
            store.norm_codes_d, start, length, bias,
            interpret=kernel == "pallas_interpret")
        kd, kl = adc_kernel.scan_topk(dists, start, store.ids_d, K)
        rd, rl = adc_kernel.reference_topk(
            luts, idx.norm_pq.centroids, store.codes_d, store.norm_codes_d,
            store.ids_d, start, length, bias, K)
        live = np.arange(adc_kernel.BLOCK)[None, None, :] < np.asarray(
            length)[:, :, None]
        if not np.array_equal(np.isfinite(np.asarray(dists)),
                              live.reshape(dists.shape)):
            raise AssertionError("kernel masks other rows than the schedule")
        tag = f"phase3 (nprobe {nprobe}, max_codes {mc})"
        log(f"{tag}: scan window {q.shape[0]} queries x "
            f"{start.shape[1]} slots x {adc_kernel.BLOCK} rows, "
            f"{int(jnp.sum(length))} codes")
        _check(f"{tag} kernel vs adc_scan",
               agreement(kd, kl, rd, rl, _tol(kd, rd)))

    # Both engines end to end, in turns: XLA, kernel, kernel, XLA.
    times = {}
    for nprobe, mc in OPERATING_POINTS:
        p = SearchParams(k=K, nprobe=nprobe, max_codes=mc)
        for eng in ("xla", kernel, kernel, "xla"):
            idx.engine = eng
            t0 = time.perf_counter()
            idx.search(q_host, p)
            times.setdefault((nprobe, mc, eng), []).append(
                time.perf_counter() - t0)
        idx.engine = kernel
        tx = times[(nprobe, mc, "xla")]
        tk = times[(nprobe, mc, kernel)]
        log(f"phase3 end-to-end search of {q_host.shape[0]} queries "
            f"(nprobe {nprobe}, max_codes {mc}): xla "
            f"{tx[0]:.4f}/{tx[1]:.4f} s, {kernel} {tk[0]:.4f}/{tk[1]:.4f} s "
            f"(smoke timings; kernel faster: {max(tk) < min(tx)})")


# ---------------------------------------------------------------------------
# Phase 4: Grouping + OPQ + pruning on the XLA path
# ---------------------------------------------------------------------------

def grouping_phase(args, gen, keys):
    from ivfhnsw_tpu import IndexConfig, IVFADCGroupingIndex, SearchParams
    from ivfhnsw_tpu.utils.recall import recall_at_k

    g = IVFADCGroupingIndex(IndexConfig(d=128, nc=args.group_nc,
                                        code_size=16, do_opq=True, nsubc=64))
    t0 = time.perf_counter()
    train = gen.batch_device(keys["gtrain"], args.train)
    g.train_centroids(keys["gcentroids"], train, niter=15)
    g.compute_neighbor_centroids()
    g.train_pq(keys["gpq"], np.asarray(train[:args.group_pq_train]))
    del train
    assigned = []
    for off, x in base_batches(gen, keys["gbase"], args.group_n, args.batch):
        k_ = g.assign_batch_device(x)
        g.alpha_pass_device(x, k_)
        assigned.append(k_)
    g.finalize_alphas()
    for (off, x), k_ in zip(base_batches(gen, keys["gbase"], args.group_n,
                                         args.batch), assigned):
        g.add_batch_device(x, np.arange(off, off + x.shape[0],
                                        dtype=np.int32), precomputed_idx=k_)
    g.finalize()
    g.compute_inter_centroid_dists()
    log(f"phase4: grouping+OPQ built n={g.store.ntotal} nc={g.nc} nsubc=64 "
        f"in {time.perf_counter() - t0:.1f} s (smoke timing)")

    queries = gen.batch_device(keys["queries"], args.nq)
    gt = exact_topk(gen, keys["gbase"], args.group_n, args.batch, queries, K)
    nprobe, mc = GROUPING_POINT
    p = SearchParams(k=K, nprobe=nprobe, max_codes=mc, do_pruning=True)
    q_host = np.asarray(queries)
    g.search(q_host, p)                      # compile
    t0 = time.perf_counter()
    d, l = g.search(q_host, p)
    dt = time.perf_counter() - t0
    rec = recall_at_k(l, gt, ks=(1, 10, 100))
    log(f"phase4 (nprobe {nprobe}, max_codes {mc}, pruning): "
        f"recall@1={rec[1]:.4f} recall@10={rec[10]:.4f} "
        f"recall@100={rec[100]:.4f} vs exact search; search {dt:.3f} s "
        "(smoke timing)")
    if not np.isfinite(d[:, 0]).all() or rec[100] <= 0.0:
        raise AssertionError("grouping search returned no neighbours")
    _memory("phase4")


# ---------------------------------------------------------------------------
# Phase 5: four cards
# ---------------------------------------------------------------------------

def four_card_phase(args, idx, gen, keys, engines):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ivfhnsw_tpu import SearchParams
    from ivfhnsw_tpu.ops.distances import assign_top1
    from ivfhnsw_tpu.parallel.build import make_assign_encode_step
    from ivfhnsw_tpu.parallel.mesh import SHARD_AXIS, make_mesh
    from ivfhnsw_tpu.parallel.sharded import ShardedIVFADC

    mesh = make_mesh(4)
    devs = set(mesh.devices.flat)
    sh = ShardedIVFADC(idx, mesh)
    for name in ("codes", "ids", "norm_codes", "offsets", "centroids"):
        arr = getattr(sh, name)
        held = {s.device for s in arr.addressable_shards}
        if held != devs:
            raise AssertionError(f"shard state {name} is on {held}, "
                                 f"not on all of {devs}")
        log(f"phase5: {name} {arr.shape} sharded over "
            f"{sorted(d.id for d in held)}")

    q_host = np.asarray(gen.batch_device(keys["queries"], args.nq))
    for nprobe, mc in OPERATING_POINTS:
        p = SearchParams(k=K, nprobe=nprobe, max_codes=mc)
        idx.engine = engines["kernel"]
        d1, l1 = idx.search(q_host, p)
        t0 = time.perf_counter()
        d4, l4 = sh.search(q_host, p, engine=engines["kernel"])
        dt = time.perf_counter() - t0
        _check(f"phase5 (nprobe {nprobe}, max_codes {mc}) 4-card vs 1-card",
               agreement(d4, l4, d1, l1, _tol(d4, d1),
                         coarse_ties(idx, q_host, nprobe, mc)))
        log(f"phase5: sharded first call {dt:.2f} s (compile included)")

    # Data-parallel assign + encode over the mesh vs one device, by the
    # same streamed argmin (a [rows, 16384] score block per step).
    step = make_assign_encode_step(mesh, coarse_block=16384)
    n = min(1 << 16, args.n) // 4 * 4
    x = gen.batch_device(jax.random.fold_in(keys["base"], 0), n)
    xs = jax.device_put(x, NamedSharding(mesh, P(SHARD_AXIS)))
    cs = jax.device_put(
        np.asarray(idx.centroids).reshape(4, idx.nc // 4, -1),
        NamedSharding(mesh, P(SHARD_AXIS)))
    keys4, codes4, ncodes4 = step(xs, cs, idx.pq.codebooks,
                                  jnp.zeros((0, 0), jnp.float32),
                                  idx.norm_pq.centroids)
    held = {s.device for s in codes4.addressable_shards}
    if held != devs:
        raise AssertionError(f"encoded codes on {held}, not on all of {devs}")
    _, keys1 = assign_top1(x, idx.centroids, block=16384,
                           precision=jax.lax.Precision.HIGHEST)
    codes1, ncodes1 = idx._encode_batch(x, keys1)
    key_eq = float(jnp.mean(keys4 == keys1))
    code_eq = float(jnp.mean(codes4 == codes1))
    ncode_eq = float(jnp.mean(ncodes4 == ncodes1))
    log(f"phase5: assign+encode over 4 cards vs 1: keys equal {key_eq:.6f}, "
        f"codes equal {code_eq:.6f}, norm codes equal {ncode_eq:.6f} "
        f"({n} vectors)")
    if min(key_eq, code_eq, ncode_eq) < 0.999:
        raise AssertionError("sharded build step disagrees with one device")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rehearse_cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards and "device_count" not in os.environ.get(
                "XLA_FLAGS", ""):
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    t_all = time.perf_counter()
    dev = device_check(args)

    from ivfhnsw_tpu.utils.siftlike import SiftLikeDeviceGen
    gen = SiftLikeDeviceGen(seed=args.seed)
    keys = _keys(args.seed)
    engines = {"kernel": "pallas_interpret" if args.rehearse_cpu
               else "pallas"}

    idx = build_ivfadc(args, gen, keys)
    if args.four_cards:
        four_card_phase(args, idx, gen, keys, engines)
    else:
        q_host, _ = search_phase(args, idx, gen, keys, engines)
        kernel_phase(args, idx, q_host, engines)
        idx.release_device()
        del idx
        grouping_phase(args, gen, keys)
    log(f"compile cache: {_cache_entries(dev['cache'])} entries at end")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    device = {"platform": dev["platform"], "kind": dev["kind"],
              "count": dev["count"]}
    if args.rehearse_cpu:
        print(json.dumps({"rehearsal": "cpu", "passed": True,
                          "device": device}))
    else:
        print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
