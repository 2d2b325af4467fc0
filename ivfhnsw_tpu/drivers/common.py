"""Shared driver pipeline.

Replicates the reference drivers' stage structure (SURVEY.md §3.6, e.g.
tests/test_ivfhnsw_sift1b.cpp):

    Parser -> load gt -> load queries -> build quantizer
    -> [PQ files exist? load : train + save]
    -> [precomputed idxs exist? load : assign in 1M batches + save (.ivecs)]
    -> [index exists? read : add loop + write]
    -> set search params -> timed search loop -> Recall@k + us/query

Every expensive stage is exists()-gated so reruns resume from artifacts,
exactly like the reference (test_ivfhnsw_sift1b.cpp:54,95,125). The
precomputed-assignment cache uses the reference's .ivecs batch format
(uint32 records, 1M-vector batches), so reference-produced idx files are
directly consumable and vice versa.

Datasets are either file-backed (.bvecs/.fvecs base per the extension —
covering both the SIFT1B and DEEP1B driver variants, whose only difference
is the reader type) or synthetic (deterministic clustered corpus with exact
groundtruth computed on device) for environments without the corpora.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ivfhnsw_tpu.utils import io
from ivfhnsw_tpu.utils.config import RunConfig
from ivfhnsw_tpu.utils.recall import recall_at_k
from ivfhnsw_tpu.utils.timer import StopW

ASSIGN_BATCH = 1_000_000  # reference batch size (test_ivfhnsw_sift1b.cpp:102)


def log(msg: str) -> None:
    print(msg, flush=True)


class SyntheticDataset:
    """Deterministic clustered corpus + exact groundtruth (computed once on
    the accelerator, cached beside the other artifacts)."""

    def __init__(self, cfg: RunConfig, seed: int = 0, cache_dir: str = ""):
        rng = np.random.RandomState(seed)
        d = cfg.index.d
        self.nb = cfg.nb or 200_000
        self.nt = cfg.nt or max(self.nb // 10, 10_000)
        self.nq = cfg.nq or 1000
        n_clusters = max(64, cfg.index.nc)
        centers = rng.randn(n_clusters, d).astype(np.float32) * 4.0
        scales = 0.5 + rng.rand(n_clusters, 1).astype(np.float32)

        def draw(n):
            a = rng.randint(0, n_clusters, n)
            return centers[a] + rng.randn(n, d).astype(np.float32) * scales[a]

        self.base = draw(self.nb)
        self.learn = draw(self.nt)
        self.queries = draw(self.nq)
        self._cache_dir = cache_dir
        self._gt = None
        self.ngt = 1

    @property
    def gt(self) -> np.ndarray:
        if self._gt is None:
            path = (os.path.join(self._cache_dir, "synthetic_gt.npy")
                    if self._cache_dir else "")
            if path and os.path.exists(path):
                self._gt = np.load(path)
            else:
                import jax
                import jax.numpy as jnp
                from ivfhnsw_tpu.ops.distances import streaming_topk_l2
                log("computing exact groundtruth ...")
                gt = np.empty((self.nq, 1), np.int64)
                basej = jnp.asarray(self.base)
                for off in range(0, self.nq, 1024):
                    _, i_ = streaming_topk_l2(
                        jnp.asarray(self.queries[off:off + 1024]), basej, 1,
                        block=131_072, precision=jax.lax.Precision.HIGHEST)
                    gt[off:off + 1024] = np.asarray(i_)
                self._gt = gt
                if path:
                    np.save(path, gt)
        return self._gt

    def base_batches(self, batch: int = ASSIGN_BATCH):
        for off in range(0, self.nb, batch):
            yield off, self.base[off:off + batch]

    @property
    def total_base(self) -> int:
        return self.nb


class FileDataset:
    """File-backed dataset per the reference path conventions."""

    def __init__(self, cfg: RunConfig):
        d = cfg.index.d
        self.nb = cfg.nb
        self.nt = cfg.nt
        self.nq = cfg.nq
        self.ngt = cfg.ngt
        self._cfg = cfg
        self._d = d
        self.queries = io.read_xvec_fvec(cfg.path_q, d, cfg.nq)
        self.gt = io.read_xvec(cfg.path_gt, cfg.ngt, cfg.nq,
                               dtype=np.int32).astype(np.int64)
        self._learn = None

    @property
    def learn(self) -> np.ndarray:
        if self._learn is None:
            self._learn = io.read_xvec_fvec(self._cfg.path_learn, self._d,
                                            self._cfg.nt)
        return self._learn

    def base_batches(self, batch: int = ASSIGN_BATCH):
        total = self.total_base
        for off in range(0, total, batch):
            n = min(batch, total - off)
            yield off, io.read_xvec_fvec(self._cfg.path_base, self._d, n,
                                         off)

    @property
    def total_base(self) -> int:
        """Base-vector count from the file size (no decode sweep)."""
        cfg = self._cfg
        return cfg.nb or io.xvec_count(
            cfg.path_base, self._d,
            io.XVEC_DTYPES[os.path.splitext(cfg.path_base)[1]])


def get_dataset(cfg: RunConfig, synthetic_seed: int | None = None,
                cache_dir: str = ""):
    if synthetic_seed is not None or not cfg.path_base:
        return SyntheticDataset(cfg, seed=synthetic_seed or 0,
                                cache_dir=cache_dir)
    return FileDataset(cfg)


def setup_quantizer(index, cfg: RunConfig, ds, key) -> None:
    """Centroids: load from path_centroids if present (the reference's
    external-k-means input, README.md:56), else train on-device (new
    capability) and save in .fvecs so reruns and the reference can load."""
    path = cfg.path_centroids
    if path and os.path.exists(path):
        log(f"loading centroids from {path}")
        index.load_centroids(path)
    else:
        w = StopW()
        log(f"training {cfg.index.nc} centroids on-device ...")
        nsub = min(ds.learn.shape[0], max(cfg.index.nc * 32, 100_000))
        index.train_centroids(key, ds.learn[:nsub], niter=15)
        log(f"centroids trained in {w.elapsed_s():.1f}s")
        if path:
            io.write_xvec(path, np.asarray(index.centroids))


def setup_pq(index, cfg: RunConfig, ds, key) -> None:
    """PQ/OPQ/norm-PQ: load if all artifact files exist, else train + save
    (test_ivfhnsw_sift1b.cpp:54-90)."""
    p_pq, p_norm, p_opq = cfg.path_pq, cfg.path_norm_pq, cfg.path_opq_matrix
    have = (p_pq and os.path.exists(p_pq) and p_norm
            and os.path.exists(p_norm)
            and (not cfg.index.do_opq
                 or (p_opq and os.path.exists(p_opq))))
    if have:
        log(f"loading PQ from {p_pq}")
        index.load_quantizers(p_pq, p_norm, p_opq)
        return
    w = StopW()
    nsubt = min(cfg.nsubt or 65536, ds.learn.shape[0])
    sub = io.random_subset(ds.learn, nsubt)
    log(f"training PQ on {nsubt} vectors (do_opq={cfg.index.do_opq}) ...")
    index.train_pq(key, sub)
    log(f"PQ trained in {w.elapsed_s():.1f}s")
    if p_pq and p_norm:
        index.save_quantizers(p_pq, p_norm, p_opq)


def load_or_assign(index, cfg: RunConfig, ds) -> np.ndarray | None:
    """Precomputed coarse assignments, cached in the reference .ivecs batch
    format (test_ivfhnsw_sift1b.cpp:95-120). Returns the full idx array, or
    None if unavailable and not needed."""
    path = cfg.path_precomputed_idxs
    total = ds.total_base
    if path and os.path.exists(path):
        log(f"loading precomputed idxs from {path}")
        # Records are [u32 dim=batch_size | batch_size u32 entries].
        out = []
        with open(path, "rb") as f:
            while True:
                hdr = np.fromfile(f, "<u4", 1)
                if hdr.size == 0:
                    break
                out.append(np.fromfile(f, "<u4", int(hdr[0])))
        return np.concatenate(out).astype(np.int32)[:total]
    w = StopW()
    log("assigning base vectors to centroids ...")
    chunks = []
    done = 0
    for off, batch in io.prefetch(ds.base_batches()):
        chunks.append(index.assign(batch))
        done += batch.shape[0]
        log(f"  assigned {done}/{total} [{w.elapsed_s():.1f}s]")
    idxs = np.concatenate(chunks)
    if path:
        with open(path, "wb") as f:
            for off in range(0, total, ASSIGN_BATCH):
                blk = idxs[off:off + ASSIGN_BATCH].astype("<u4")
                np.asarray([blk.size], "<u4").tofile(f)
                blk.tofile(f)
    return idxs


def build_or_read_index(index, cfg: RunConfig, ds, idxs,
                        grouping: bool = False) -> None:
    """Index: read if the file exists, else add + write
    (test_ivfhnsw_sift1b.cpp:125-162; grouping construction per
    test_ivfhnsw_grouping_sift1b.cpp:136-200)."""
    path = cfg.path_index
    if path and os.path.exists(path):
        log(f"reading index from {path}")
        index.read(path)
        return
    w = StopW()
    total = ds.total_base
    if grouping:
        index.compute_neighbor_centroids()
        log("alpha pass ...")
        for off, batch in io.prefetch(ds.base_batches()):
            index.alpha_pass(batch, idxs[off:off + batch.shape[0]])
        index.finalize_alphas()
    log("adding base vectors ...")
    for off, batch in io.prefetch(ds.base_batches()):
        n = batch.shape[0]
        index.add_batch(batch, np.arange(off, off + n, dtype=np.int32),
                        idxs[off:off + n] if idxs is not None else None)
        log(f"  added {off + n}/{total} [{w.elapsed_s():.1f}s]")
    index.finalize()
    if grouping:
        index.compute_inter_centroid_dists()
    log(f"index built in {w.elapsed_s():.1f}s")
    if path:
        index.write(path)


def eval_search(index, cfg: RunConfig, ds, search_fn=None) -> dict:
    """Timed query loop + Recall@k in the reference's output format
    (test_ivfhnsw_sift1b.cpp:188-215)."""
    import dataclasses
    p = cfg.search
    # cfg.search IS a SearchParams — pass a copy through verbatim so every
    # parsed search flag (incl. scan_budget) applies; a field-by-field
    # rebuild here silently dropped new fields twice already.
    params = dataclasses.replace(p)
    if (p.coarse_mode == "routed"
            and getattr(index, "_routed_coarse", None) is None
            and hasattr(index, "enable_routed_coarse")):
        log("building routed coarse structure (-coarse_mode routed) ...")
        index.enable_routed_coarse()
    fn = search_fn or (lambda q: index.search(q, params))
    fn(ds.queries[:min(256, ds.nq)])  # warmup/compile
    w = StopW()
    dists, labels = fn(ds.queries)
    dt_us = w.getElapsedTimeMicro()
    recalls = recall_at_k(labels, ds.gt, ks=(1, min(p.k, 10), p.k))
    for k, r in sorted(recalls.items()):
        log(f"Recall@{k}: {r:.4f}")
    log(f"Time per query: {dt_us / ds.nq:.1f} us")
    return {"recalls": recalls, "us_per_query": dt_us / ds.nq,
            "dists": dists, "labels": labels}


def parse_driver_args(extra_flags=()):
    """Reference CLI grammar + driver-local flags (e.g. -synthetic SEED).
    Every driver starts here, so this also turns on the persistent compile
    cache (utils.compile_cache)."""
    from ivfhnsw_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    argv = list(sys.argv[1:])
    extras = {}
    for flag in extra_flags:
        if f"-{flag}" in argv:
            i = argv.index(f"-{flag}")
            extras[flag] = argv[i + 1]
            del argv[i:i + 2]
    from ivfhnsw_tpu.utils.config import parse_args
    return parse_args(argv), extras
