"""IVFADC index — the JAX equivalent of `ivfhnsw::IndexIVF_HNSW`
(/root/reference/IndexIVF_HNSW.{h,cpp}).

Reference-surface parity map (file:line cites into /root/reference):

==========================  ====================================================
reference                   here
==========================  ====================================================
ctor (IndexIVF_HNSW.cpp:8)  ``IVFADCIndex(IndexConfig)``
build_quantizer (:40-65)    ``set_centroids`` (exact matmul quantizer; no graph)
  — (external k-means tool) ``train_centroids`` (on-device Lloyd's — new capability)
assign (:68-72)             ``assign``
add_batch (:75-138)         ``add_batch`` + ``finalize``
add_batch2 (:140-204)       ``add_batch2`` (ORCV obuf records)
search (:234-296)           ``search``
search_debug (:328-391)     ``search(..., trace=True)`` + driver-side log writer
search_enn (:393-451)       ``search_enn``
search2 (:453-...)          ``search_precomputed``
search2m (:503-531)         ``search_per_probe``
train_pq (:536-593)         ``train_pq``
write/read (:637-779)       ``write``/``read`` — bit-compatible .index format
write2 (:672-755)           ``write2`` (ORCV home-dir export)
compute_centroid_norms      ``compute_centroid_norms`` (:781-787)
rotate_quantizer (:789)     not needed: orthogonal rotations preserve both
                            ``||q - c||`` and ``||c||``, so coarse search and
                            term1 are computed in the original space and only
                            residuals/queries are rotated for the PQ terms.
pq_L2sqr LUT scan (:802)    ops.adc.adc_scan (XLA) / ops.adc_kernel (GPU)
reconstruct (:817-823)      ``reconstruct``
compute_residuals (:825)    ``compute_residuals``
==========================  ====================================================
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ivfhnsw_tpu.ops import adc as adc_ops
from ivfhnsw_tpu.ops import adc_kernel
from ivfhnsw_tpu.ops import opq as opq_ops
from ivfhnsw_tpu.ops.distances import ARGMIN_PRECISION, streaming_topk_l2
from ivfhnsw_tpu.ops.pq import NormQuantizer, ProductQuantizer
from ivfhnsw_tpu.ops.topk import topk_smallest
from ivfhnsw_tpu.models.storage import (PostingListBuilder, PostingListStore,
                                        store_from_lists)
from ivfhnsw_tpu.utils import io
from ivfhnsw_tpu.utils.config import IndexConfig, SearchParams


# Per-launch bound on a search batch's scan intermediates (see
# IVFADCIndex._batch_cap).
WINDOW_BYTES = 4 << 30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(
    jax.jit,
    static_argnames=("nprobe", "k", "L", "coarse_block", "use_opq", "trace",
                     "coarse_approx", "coarse_recall", "routed_w",
                     "precision"))
def _search_core(queries, centroids, centroid_norms, codebooks,
                 norm_centroids, R, codes, ids, norm_codes, offsets,
                 max_codes, routed=None, *, nprobe: int, k: int, L: int,
                 coarse_block: int, use_opq: bool, trace: bool,
                 coarse_approx=False, coarse_recall: float = 0.95,
                 routed_w: int = 0, precision=jax.lax.Precision.HIGHEST):
    """Jitted IVFADC search over a query batch.

    Implements the 3-term ADC decomposition (IndexIVF_HNSW.cpp:206-233):
    term1 = ||q - c||^2 - ||c||^2 (coarse), term2 = ||y||^2 (decoded norm
    code), term3 = 2<q_rot, y_res_rot> (LUT gather).
    """
    # 1. Coarse quantization: top-nprobe centroids (replaces HNSW
    #    searchKnn; probes come out sorted by ascending distance, which
    #    the max_codes budget relies on — IndexIVF_HNSW.cpp:249-259).
    qc_dists, probes, term1_probe = adc_ops.select_probes(
        queries, centroids, centroid_norms, nprobe=nprobe,
        coarse_block=coarse_block, coarse_approx=coarse_approx,
        coarse_recall=coarse_recall, routed=routed, routed_w=routed_w,
        precision=precision)

    # 2. Per-query inner-product LUTs in the (optionally rotated) space.
    q_rot = queries @ R.T if use_opq else queries
    from ivfhnsw_tpu.ops.pq import _pq_ip_luts
    luts = _pq_ip_luts(q_rot, codebooks, precision=precision)

    # 3. Static-shape scan window with reference max_codes semantics.
    pos, seg, valid, included = adc_ops.probe_positions(
        probes, offsets, max_codes, L)

    # 4. Gather codes / ids / norms; combine the non-LUT terms.
    g_codes = jnp.take(codes, pos, axis=0)                     # [B, L, M]
    g_ids = jnp.take(ids, pos, axis=0)                         # [B, L]
    g_norm = jnp.take(norm_centroids,
                      jnp.take(norm_codes, pos, axis=0).astype(jnp.int32),
                      axis=0)                                  # [B, L]
    term1 = jnp.take_along_axis(term1_probe, seg, axis=1)      # [B, L]
    bias = term1 + g_norm

    # 5. ADC LUT scan + top-k.
    dists, sel = adc_ops.adc_scan(luts, g_codes, bias, valid, k)
    labels = jnp.take_along_axis(g_ids, sel, axis=1)
    labels = jnp.where(jnp.isfinite(dists), labels, -1)
    if trace:
        n_scanned = jnp.sum(valid, axis=1)
        return dists, labels, (probes, qc_dists, included, n_scanned)
    return dists, labels


class IVFADCIndex:
    """IVFADC: exact matmul coarse quantizer + OPQ-rotated residual PQ +
    1-byte norm PQ, with flat sharded posting lists."""

    def __init__(self, config: IndexConfig):
        self.config = config.validate()
        self.d = config.d
        self.nc = config.nc
        self.code_size = config.code_size
        self.do_opq = config.do_opq

        self.centroids: Optional[jnp.ndarray] = None       # [nc, d] f32
        self.centroid_norms: Optional[jnp.ndarray] = None  # [nc] f32
        self.pq = ProductQuantizer(config.d, config.pq_m, config.ksub)
        self.norm_pq = NormQuantizer(config.ksub)
        self.opq_R: Optional[jnp.ndarray] = None           # [d, d] f32
        self.builder = PostingListBuilder(config.nc, config.pq_m)
        self.store: Optional[PostingListStore] = None

        # Knobs mirroring IndexIVF_HNSW.h:61-62 (overridable per call).
        self.nprobe = 32
        self.max_codes = 10000
        # ORCV match thresholds (IndexIVF_HNSW.h:90-91 defaults).
        self.dmatch = 4444.0
        self.dnear = 8888.0
        # Coarse streaming block (centroid rows per matmul sweep step).
        # None = auto (engine-chosen, batch-size aware); an explicit int is
        # a USER CEILING honored uniformly by every engine (search + train +
        # assign) — set it to bound the [B, block] coarse score buffer.
        self.coarse_block = None
        # Scan engine (ops.adc_kernel.resolve_engine): "auto" is the fused
        # Pallas kernel on the GPU and the portable XLA path elsewhere;
        # "xla", "pallas" (GPU only — raises elsewhere) and
        # "pallas_interpret" (the kernel through the Pallas interpreter,
        # for CPU testing) select one explicitly.
        self.engine = "auto"
        # Stats counter, analog of hnswlib dist_calc (hnswalg.h:58).
        self.stats = {"queries": 0, "codes_scanned": 0}

    # ------------------------------------------------------------------
    # Quantizer setup
    # ------------------------------------------------------------------

    def train_centroids(self, key, train_data, niter: int = 20,
                        verbose: bool = False) -> None:
        """On-device coarse centroid learning (the reference outsources this to
        an external k-means tool — README.md:56,62)."""
        from ivfhnsw_tpu.ops.kmeans import kmeans
        cents, _ = kmeans(key, train_data, self.nc, niter=niter,
                          block_c=self._cb(), verbose=verbose)
        self.set_centroids(np.asarray(cents))

    def set_centroids(self, centroids) -> None:
        """build_quantizer equivalent (IndexIVF_HNSW.cpp:40-65): install the
        coarse centroids. No graph is built — the exact matmul top-k IS the
        quantizer."""
        centroids = np.asarray(centroids, np.float32)
        if centroids.shape != (self.nc, self.d):
            raise ValueError(f"centroids shape {centroids.shape} != "
                             f"({self.nc}, {self.d})")
        self.centroids = jnp.asarray(centroids)
        self.compute_centroid_norms()

    def load_centroids(self, path: str) -> None:
        self.set_centroids(io.read_xvec_fvec(path, self.d, self.nc))

    def compute_centroid_norms(self) -> None:
        """IndexIVF_HNSW.cpp:781-787."""
        self.centroid_norms = jnp.sum(self.centroids ** 2, axis=1)

    # ------------------------------------------------------------------
    # Assignment / training
    # ------------------------------------------------------------------

    def enable_fast_assign(self, w: int = 8, n_super: int | None = None,
                           key=None) -> None:
        """Switch `assign` to the two-level routed assigner
        (ops.hierarchical) — the 'assign 1B points in hours' path for large
        nc (~1/30 the exact FLOPs). Accuracy depends on the centroid set
        having mesoscale structure (real descriptor data does; ~99.9%
        exact-match at w=16 on clustered corpora, but uniform-random
        centroid sets defeat super-level routing — validate with
        TwoLevelAssigner.exact_match_rate before committing a build)."""
        from ivfhnsw_tpu.ops.hierarchical import TwoLevelAssigner
        self._fast_assigner = TwoLevelAssigner(
            np.asarray(self.centroids), n_super=n_super, w=w,
            key=key if key is not None else jax.random.PRNGKey(0))

    def enable_routed_coarse(self, w: int = 16, n_super: int | None = None,
                             cap_factor: float = 1.5, key=None,
                             cache_path: str | None = None) -> None:
        """Build the SEARCH-time two-level routing structure
        (ops.routed_coarse.RoutedCoarse): probe selection via top-``w``
        super blocks instead of a full-nc sweep. Used by both search
        engines (ops.adc.select_probes) when ``SearchParams.coarse_mode`` is
        "routed", or "auto" with nc > 16384. Derived data — rebuild after ``read()``;
        accuracy presumes mesoscale centroid structure (measure probe
        overlap vs exact before adopting, as with enable_fast_assign)."""
        from ivfhnsw_tpu.ops.routed_coarse import RoutedCoarse
        if self.centroids is None:
            raise ValueError("set_centroids first")
        import os
        if cache_path is not None and os.path.exists(cache_path):
            z = np.load(cache_path)
            self._routed_coarse = RoutedCoarse.from_state(
                np.asarray(self.centroids), z["supers"], z["members"],
                z["valid"])
        else:
            self._routed_coarse = RoutedCoarse(
                np.asarray(self.centroids), n_super=n_super,
                cap_factor=cap_factor,
                key=key if key is not None else jax.random.PRNGKey(0))
            if cache_path is not None:
                self._routed_coarse.save(cache_path)
        self.routed_w = w

    def _routed_for(self, params: SearchParams, nprobe: int):
        """Resolve the routed-coarse arguments for one search call:
        (routed_tuple, w) when active, else (None, 0). "auto" adopts
        routing whenever the structure exists and the centroid set is
        large enough that exact selection already gave way to approx."""
        mode = getattr(params, "coarse_mode", "auto")
        rc = getattr(self, "_routed_coarse", None)
        if mode == "routed" and rc is None:
            raise ValueError("coarse_mode='routed' requires "
                             "enable_routed_coarse() first")
        if rc is None or mode not in ("routed", "auto") or (
                mode == "auto" and self.nc <= 16384):
            return None, 0
        w = min(getattr(self, "routed_w", 16), rc.n_super)
        if w * rc.cap < nprobe:           # must cover nprobe candidates
            w = min(-(-nprobe // rc.cap), rc.n_super)
        cached = getattr(self, "_routed_table", None)
        if cached is None or cached[0] is not rc:
            cached = (rc, (rc.supers, rc.super_sqn,
                           rc.build_table(self.centroid_norms)))
            self._routed_table = cached
        return cached[1], w

    def assign(self, x, batch: int | None = None) -> np.ndarray:
        """Nearest-centroid ids for x [n, d] (IndexIVF_HNSW.cpp:68-72), in
        streamed batches. Returns int32 [n]. The batch size is capped so the
        per-step [batch, coarse_block] score matrix stays under ~1 GB."""
        if getattr(self, "_fast_assigner", None) is not None:
            return self._fast_assigner.assign(np.asarray(x, np.float32))
        x = np.asarray(x, np.float32)
        if batch is None:
            block = min(self._cb(), self.nc)
            batch = max(1024, min(131072, (1 << 26) // max(block, 1)))
        out = np.empty(x.shape[0], np.int32)
        for off in range(0, x.shape[0], batch):
            blk = jnp.asarray(x[off:off + batch])
            _, idx = streaming_topk_l2(blk, self.centroids, 1,
                                       block=self._cb(),
                                       point_sqnorms=self.centroid_norms,
                                       precision=ARGMIN_PRECISION)
            out[off:off + batch] = np.asarray(idx[:, 0])
        return out

    def compute_residuals(self, x, keys) -> jnp.ndarray:
        """x - centroid[key] (IndexIVF_HNSW.cpp:825-831)."""
        return jnp.asarray(x, jnp.float32) - self.centroids[jnp.asarray(keys)]

    def reconstruct(self, decoded_residuals, keys) -> jnp.ndarray:
        """decoded residual + centroid (IndexIVF_HNSW.cpp:817-823)."""
        return jnp.asarray(decoded_residuals) + self.centroids[jnp.asarray(keys)]

    def train_pq(self, key, train_data, precomputed_idx=None,
                 pq_niter: int = 25, opq_niter: int = 20,
                 verbose: bool = False) -> None:
        """train_pq equivalent (IndexIVF_HNSW.cpp:536-593): assign, residual,
        [OPQ], PQ, then norm-PQ on reconstruction norms."""
        x = np.asarray(train_data, np.float32)
        keys = (np.asarray(precomputed_idx, np.int32)
                if precomputed_idx is not None else self.assign(x))
        residuals = self.compute_residuals(x, keys)
        k_opq, k_pq, k_norm = jax.random.split(key, 3)
        if self.do_opq:
            self.opq_R, self.pq = opq_ops.train_opq(
                k_opq, residuals, self.config.pq_m, niter=opq_niter,
                final_pq_niter=pq_niter, ksub=self.config.ksub,
                verbose=verbose)
            rotated = opq_ops.apply_rotation(residuals, self.opq_R)
        else:
            self.pq.train(k_pq, residuals, niter=pq_niter)
            rotated = residuals
        # Norm quantizer trains on norms of the full reconstructions
        # (IndexIVF_HNSW.cpp:567-592).
        decoded = self.pq.decode(self.pq.encode(rotated))
        if self.do_opq:
            decoded = opq_ops.apply_rotation_transpose(decoded, self.opq_R)
        recon = self.reconstruct(decoded, keys)
        norms = jnp.sum(recon ** 2, axis=1)
        self.norm_pq.train(k_norm, norms)

    # ------------------------------------------------------------------
    # Adding vectors
    # ------------------------------------------------------------------

    def _encode_batch(self, x, keys):
        """Shared encode pipeline: residual -> [rotate] -> PQ -> decode ->
        [unrotate] -> reconstruct -> norm code (IndexIVF_HNSW.cpp:87-121)."""
        residuals = self.compute_residuals(x, keys)
        if self.do_opq:
            residuals = opq_ops.apply_rotation(residuals, self.opq_R)
        codes = self.pq.encode(residuals)
        decoded = self.pq.decode(codes)
        if self.do_opq:
            decoded = opq_ops.apply_rotation_transpose(decoded, self.opq_R)
        recon = self.reconstruct(decoded, keys)
        norms = jnp.sum(recon ** 2, axis=1)
        norm_codes = self.norm_pq.encode(norms)
        return codes, norm_codes

    def add_batch(self, x, xids=None, precomputed_idx=None) -> None:
        """add_batch equivalent (IndexIVF_HNSW.cpp:75-138). Call finalize()
        after the last batch to build the device store."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        keys = (np.asarray(precomputed_idx, np.int32)
                if precomputed_idx is not None else self.assign(x))
        if xids is None:
            xids = np.arange(self.builder.ntotal,
                             self.builder.ntotal + n, dtype=np.int32)
        codes, norm_codes = self._encode_batch(jnp.asarray(x), keys)
        self.builder.add(keys, xids, np.asarray(codes), np.asarray(norm_codes))
        self.store = None

    def _assign_device_exact(self, x_dev) -> np.ndarray:
        """Exact nearest-centroid assignment for device-resident x (no host
        round-trip of the vectors)."""
        rows = max(1024, min(131072, (1 << 26) // max(self._cb(), 1)))
        n = int(x_dev.shape[0])
        out = np.empty(n, np.int32)
        for off in range(0, n, rows):
            _, idx = streaming_topk_l2(x_dev[off:off + rows], self.centroids,
                                       1, block=self._cb(),
                                       point_sqnorms=self.centroid_norms,
                                       precision=ARGMIN_PRECISION)
            out[off:off + rows] = np.asarray(idx[:, 0])
        return out

    def add_batch_device(self, x_dev, xids=None) -> None:
        """Device-resident add_batch: x stays on device end-to-end (assign +
        encode in-place); only keys/codes/norm codes (~21 B/vector) cross to
        the host builder. The build fast path for device-generated or
        pre-staged batches: the f32 vectors (512 B each at d=128) never
        cross the host link."""
        n = int(x_dev.shape[0])
        if getattr(self, "_fast_assigner", None) is not None:
            keys = self._fast_assigner.assign_device(x_dev)
        else:
            keys = self._assign_device_exact(x_dev)
        if xids is None:
            xids = np.arange(self.builder.ntotal,
                             self.builder.ntotal + n, dtype=np.int32)
        codes, norm_codes = self._encode_batch(x_dev, jnp.asarray(keys))
        self.builder.add(keys, xids, np.asarray(codes), np.asarray(norm_codes))
        self.store = None

    def add_batch2(self, x, xids, precomputed_idx, eids) -> bytes:
        """add_batch2 equivalent (IndexIVF_HNSW.cpp:140-204): also add to the
        index, and return the ORCV output buffer of per-vector records
        [8B eid | code_size B PQ code | 1B norm code]."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        keys = np.asarray(precomputed_idx, np.int32)
        codes, norm_codes = self._encode_batch(jnp.asarray(x), keys)
        codes_np = np.asarray(codes)
        norms_np = np.asarray(norm_codes)
        self.builder.add(keys, xids, codes_np, norms_np)
        self.store = None
        rec = np.dtype([("eid", "<u8"), ("code", "u1", (self.config.pq_m,)),
                        ("norm", "u1")])
        buf = np.empty(n, rec)
        buf["eid"] = np.asarray(eids, np.uint64)
        buf["code"] = codes_np
        buf["norm"] = norms_np
        return buf.tobytes()

    def finalize(self) -> None:
        self.store = self.builder.finalize()

    def reseed_builder_from_store(self) -> None:
        """Reload the builder from a finalized/read store so a persisted
        index can keep growing (the reference adds to a loaded index the
        same way: read_index then add_batch,
        test_ivfhnsw_grouping_sift1b_vector_add.cpp:262-274). Per-vector
        centroid keys are reconstructed from the store's list offsets
        (codes are stored sorted by centroid)."""
        store = self._ensure_store()
        counts = np.diff(np.asarray(store.list_offsets, np.int64))
        keys = np.repeat(np.arange(self.nc, dtype=np.int32), counts)
        self.builder.add(keys, np.asarray(store.ids, np.int32),
                         np.asarray(store.codes),
                         np.asarray(store.norm_codes))

    def _ensure_store(self) -> PostingListStore:
        if self.store is None:
            self.finalize()
        return self.store

    def release_device(self) -> None:
        """Free this index's device footprint (the store's array mirrors);
        host state is untouched and everything re-uploads lazily on the
        next device call. Call between stages when one process serves or
        builds multiple large indexes."""
        if self.store is not None:
            self.store.release_device()

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _scan_budget(self, params: SearchParams) -> int:
        """Static padded scan length: budget + the one list allowed to cross
        it (IndexIVF_HNSW.cpp:290-292), rounded for layout friendliness."""
        if params.scan_budget is not None:
            return params.scan_budget
        store = self._ensure_store()
        mx = store.max_list_size()
        if params.max_codes and params.max_codes > 0:
            budget = params.max_codes + mx
        else:
            budget = mx * params.nprobe
        return _round_up(max(budget, 128), 128)

    def _resolve_engine(self, trace: bool) -> str:
        eng = adc_kernel.resolve_engine(self.engine, self.config.pq_m)
        if trace:
            eng = "xla"  # trace outputs only exist on the portable path
        return eng

    def _n_slots(self, params: SearchParams, nprobe: int) -> int:
        """Static kernel slot count per query: the worst case of the
        max_codes budget semantics, capped by ``params.scan_budget`` (padded
        lanes per query, the same unit as the XLA window). Use
        :meth:`scan_slot_demand` to pick a profile-guided cap; slots beyond
        it drop the FARTHEST probes' tails (the schedule walks probes in
        ascending coarse distance), the same approximation class as the
        reference's max_codes truncation."""
        return adc_kernel.n_slots_for(
            params.max_codes or 0, self._ensure_store().max_list_size(),
            nprobe, params.scan_budget)

    def scan_slot_demand(self, queries, params: SearchParams,
                         batch: int = 1024) -> np.ndarray:
        """Per-query scan demand [nq] in padded lanes: the rows of the
        probes the max_codes budget admits, each probe rounded up to whole
        kernel slots. ``params.scan_budget = demand.max()`` then shrinks
        the static window of either engine from the worst-case bound to
        what the workload uses, exactly (no truncation) for every query
        whose demand was <= the profiled max.

        Probes are selected by the SAME coarse path the search under
        ``params`` will take (routed/approx/exact): a profile taken with
        exact probe sets can under-provision an approx/routed run whose
        slightly different probe set hits larger lists."""
        nprobe = min(params.nprobe or self.nprobe, self.nc)
        gran = adc_kernel.BLOCK
        sizes_all = self._ensure_store().list_sizes()
        queries = np.asarray(queries, np.float32)
        routed, rw = self._routed_for(params, nprobe)
        out = np.empty(queries.shape[0], np.int64)
        for off in range(0, queries.shape[0], batch):
            blk = jnp.asarray(queries[off:off + batch])
            if routed is not None and rw > 0:
                from ivfhnsw_tpu.ops.routed_coarse import routed_select_ext
                _, probes, _ = routed_select_ext(
                    blk, *routed, nprobe=nprobe, w=rw)
            else:
                approx = self._coarse_approx(params)
                _, probes = streaming_topk_l2(
                    blk, self.centroids, nprobe, block=self._cb(),
                    point_sqnorms=self.centroid_norms,
                    precision=None if approx is True else ARGMIN_PRECISION,
                    approx=approx is True, recall_target=params.coarse_recall,
                    exact_reduce="binned" if approx == "binned" else "topk")
            sz = sizes_all[np.asarray(probes)]            # [b, nprobe]
            cum_before = np.cumsum(sz, axis=1) - sz
            included = ((params.max_codes or 0) <= 0) | (
                cum_before < (params.max_codes or 0))
            out[off:off + batch] = np.where(
                included, -(-sz // gran), 0).sum(axis=1) * gran
        return out

    def _coarse_approx(self, params: SearchParams):
        """Resolve the coarse probe-selection mode (SearchParams.coarse_mode):
        False = exact lax.top_k (small centroid sets), True = approx_min_k,
        "binned" = the EXACT 3-pass bin-min reduction
        (ops.topk.binned_topk_smallest — bandwidth-bound wide pass, exact
        probe sets). "auto" above 16384 centroids picks approx_min_k; pass
        coarse_mode="binned" or "exact" for exact probe sets."""
        mode = getattr(params, "coarse_mode", "auto")
        if mode == "binned":
            return "binned"
        approx = mode == "approx" or (mode == "auto" and self.nc > 16384)
        if approx and mode == "auto" and not getattr(
                self, "_warned_auto_approx", False):
            self._warned_auto_approx = True
            import sys
            print(f"[ivfhnsw_tpu] coarse_mode=auto selected approx_min_k "
                  f"probe selection (nc={self.nc} > 16384); pass "
                  f"coarse_mode='exact' for exact probe sets",
                  file=sys.stderr)
        return approx

    def _cb(self) -> int:
        """coarse_block default for fixed-width sweep paths (train/assign);
        an explicit user setting always wins."""
        return self.coarse_block if self.coarse_block else 16384

    def _coarse_block_for(self, B: int) -> int:
        """Coarse sweep block size for a batch of B queries. An explicit
        user ``coarse_block`` is a hard ceiling; in auto mode, go as large
        as a ~64 MB [B, block] f32 score block allows — fewer streamed
        top-k merge rounds."""
        if self.coarse_block:
            return min(_round_up(self.nc, 128), self.coarse_block)
        cap = max(4096, ((64 << 20) // max(B, 1)) // 128 * 128)
        return min(_round_up(self.nc, 128), cap)

    def _batch_cap(self, engine: str, params: SearchParams,
                   nprobe: int) -> int:
        """Largest query batch whose scan intermediates stay near
        WINDOW_BYTES. The XLA path holds a gathered [B, L, M] u8 window,
        its int32 widening and a [B, M, L] f32 LUT gather plus ~40 B of
        per-lane ids/positions/bias; the kernel writes [B, slots*BLOCK]
        f32 distances that top-k reads back."""
        if engine == "xla":
            per_query = self._scan_budget(params) * (
                9 * self.config.pq_m + 40)
        else:
            per_query = self._n_slots(params, nprobe) * adc_kernel.BLOCK * 12
        return max(8, WINDOW_BYTES // per_query // 8 * 8)

    def search_step(self, params: SearchParams, batch: int,
                    engine: str | None = None, trace: bool = False):
        """The jitted search step of one ``batch``-query launch as
        ``(fn, args, kwargs)``: ``fn(queries, *args, **kwargs)`` runs it, and
        ``fn.lower(queries, *args, **kwargs)`` compiles it for inspection
        (``memory_analysis``). ``engine`` defaults to the resolved one."""
        store = self._ensure_store()
        nprobe = min(params.nprobe, self.nc)
        engine = engine or self._resolve_engine(trace)
        R = self.opq_R if self.do_opq else jnp.zeros((0, 0), jnp.float32)
        routed, rw = self._routed_for(params, nprobe)
        args = (self.centroids, self.centroid_norms, self.pq.codebooks,
                self.norm_pq.centroids, R, store.codes_d, store.ids_d,
                store.norm_codes_d, store.list_offsets_d,
                jnp.int32(params.max_codes), routed)
        coarse = dict(nprobe=nprobe, k=params.k,
                      coarse_block=self._coarse_block_for(batch),
                      use_opq=self.do_opq,
                      coarse_approx=(not rw) and self._coarse_approx(params),
                      coarse_recall=params.coarse_recall, routed_w=rw)
        if engine == "xla":
            return _search_core, args, dict(
                coarse, L=self._scan_budget(params), trace=trace)
        return adc_kernel.kernel_search_core, args, dict(
            coarse, n_slots=self._n_slots(params, nprobe),
            interpret=engine == "pallas_interpret")

    def _search_batch(self, blk, params: SearchParams, engine: str,
                      trace: bool = False):
        """One device batch through ``engine``; device outputs."""
        fn, args, kw = self.search_step(params, blk.shape[0], engine, trace)
        return fn(blk, *args, **kw)

    def search(self, queries, params: SearchParams | None = None,
               batch: int = 8192, trace: bool = False):
        """Batched query search. Returns (dists [nq, k], labels [nq, k]);
        with trace=True additionally a dict of per-query probe diagnostics
        (the search_debug analog, IndexIVF_HNSW.cpp:328-391). ``batch`` is
        an upper bound: each engine lowers it to what its scan window
        allows (see _batch_cap)."""
        params = params or SearchParams(k=10, nprobe=self.nprobe,
                                        max_codes=self.max_codes)
        self._ensure_store()
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        nprobe = min(params.nprobe, self.nc)
        engine = self._resolve_engine(trace)
        batch = min(batch, self._batch_cap(engine, params, nprobe))

        results = []
        traces = [] if trace else None
        for off in range(0, nq, batch):
            blk = queries[off:off + batch]
            n = blk.shape[0]
            if n < batch and nq > batch:
                blk = np.pad(blk, ((0, batch - n), (0, 0)))
            res = self._search_batch(jnp.asarray(blk), params, engine, trace)
            if trace:
                d, l, tr = res
                traces.append(tuple(np.asarray(t)[:n] for t in tr))
                self.stats["codes_scanned"] += int(np.sum(traces[-1][3]))
            else:
                d, l = res
            results.append((n, d, l))
        # Convert after the whole batch stream is submitted: a per-batch
        # device->host sync would stall the dispatch of the next batch.
        out_d = np.concatenate([np.asarray(d)[:n] for n, d, _ in results])
        out_l = np.concatenate([np.asarray(l)[:n].astype(np.int64)
                                for n, _, l in results])
        self.stats["queries"] += nq
        if trace:
            probes, qc, inc, nsc = (np.concatenate([t[i] for t in traces])
                                    for i in range(4))
            return out_d, out_l, {"probes": probes, "qc_dists": qc,
                                  "included": inc, "n_scanned": nsc}
        return out_d, out_l

    def search_device(self, queries_dev, params: SearchParams):
        """Serving fast path: device-resident queries, [N, d] or pre-shaped
        [G, B, d] (one launch per [B, d] batch). Returns device arrays
        (dists, labels) shaped like the input batching, [..., k]. No host
        transfers — the caller owns staging."""
        engine = self._resolve_engine(False)
        if queries_dev.ndim == 3:
            outs = [self._search_batch(q, params, engine)
                    for q in queries_dev]
            return (jnp.stack([d for d, _ in outs]),
                    jnp.stack([l for _, l in outs]))
        cap = self._batch_cap(engine, params, min(params.nprobe, self.nc))
        outs = [self._search_batch(queries_dev[off:off + cap], params, engine)
                for off in range(0, queries_dev.shape[0], cap)]
        return (jnp.concatenate([d for d, _ in outs]),
                jnp.concatenate([l for _, l in outs]))

    def search_precomputed(self, queries, probes, qc_dists,
                           params: SearchParams):
        """search2 equivalent (IndexIVF_HNSW.h:178): search with externally
        provided (centroid idx, query-centroid distance) probe lists."""
        store = self._ensure_store()
        queries = jnp.asarray(queries, jnp.float32)
        probes = jnp.asarray(probes, jnp.int32)
        qc_dists = jnp.asarray(qc_dists, jnp.float32)
        L = self._scan_budget(params)
        q_rot = (opq_ops.apply_rotation(queries, self.opq_R)
                 if self.do_opq else queries)
        luts = self.pq.ip_luts(q_rot)
        pos, seg, valid, _ = adc_ops.probe_positions(
            probes, store.list_offsets_d, jnp.int32(params.max_codes), L)
        g_codes = jnp.take(store.codes_d, pos, axis=0)
        g_ids = jnp.take(store.ids_d, pos, axis=0)
        g_norm = self.norm_pq.decode(
            jnp.take(store.norm_codes_d, pos, axis=0))
        term1_probe = qc_dists - jnp.take(self.centroid_norms, probes, axis=0)
        bias = jnp.take_along_axis(term1_probe, seg, axis=1) + g_norm
        dists, sel = adc_ops.adc_scan(luts, g_codes, bias, valid, params.k)
        labels = jnp.take_along_axis(g_ids, sel, axis=1)
        return np.asarray(dists), np.asarray(labels)

    def search_per_probe(self, queries, params: SearchParams):
        """search2m equivalent (IndexIVF_HNSW.cpp:503-531): independent top-k
        per probe. Returns (dists [nq, nprobe, k], labels [nq, nprobe, k])."""
        store = self._ensure_store()
        queries = jnp.asarray(queries, jnp.float32)
        nprobe = min(params.nprobe, self.nc)
        qc_dists, probes = streaming_topk_l2(
            queries, self.centroids, nprobe, block=self._cb(),
            point_sqnorms=self.centroid_norms)
        # search2m scans every probe's FULL list (no max_codes budget — the
        # reference's early-exit is commented out, IndexIVF_HNSW.cpp:528-530),
        # so the static window must cover nprobe full lists; the budget-based
        # _scan_budget(params) would under-size it when params.max_codes > 0.
        L = _round_up(max(store.max_list_size() * nprobe, 128), 128)
        q_rot = (opq_ops.apply_rotation(queries, self.opq_R)
                 if self.do_opq else queries)
        luts = self.pq.ip_luts(q_rot)
        pos, seg, valid, _ = adc_ops.probe_positions(
            probes, store.list_offsets_d, jnp.int32(0), L)
        g_codes = jnp.take(store.codes_d, pos, axis=0)
        g_ids = jnp.take(store.ids_d, pos, axis=0)
        g_norm = self.norm_pq.decode(
            jnp.take(store.norm_codes_d, pos, axis=0))
        term1_probe = qc_dists - jnp.take(self.centroid_norms, probes, axis=0)
        bias = jnp.take_along_axis(term1_probe, seg, axis=1) + g_norm
        idx = g_codes.astype(jnp.int32).transpose(0, 2, 1)
        t3 = jnp.sum(jnp.take_along_axis(luts, idx, axis=2), axis=1)
        dist = jnp.where(valid, bias - 2.0 * t3, jnp.inf)
        # Mask per probe slot, top-k within each.
        per = []
        for p in range(nprobe):
            dp = jnp.where(seg == p, dist, jnp.inf)
            d, s = topk_smallest(dp, params.k)
            per.append((d, jnp.take_along_axis(g_ids, s, axis=1)))
        dists = jnp.stack([d for d, _ in per], axis=1)
        labels = jnp.stack([l for _, l in per], axis=1)
        return np.asarray(dists), np.asarray(labels)

    def search_enn(self, x):
        """search_enn equivalent (IndexIVF_HNSW.cpp:393-451): exact-self-match
        smoke test — nprobe=1, k=1 search of stored vectors."""
        p = SearchParams(k=1, nprobe=1, max_codes=0)
        d, l = self.search(x, p)
        return d[:, 0], l[:, 0]

    # ------------------------------------------------------------------
    # Serialization — bit-compatible with the reference .index format
    # (IndexIVF_HNSW.cpp:637-669 write / :757-779 read):
    # [u64 d | u64 nc | nc x lenvec<u32> ids | nc x lenvec<u8> codes |
    #  nc x lenvec<u8> norm_codes | lenvec<f32> centroid_norms]
    # where lenvec<T> = [u32 count | count*T].
    # ------------------------------------------------------------------

    def write(self, path: str, do_trunc: bool = True) -> None:
        store = self._ensure_store()
        off = np.asarray(store.list_offsets).astype(np.int64)
        sizes = off[1:] - off[:-1]
        # Flat payloads are already in centroid-sorted order, so each
        # section serializes as ONE native interleave pass instead of nc
        # write_len_vector calls (write, IndexIVF_HNSW.cpp:637-669).
        with open(path, "wb" if do_trunc else "ab") as f:
            io.write_variable(f, self.d, "<u8")
            io.write_variable(f, self.nc, "<u8")
            io.write_len_series(f, np.asarray(store.ids, "<u4"), sizes)
            io.write_len_series(f, np.asarray(store.codes),
                                sizes * self.code_size)
            io.write_len_series(f, np.asarray(store.norm_codes), sizes)
            io.write_len_vector(f, np.asarray(self.centroid_norms, "<f4"))

    def read(self, path: str) -> None:
        """Parse the whole file buffer in one pass (the reference does 3*nc
        stream reads; at nc=2^20 per-call overhead matters). Uses the native
        series parser when built — the flat payloads are already in
        centroid-sorted order, so the store is assembled without any
        per-list Python loop."""
        buf = io.read_file_u8(path)
        pos = 0

        def take(dtype, count):
            nonlocal pos
            dt = np.dtype(dtype)
            out = buf[pos:pos + dt.itemsize * count].view(dt)
            pos += dt.itemsize * count
            return out

        d = int(take("<u8", 1)[0])
        nc = int(take("<u8", 1)[0])
        if (d, nc) != (self.d, self.nc):
            raise ValueError(f"index file (d={d}, nc={nc}) != config "
                             f"({self.d}, {self.nc})")
        from ivfhnsw_tpu.utils import native
        from ivfhnsw_tpu.models.storage import PostingListStore
        if native.available():
            ids_flat, counts, pos = native.lenvec_series(buf, pos, nc, "<u4")
            codes_flat, ccounts, pos = native.lenvec_series(buf, pos, nc, "u1")
            nrm_flat, _, pos = native.lenvec_series(buf, pos, nc, "u1")
            offsets = np.zeros(nc + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            self.store = PostingListStore(
                codes=codes_flat.reshape(-1, self.config.pq_m),
                ids=ids_flat.astype(np.int32),
                norm_codes=nrm_flat,
                list_offsets=offsets.astype(np.int32),
                nc=nc)
        else:
            def take_lenvec(dtype):
                n = int(take("<u4", 1)[0])
                return take(dtype, n)
            ids = [take_lenvec("<u4").astype(np.int32) for _ in range(nc)]
            codes = [take_lenvec("u1").reshape(-1, self.config.pq_m)
                     for _ in range(nc)]
            ncodes = [take_lenvec("u1") for _ in range(nc)]
            self.store = store_from_lists(
                nc, self.config.pq_m, zip(ids, codes, ncodes))
        self.builder = PostingListBuilder(self.nc, self.config.pq_m)
        if buf.size >= pos + 4:
            n_norms = int(buf[pos:pos + 4].view("<u4")[0])
            pos += 4
            norms = buf[pos:pos + 4 * n_norms].view("<f4")
            if norms.size == nc:
                self.centroid_norms = jnp.asarray(norms.copy())

    def write2(self, home_dir: str, n_vecs: int) -> None:
        """ORCV persistent-index export (write2, IndexIVF_HNSW.cpp:672-755):
        home dir with hdr.vec / cnorms.vec / pq.vec / normpq.vec (+opq.vec
        when OPQ: rotated centroids). The edge.vec graph file has no analog
        (no graph) and is written empty."""
        from ivfhnsw_tpu.utils.orcv import OrcvHeader
        os.makedirs(home_dir, exist_ok=True)
        store = self._ensure_store()
        hdr = OrcvHeader(
            n=n_vecs, nc=self.nc, code_size=self.code_size,
            code_bytes=self.code_size // 8, d=self.d, M=self.config.M,
            efConstruction=self.config.efConstruction,
            do_opq=1 if self.do_opq else 0)
        hdr.write(os.path.join(home_dir, "hdr.vec"))
        with open(os.path.join(home_dir, "cnorms.vec"), "wb") as f:
            io.write_len_vector(f, np.asarray(self.centroid_norms, "<f4"))
        # Vectorized series write (same pattern as write(); the per-centroid
        # write_len_vector loop is O(nc) Python — 2*2^20 calls at canonical
        # geometry). Payloads are already flat+sorted by centroid, so the
        # per-record counts are just the list sizes.
        counts = np.diff(np.asarray(store.list_offsets, np.int64))
        with open(os.path.join(home_dir, "pq.vec"), "wb") as f:
            io.write_len_series(f, np.asarray(store.codes),
                                counts * self.config.pq_m)
        with open(os.path.join(home_dir, "normpq.vec"), "wb") as f:
            io.write_len_series(f, np.asarray(store.norm_codes), counts)
        if self.do_opq:
            with open(os.path.join(home_dir, "opq.vec"), "wb") as f:
                rotated = opq_ops.apply_rotation(self.centroids, self.opq_R)
                io.write_len_vector(f, np.asarray(rotated, "<f4").ravel())
        open(os.path.join(home_dir, "edge.vec"), "wb").close()

    # -- quantizer artifacts ------------------------------------------------

    def save_quantizers(self, path_pq: str, path_norm_pq: str,
                        path_opq: str = "") -> None:
        self.pq.save(path_pq)
        self.norm_pq.save(path_norm_pq)
        if self.do_opq and path_opq:
            opq_ops.save_rotation(path_opq, self.opq_R)

    def load_quantizers(self, path_pq: str, path_norm_pq: str,
                        path_opq: str = "") -> None:
        self.pq = ProductQuantizer.load(path_pq)
        self.norm_pq = NormQuantizer.load(path_norm_pq)
        if self.do_opq and path_opq:
            self.opq_R = opq_ops.load_rotation(path_opq)
