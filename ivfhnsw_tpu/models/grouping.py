"""IVFADC + Grouping (+Pruning) — the JAX equivalent of
`ivfhnsw::IndexIVF_HNSW_Grouping` (/root/reference/IndexIVF_HNSW_Grouping.*).

The grouping scheme splits each coarse centroid's posting list across
``nsubc`` sub-centroids lying on segments toward the centroid's nsubc nearest
neighbor centroids, ``s_j = c + alpha * (n_j - c)`` with one learned alpha per
group (add_group, IndexIVF_HNSW_Grouping.cpp:43-157). Search uses the 4-term
decomposition documented at :159-187:

    d = (1-a)(||q-c||^2 - ||c||^2) + a(||q-n||^2 - ||n||^2)
        + ||y||^2 - 2<q, y_R>

and Pruning skips sub-lists whose estimated query-subcentroid distance

    qsd = (1-a)||q-c||^2 + a||q-n||^2 - a(1-a)||c-n||^2      (:251-252)

exceeds the mean over scanned slots (:261).

Re-architecture for dense batched compute:
- nearest-neighbor centroids / inter-centroid distances: one batched
  matmul top-(nsubc+1) over the centroid set (replaces per-group searchKnn).
- alpha learning (compute_alpha, :691-728): a *two-pass streamed* reduction —
  pass 1 accumulates the per-point argmin (numerator, denominator) pairs into
  per-group sums with segment_sum; pass 2 encodes with the final group
  alphas. Identical math to the reference's per-group loop, but batched over
  arbitrary point batches instead of requiring each group's points to be
  gathered contiguously.
- search: masked batched compute — the pruning test is a boolean mask on
  (probe, subc) slots; the scan window is built over nc*nsubc flattened
  subgroup lists with the same max_codes probe-granular budget semantics
  (:302-308, :350-353).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ivfhnsw_tpu.ops import adc as adc_ops
from ivfhnsw_tpu.ops import opq as opq_ops
from ivfhnsw_tpu.ops.distances import streaming_topk_l2
from ivfhnsw_tpu.models.ivfadc import IVFADCIndex, _round_up
from ivfhnsw_tpu.models.storage import PostingListBuilder, store_from_lists
from ivfhnsw_tpu.utils import io
from ivfhnsw_tpu.utils.config import IndexConfig, SearchParams
from ivfhnsw_tpu.utils.recall import rerank_order

HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("precision",))
def _alpha_stats(x, keys, centroids, nn_idxs, nn_dists, precision=HIGHEST):
    """Pass-1 alpha statistics (compute_alpha, IndexIVF_HNSW_Grouping.cpp:
    691-728): per point, over the nsubc candidate directions, pick the one
    whose per-point-optimal subcentroid is closest to the point, and return
    segment sums of its (clamped numerator, denominator) per group.

    x [B, d]; keys [B] centroid ids; nn_idxs [nc, nsubc]; nn_dists [nc, nsubc]
    (= ||n - c||^2). Returns (num_sums [nc], den_sums [nc]).
    """
    nc = centroids.shape[0]
    c = centroids[keys]                                   # [B, d]
    nn = centroids[nn_idxs[keys]]                         # [B, S, d]
    cv = nn - c[:, None, :]                               # [B, S, d]
    v = x - c                                             # [B, d]
    num = jnp.einsum("bsd,bd->bs", cv, v, precision=precision,
                     preferred_element_type=jnp.float32)
    num = jnp.maximum(num, 0.0)
    den = nn_dists[keys]                                  # [B, S]
    alpha_j = num / jnp.maximum(den, 1e-30)
    s = c[:, None, :] + alpha_j[:, :, None] * cv          # [B, S, d]
    dist = jnp.sum((x[:, None, :] - s) ** 2, axis=-1)     # [B, S]
    j_star = jnp.argmin(dist, axis=1)                     # [B]
    num_star = jnp.take_along_axis(num, j_star[:, None], 1)[:, 0]
    den_star = jnp.take_along_axis(den, j_star[:, None], 1)[:, 0]
    num_sums = jax.ops.segment_sum(num_star, keys, num_segments=nc)
    den_sums = jax.ops.segment_sum(den_star, keys, num_segments=nc)
    return num_sums, den_sums


@functools.partial(jax.jit, static_argnames=("precision",))
def _subcentroid_assign(x, keys, centroids, nn_idxs, alphas,
                        precision=HIGHEST):
    """Pass-2: with final group alphas, compute each point's subcentroid index
    and the subcentroid itself (compute_subcentroid_idxs, :673-689).

    Returns (subc_idx [B] int32, subcentroid [B, d] f32).
    """
    c = centroids[keys]
    nn = centroids[nn_idxs[keys]]
    cv = nn - c[:, None, :]
    a = alphas[keys][:, None, None]
    s = c[:, None, :] + a * cv                            # [B, S, d]
    dist = jnp.sum((x[:, None, :] - s) ** 2, axis=-1)
    j = jnp.argmin(dist, axis=1).astype(jnp.int32)
    s_star = jnp.take_along_axis(s, j[:, None, None], axis=1)[:, 0, :]
    return j, s_star


@functools.partial(
    jax.jit,
    static_argnames=("nprobe", "k", "L", "nsubc", "coarse_block", "use_opq",
                     "do_pruning", "trace", "precision"))
def _grouping_search_core(queries, centroids, centroid_norms, codebooks,
                          norm_centroids, R, codes, ids, norm_codes,
                          sub_offsets, nn_idxs, alphas, inter_dists,
                          group_sizes, max_codes, *, nprobe: int, k: int,
                          L: int, nsubc: int, coarse_block: int,
                          use_opq: bool, do_pruning: bool,
                          trace: bool = False, precision=HIGHEST):
    """Jitted Grouping(+Pruning) search (IndexIVF_HNSW_Grouping.cpp:188-363).

    sub_offsets: [nc*nsubc + 1] offsets into the flat arrays, subgroup lists
    stored in (centroid, subc) order — the same layout add_group flattens to
    (:133-156).
    """
    B = queries.shape[0]

    # Coarse top-nprobe (ascending distance; rotation-invariant so computed
    # in the original space even under OPQ).
    qc_dists, probes = streaming_topk_l2(
        queries, centroids, nprobe, block=coarse_block,
        point_sqnorms=centroid_norms, precision=precision)

    # Per-(probe, subc) neighbor-centroid distances ||q - n||^2, computed
    # probe-by-probe to bound the gather working set. This replaces the
    # reference's query_centroid_dists lazy cache (:244-250, :310-316).
    p_nn = nn_idxs[probes]                                # [B, P, S]
    q_sq = jnp.sum(queries ** 2, axis=1)                  # [B]

    def nn_dist_one_probe(nn_p):
        # nn_p: [B, S] centroid ids for this probe slot.
        cn = centroids[nn_p]                              # [B, S, d]
        ip = jnp.einsum("bsd,bd->bs", cn, queries, precision=precision,
                        preferred_element_type=jnp.float32)
        return q_sq[:, None] - 2.0 * ip + centroid_norms[nn_p]

    qn_dists = jax.lax.map(nn_dist_one_probe,
                           jnp.moveaxis(p_nn, 1, 0))      # [P, B, S]
    qn_dists = jnp.moveaxis(qn_dists, 0, 1)               # [B, P, S]

    a = alphas[probes]                                    # [B, P]
    sub_sizes_all = sub_offsets[1:] - sub_offsets[:-1]    # [nc*nsubc]
    slot_ids = probes[:, :, None] * nsubc + jnp.arange(nsubc)[None, None, :]
    slot_sizes = sub_sizes_all[slot_ids].astype(jnp.int32)  # [B, P, S]
    nonempty = slot_sizes > 0

    # qsd estimate + pruning threshold (:222-262). The reference computes the
    # threshold over probes until cumulative *group* sizes reach 2*max_codes.
    i_dists = inter_dists[probes]                         # [B, P, S]
    one_m_a = (1.0 - a)[:, :, None]
    a_b = a[:, :, None]
    qsd = (one_m_a * qc_dists[:, :, None]
           + a_b * qn_dists - a_b * one_m_a * i_dists)    # [B, P, S]
    if do_pruning:
        g_sizes = group_sizes[probes].astype(jnp.int32)   # [B, P]
        g_cum_before = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(g_sizes, axis=1)[:, :-1]],
            axis=1)
        thr_probe = jnp.logical_or(max_codes <= 0,
                                   g_cum_before < 2 * max_codes)  # [B, P]
        thr_mask = nonempty & thr_probe[:, :, None]
        n_slots = jnp.maximum(jnp.sum(thr_mask, axis=(1, 2)), 1)
        threshold = (jnp.sum(jnp.where(thr_mask, qsd, 0.0), axis=(1, 2))
                     / n_slots)                            # [B]
        scan_slot = nonempty & (qsd < threshold[:, None, None])
    else:
        scan_slot = nonempty

    # Probe-granular max_codes budget over *effective* (unpruned) sizes
    # (:350-353: ncode counts scanned subgroups; break happens after a probe).
    eff_sizes = jnp.where(scan_slot, slot_sizes, 0)       # [B, P, S]
    probe_eff = jnp.sum(eff_sizes, axis=2)                # [B, P]
    cum_before = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(probe_eff, axis=1)[:, :-1]],
        axis=1)
    probe_inc = jnp.logical_or(max_codes <= 0, cum_before < max_codes)
    final_sizes = (eff_sizes * probe_inc[:, :, None]).reshape(B, -1)  # [B, P*S]

    # Flatten slots -> static scan window.
    slot_flat = slot_ids.reshape(B, -1)                   # [B, P*S]
    bounds = jnp.cumsum(final_sizes, axis=1)              # [B, P*S]
    starts = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), bounds[:, :-1]], axis=1)
    j = jnp.arange(L, dtype=jnp.int32)

    def window_one(bounds_q, starts_q, slots_q):
        seg = jnp.searchsorted(bounds_q, j, side="right").astype(jnp.int32)
        seg_c = jnp.minimum(seg, slots_q.shape[0] - 1)
        within = j - starts_q[seg_c]
        pos = sub_offsets[slots_q[seg_c]].astype(jnp.int32) + within
        valid = j < bounds_q[-1]
        return jnp.where(valid, pos, 0), seg_c, valid

    pos, seg, valid = jax.vmap(window_one)(bounds, starts, slot_flat)

    # Slot-level term1+term2: (1-a)(qc - ||c||^2) + a(qn - ||n||^2)  (:290,:318)
    term1 = one_m_a * (qc_dists - centroid_norms[probes])[:, :, None]
    term2 = a_b * (qn_dists - centroid_norms[p_nn])
    slot_bias = (term1 + term2).reshape(B, -1)            # [B, P*S]

    q_rot = queries @ R.T if use_opq else queries
    from ivfhnsw_tpu.ops.pq import _pq_ip_luts
    luts = _pq_ip_luts(q_rot, codebooks, precision=precision)

    g_codes = jnp.take(codes, pos, axis=0)
    g_ids = jnp.take(ids, pos, axis=0)
    g_norm = jnp.take(norm_centroids,
                      jnp.take(norm_codes, pos, axis=0).astype(jnp.int32),
                      axis=0)
    bias = jnp.take_along_axis(slot_bias, seg, axis=1) + g_norm

    dists, sel = adc_ops.adc_scan(luts, g_codes, bias, valid, k)
    labels = jnp.take_along_axis(g_ids, sel, axis=1)
    labels = jnp.where(jnp.isfinite(dists), labels, -1)
    if trace:
        return dists, labels, (probes, qc_dists, probe_inc,
                               jnp.sum(valid, axis=1))
    return dists, labels


class IVFADCGroupingIndex(IVFADCIndex):
    """Grouping variant: per-group subcentroids + alpha + pruning."""

    def __init__(self, config: IndexConfig):
        if config.nsubc <= 0:
            raise ValueError("grouping index requires nsubc > 0")
        super().__init__(config)
        self.nsubc = config.nsubc
        # Per-group state (IndexIVF_HNSW_Grouping.h:19-22,61):
        self.nn_centroid_idxs: Optional[jnp.ndarray] = None   # [nc, nsubc] i32
        self.inter_centroid_dists: Optional[jnp.ndarray] = None  # [nc, nsubc]
        self.alphas: Optional[jnp.ndarray] = None             # [nc] f32
        self._alpha_num = np.zeros(config.nc, np.float64)
        self._alpha_den = np.zeros(config.nc, np.float64)
        self.do_pruning = False
        # Builder over flattened (centroid, subc) lists.
        self.builder = PostingListBuilder(config.nc * config.nsubc,
                                          config.pq_m)

    def enable_routed_coarse(self, *args, **kwargs):
        """Unsupported here: the grouping search selects probes exactly, so
        building the routed structure would be minutes of wasted k-means.
        Fail before that work, not after."""
        raise NotImplementedError(
            "routed coarse selection is not wired into the grouping "
            "search; use coarse_mode='exact'")

    # ------------------------------------------------------------------
    # Neighbor-centroid structure
    # ------------------------------------------------------------------

    def compute_neighbor_centroids(self, precision=None) -> None:
        """Top-nsubc nearest centroids per centroid (the per-group
        searchKnn(centroid, nsubc+1) at IndexIVF_HNSW_Grouping.cpp:48), as
        one batched sweep. Also fills inter_centroid_dists (:620-631) since
        they are exactly the neighbor distances.

        ``precision`` defaults to HIGHEST (f32-exact); pass
        jax.lax.Precision.HIGH (ops.distances.ARGMIN_PRECISION) to trade
        f32 exactness for speed on large sweeps."""
        if precision is None:
            precision = HIGHEST
        nn_d = np.empty((self.nc, self.nsubc), np.float32)
        nn_i = np.empty((self.nc, self.nsubc), np.int32)
        batch = max(1, 262144 // max(1, self.nsubc))
        cents = np.asarray(self.centroids)
        for off in range(0, self.nc, batch):
            blk = jnp.asarray(cents[off:off + batch])
            d_, i_ = streaming_topk_l2(blk, self.centroids, self.nsubc + 1,
                                       block=self._cb(),
                                       point_sqnorms=self.centroid_norms,
                                       precision=precision)
            d_, i_ = np.asarray(d_), np.asarray(i_)
            # Drop self-matches robustly: remove the column equal to the row
            # id (falls back to dropping the nearest if absent).
            rows = np.arange(off, off + blk.shape[0])[:, None]
            for r in range(blk.shape[0]):
                mask = i_[r] != rows[r, 0]
                keep = np.nonzero(mask)[0][:self.nsubc]
                nn_d[off + r] = d_[r, keep]
                nn_i[off + r] = i_[r, keep]
        self.nn_centroid_idxs = jnp.asarray(nn_i)
        self.inter_centroid_dists = jnp.asarray(nn_d)

    def compute_inter_centroid_dists(self) -> None:
        """Reference parity method (:620-631); in this architecture the
        distances come out of the same sweep as the neighbor ids."""
        if self.nn_centroid_idxs is None:
            self.compute_neighbor_centroids()
        cents = np.asarray(self.centroids)
        nn = np.asarray(self.nn_centroid_idxs)
        out = np.empty((self.nc, self.nsubc), np.float32)
        batch = 65536
        for off in range(0, self.nc, batch):
            c = cents[off:off + batch]
            n = cents[nn[off:off + batch]]
            out[off:off + batch] = ((n - c[:, None, :]) ** 2).sum(-1)
        self.inter_centroid_dists = jnp.asarray(out)

    def dump_inter_centroid_dists(self, path: str) -> None:
        """:633-653 — text dump of centroid-to-neighbor distances."""
        icd = np.asarray(self.inter_centroid_dists)
        with open(path, "w") as f:
            for i in range(self.nc):
                for subc in range(self.nsubc):
                    f.write(f"distance of centriod {i} to centriod {subc} "
                            f"is {icd[i, subc]:f}\n")

    # ------------------------------------------------------------------
    # Alpha learning + adding (two-pass streaming)
    # ------------------------------------------------------------------

    def _require_neighbors(self):
        if self.nn_centroid_idxs is None:
            self.compute_neighbor_centroids()

    def alpha_pass(self, x, precomputed_idx=None, batch: int = 16384) -> None:
        """Pass 1: accumulate per-group alpha numerators/denominators over a
        batch of base vectors (streamable; call for every batch before any
        add_batch)."""
        self._require_neighbors()
        x = np.asarray(x, np.float32)
        keys = (np.asarray(precomputed_idx, np.int32)
                if precomputed_idx is not None else self.assign(x))
        for off in range(0, x.shape[0], batch):
            num, den = _alpha_stats(
                jnp.asarray(x[off:off + batch]),
                jnp.asarray(keys[off:off + batch]),
                self.centroids, self.nn_centroid_idxs,
                self.inter_centroid_dists)
            self._alpha_num += np.asarray(num, np.float64)
            self._alpha_den += np.asarray(den, np.float64)

    def finalize_alphas(self) -> None:
        """alpha = group_numerator / group_denominator (:727)."""
        den = self._alpha_den
        self.alphas = jnp.asarray(
            np.where(den > 0, self._alpha_num / np.maximum(den, 1e-30), 0.0)
            .astype(np.float32))

    def add_batch(self, x, xids=None, precomputed_idx=None,
                  batch: int = 16384) -> None:
        """Pass 2 of add_group (:90-156): subcentroid assignment with final
        alphas, residual vs subcentroid, PQ, norm codes; bucketed by
        (centroid, subc)."""
        if self.alphas is None:
            raise RuntimeError("call alpha_pass(...) on all data then "
                               "finalize_alphas() before add_batch")
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        keys = (np.asarray(precomputed_idx, np.int32)
                if precomputed_idx is not None else self.assign(x))
        if xids is None:
            xids = np.arange(self.builder.ntotal,
                             self.builder.ntotal + n, dtype=np.int32)
        xids = np.asarray(xids, np.int32)
        for off in range(0, n, batch):
            xb = jnp.asarray(x[off:off + batch])
            kb = jnp.asarray(keys[off:off + batch])
            subc, s_star = _subcentroid_assign(
                xb, kb, self.centroids, self.nn_centroid_idxs, self.alphas)
            residuals = xb - s_star
            if self.do_opq:
                residuals = opq_ops.apply_rotation(residuals, self.opq_R)
            codes = self.pq.encode(residuals)
            decoded = self.pq.decode(codes)
            if self.do_opq:
                decoded = opq_ops.apply_rotation_transpose(decoded, self.opq_R)
            recon = decoded + s_star
            norms = jnp.sum(recon ** 2, axis=1)
            norm_codes = self.norm_pq.encode(norms)
            flat_keys = (np.asarray(kb) * self.nsubc
                         + np.asarray(subc)).astype(np.int32)
            self.builder.add(flat_keys, xids[off:off + batch],
                             np.asarray(codes), np.asarray(norm_codes))
        self.store = None

    def add(self, x, xids=None, precomputed_idx=None) -> None:
        """Convenience: both passes for an in-memory dataset."""
        keys = (np.asarray(precomputed_idx, np.int32)
                if precomputed_idx is not None else self.assign(x))
        self.alpha_pass(x, keys)
        self.finalize_alphas()
        self.add_batch(x, xids, keys)

    # ------------------------------------------------------------------
    # Device-resident build (the tens-of-millions streamed-build path:
    # vectors never cross host<->device — only keys/codes/norm codes,
    # ~21 B/vector, reach the host builder. Mirrors
    # IVFADCIndex.add_batch_device; a 33M-vector grouping build would
    # otherwise move ~17 GB of f32 vectors to the host per pass.)
    # ------------------------------------------------------------------

    def assign_batch_device(self, x_dev) -> np.ndarray:
        """Nearest-centroid keys for a device batch (routed assigner when
        enabled + gated, exact sweep otherwise). Returned as host int32 so
        both passes of the streamed build can reuse one assignment."""
        if getattr(self, "_fast_assigner", None) is not None:
            return np.asarray(self._fast_assigner.assign_device(x_dev),
                              np.int32)
        return self._assign_device_exact(x_dev)

    def alpha_pass_device(self, x_dev, keys, batch: int = 32768) -> None:
        """Pass 1 on a device-resident batch: identical accumulation to
        alpha_pass (compute_alpha, IndexIVF_HNSW_Grouping.cpp:691-728)
        without the host round-trip of x. Sub-batched so the [b, nsubc, d]
        intermediates stay ~1 GB."""
        self._require_neighbors()
        keys_dev = jnp.asarray(np.asarray(keys, np.int32))
        n = int(x_dev.shape[0])
        for off in range(0, n, batch):
            num, den = _alpha_stats(
                x_dev[off:off + batch], keys_dev[off:off + batch],
                self.centroids, self.nn_centroid_idxs,
                self.inter_centroid_dists)
            self._alpha_num += np.asarray(num, np.float64)
            self._alpha_den += np.asarray(den, np.float64)

    def add_batch_device(self, x_dev, xids=None, precomputed_idx=None,
                         batch: int = 32768) -> None:
        """Pass 2 on a device-resident batch: subcentroid assignment with
        final alphas + residual-vs-subcentroid encode, all on device
        (add_group encode pipeline, IndexIVF_HNSW_Grouping.cpp:90-156)."""
        if self.alphas is None:
            raise RuntimeError("call alpha_pass(...) on all data then "
                               "finalize_alphas() before add_batch_device")
        n = int(x_dev.shape[0])
        keys = (np.asarray(precomputed_idx, np.int32)
                if precomputed_idx is not None
                else self.assign_batch_device(x_dev))
        if xids is None:
            xids = np.arange(self.builder.ntotal,
                             self.builder.ntotal + n, dtype=np.int32)
        xids = np.asarray(xids, np.int32)
        keys_dev = jnp.asarray(keys)
        for off in range(0, n, batch):
            xb = x_dev[off:off + batch]
            kb = keys_dev[off:off + batch]
            subc, s_star = _subcentroid_assign(
                xb, kb, self.centroids, self.nn_centroid_idxs, self.alphas)
            residuals = xb - s_star
            if self.do_opq:
                residuals = opq_ops.apply_rotation(residuals, self.opq_R)
            codes = self.pq.encode(residuals)
            decoded = self.pq.decode(codes)
            if self.do_opq:
                decoded = opq_ops.apply_rotation_transpose(decoded,
                                                           self.opq_R)
            recon = decoded + s_star
            norms = jnp.sum(recon ** 2, axis=1)
            norm_codes = self.norm_pq.encode(norms)
            flat_keys = (keys[off:off + batch].astype(np.int64)
                         * self.nsubc
                         + np.asarray(subc)).astype(np.int32)
            self.builder.add(flat_keys, xids[off:off + batch],
                             np.asarray(codes), np.asarray(norm_codes))
        self.store = None

    # ------------------------------------------------------------------
    # PQ training (train_pq, IndexIVF_HNSW_Grouping.cpp:486-618)
    # ------------------------------------------------------------------

    def train_pq(self, key, train_data, precomputed_idx=None,
                 pq_niter: int = 25, opq_niter: int = 20,
                 verbose: bool = False) -> None:
        """Group the train set by centroid, learn train-set alphas, then PQ on
        subcentroid residuals and norm-PQ on reconstructions. The reference
        uses OPQ niter=100 here (:557-563); our alternation converges in far
        fewer outer iterations because each step retrains all M subspaces."""
        self._require_neighbors()
        x = np.asarray(train_data, np.float32)
        keys = (np.asarray(precomputed_idx, np.int32)
                if precomputed_idx is not None else self.assign(x))
        # Train-set alphas (same two-pass math, local accumulators).
        num, den = _alpha_stats(jnp.asarray(x), jnp.asarray(keys),
                                self.centroids, self.nn_centroid_idxs,
                                self.inter_centroid_dists)
        num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
        train_alphas = jnp.asarray(
            np.where(den > 0, num / np.maximum(den, 1e-30), 0.0)
            .astype(np.float32))
        subc, s_star = _subcentroid_assign(
            jnp.asarray(x), jnp.asarray(keys), self.centroids,
            self.nn_centroid_idxs, train_alphas)
        residuals = jnp.asarray(x) - s_star
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
        decoded = self.pq.decode(self.pq.encode(rotated))
        if self.do_opq:
            decoded = opq_ops.apply_rotation_transpose(decoded, self.opq_R)
        recon = decoded + s_star
        self.norm_pq.train(k_norm, jnp.sum(recon ** 2, axis=1))

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _group_sizes(self) -> jnp.ndarray:
        store = self._ensure_store()
        sizes = np.asarray(store.list_offsets)
        sub_sizes = (sizes[1:] - sizes[:-1]).reshape(self.nc, self.nsubc)
        return jnp.asarray(sub_sizes.sum(axis=1).astype(np.int32))

    def _scan_budget(self, params: SearchParams) -> int:
        if params.scan_budget is not None:
            return params.scan_budget
        store = self._ensure_store()
        off = np.asarray(store.list_offsets)
        group_sizes = (off[1:] - off[:-1]).reshape(self.nc, self.nsubc).sum(1)
        mx = int(group_sizes.max()) if group_sizes.size else 0
        if params.max_codes and params.max_codes > 0:
            budget = params.max_codes + mx
        else:
            budget = int(np.sort(group_sizes)[-min(params.nprobe,
                                                   self.nc):].sum())
        return _round_up(max(budget, 128), 128)

    def scan_slot_demand(self, queries, params: SearchParams,
                         batch: int = 1024) -> np.ndarray:
        """Per-query scan demand [nq] in lanes of the XLA window — the
        profile-guided analog of IVFADCIndex.scan_slot_demand. Safe upper
        bound: under pruning (where the budget gate counts effective
        post-prune sizes) every probed group counts in full, so the
        profiled max never truncates; without pruning the budget gate on
        full group sizes is exact."""
        from ivfhnsw_tpu.ops.distances import ARGMIN_PRECISION
        nprobe = min(params.nprobe or self.nprobe, self.nc)
        gsizes = np.asarray(self._group_sizes()).astype(np.int64)
        queries = np.asarray(queries, np.float32)
        out = np.empty(queries.shape[0], np.int64)
        budgeted = (params.max_codes or 0) > 0 and not params.do_pruning
        for off in range(0, queries.shape[0], batch):
            blk = jnp.asarray(queries[off:off + batch])
            _, probes = streaming_topk_l2(
                blk, self.centroids, nprobe, block=self._cb(),
                point_sqnorms=self.centroid_norms,
                precision=ARGMIN_PRECISION)
            sz = gsizes[np.asarray(probes)]                # [b, nprobe]
            if budgeted:
                cum_before = np.cumsum(sz, axis=1) - sz
                sz = np.where(cum_before < params.max_codes, sz, 0)
            out[off:off + batch] = sz.sum(axis=1)
        return out

    def _resolve_engine(self, trace: bool) -> str:
        """The grouping index has one engine, the XLA path; naming a kernel
        engine is an error rather than a silent fallback."""
        if self.engine not in ("auto", "xla"):
            raise ValueError(f"engine {self.engine!r}: the grouping index "
                             "has no scan kernel; use 'auto' or 'xla'")
        return "xla"

    def _batch_cap(self, engine: str, params: SearchParams,
                   nprobe: int) -> int:
        # The 4-term window carries one more gathered f32 (slot bias) per
        # lane than the IVFADC window, plus [B, P, nsubc] prep tensors.
        from ivfhnsw_tpu.models.ivfadc import WINDOW_BYTES
        per_query = (self._scan_budget(params) * (9 * self.config.pq_m + 48)
                     + nprobe * self.nsubc * 64)
        return max(8, WINDOW_BYTES // per_query // 8 * 8)

    def search_step(self, params: SearchParams, batch: int,
                    engine: str | None = None, trace: bool = False):
        """The grouping search step as ``(fn, args, kwargs)`` (see
        IVFADCIndex.search_step); the XLA path is the only engine."""
        store = self._ensure_store()
        args = (self.centroids, self.centroid_norms, self.pq.codebooks,
                self.norm_pq.centroids,
                self.opq_R if self.do_opq else jnp.zeros((0, 0), jnp.float32),
                store.codes_d, store.ids_d, store.norm_codes_d,
                store.list_offsets_d, self.nn_centroid_idxs, self.alphas,
                self.inter_centroid_dists, self._group_sizes(),
                jnp.int32(params.max_codes))
        return _grouping_search_core, args, dict(
            nprobe=min(params.nprobe, self.nc), k=params.k,
            L=self._scan_budget(params), nsubc=self.nsubc,
            coarse_block=min(self._cb(), _round_up(self.nc, 128)),
            use_opq=self.do_opq, do_pruning=params.do_pruning, trace=trace)

    def search(self, queries, params: SearchParams | None = None,
               batch: int = 4096, trace: bool = False):
        params = params or SearchParams(k=10, nprobe=self.nprobe,
                                        max_codes=self.max_codes,
                                        do_pruning=self.do_pruning)
        if getattr(params, "coarse_mode", "auto") == "routed":
            # Probes are selected exactly here; a silent exact fallback
            # would waste the routed structure build. Fail loudly instead.
            raise NotImplementedError(
                "coarse_mode='routed' is not wired into the grouping "
                "search; use 'exact'")
        return super().search(queries, params, batch=batch, trace=trace)

    def search_disk(self, queries, params: SearchParams, base_file: io.XvecFile):
        """searchDisk (:365-395): ANN search for 2k candidates, exact L2
        rerank against the raw base file, distance-then-label tiebreak."""
        p2 = SearchParams(k=2 * params.k, nprobe=params.nprobe,
                          max_codes=params.max_codes,
                          do_pruning=params.do_pruning,
                          scan_budget=params.scan_budget)
        _, cand = self.search(queries, p2)
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        out_d = np.empty((nq, params.k), np.float32)
        out_l = np.empty((nq, params.k), np.int64)
        for i in range(nq):
            labels = cand[i]
            ok = labels >= 0
            vecs = base_file.gather(labels[ok])
            exact = ((vecs - queries[i][None]) ** 2).sum(1)
            dd, ll = rerank_order(exact, labels[ok])
            # Fewer than k finite candidates (tiny lists / heavy pruning):
            # pad with (+inf, -1) like the ANN paths do.
            if dd.shape[0] < params.k:
                pad = params.k - dd.shape[0]
                dd = np.concatenate([dd, np.full(pad, np.inf, dd.dtype)])
                ll = np.concatenate([ll, np.full(pad, -1, ll.dtype)])
            out_d[i] = dd[:params.k]
            out_l[i] = ll[:params.k]
        return out_d, out_l

    # ------------------------------------------------------------------
    # Serialization — reference Grouping format
    # (IndexIVF_HNSW_Grouping.cpp:397-483): u64 d, nc, nsubc; per-centroid
    # lenvec ids/codes/norm_codes (subgroup-concatenated); per-centroid
    # lenvec nn_centroid_idxs (u32) and subgroup_sizes (u32); lenvec alphas;
    # lenvec centroid_norms; per-centroid lenvec inter_centroid_dists.
    # ------------------------------------------------------------------

    def write(self, path: str, do_trunc: bool = True) -> None:
        store = self._ensure_store()
        off = np.asarray(store.list_offsets).astype(np.int64)
        sub_sizes = (off[1:] - off[:-1]).reshape(self.nc, self.nsubc)
        gsizes = sub_sizes.sum(axis=1)
        # Subgroups are contiguous within each group in the flat store, so
        # the per-GROUP concatenated payloads the format wants
        # (IndexIVF_HNSW_Grouping.cpp:397-446) are just the flat arrays
        # re-counted by group — each ragged section is one native
        # interleave pass, and the fixed-width sections (nn idxs,
        # subgroup_sizes, inter-centroid dists) are single 2-D reshapes.
        with open(path, "wb" if do_trunc else "ab") as f:
            io.write_variable(f, self.d, "<u8")
            io.write_variable(f, self.nc, "<u8")
            io.write_variable(f, self.nsubc, "<u8")
            io.write_len_series(f, np.asarray(store.ids, "<u4"), gsizes)
            io.write_len_series(f, np.asarray(store.codes),
                                gsizes * self.code_size)
            io.write_len_series(f, np.asarray(store.norm_codes), gsizes)
            io.write_len_rows(f, np.asarray(self.nn_centroid_idxs, "<u4"))
            io.write_len_rows(f, sub_sizes.astype("<u4"))
            io.write_len_vector(f, np.asarray(self.alphas, "<f4"))
            io.write_len_vector(f, np.asarray(self.centroid_norms, "<f4"))
            io.write_len_rows(f, np.asarray(self.inter_centroid_dists,
                                            "<f4"))

    def read(self, path: str) -> None:
        buf = io.read_file_u8(path)
        pos = 0

        def take(dtype, count):
            nonlocal pos
            dt = np.dtype(dtype)
            out = buf[pos:pos + dt.itemsize * count].view(dt)
            pos += dt.itemsize * count
            return out

        def take_lenvec(dtype):
            n = int(take("<u4", 1)[0])
            return take(dtype, n)

        d = int(take("<u8", 1)[0])
        nc = int(take("<u8", 1)[0])
        nsubc = int(take("<u8", 1)[0])
        if (d, nc, nsubc) != (self.d, self.nc, self.nsubc):
            raise ValueError("grouping index file params mismatch")
        from ivfhnsw_tpu.utils import native
        from ivfhnsw_tpu.models.storage import PostingListStore
        if native.available():
            # Ragged sections in one native pass each; group-concatenated
            # payload order IS the flat store order (subgroups contiguous
            # within groups), so no per-list splitting is needed — the
            # nc*nsubc list_offsets come from the subgroup_sizes cumsum.
            ids_flat, _, pos = native.lenvec_series(buf, pos, nc, "<u4")
            codes_flat, _, pos = native.lenvec_series(buf, pos, nc, "u1")
            nrm_flat, _, pos = native.lenvec_series(buf, pos, nc, "u1")
        else:
            ids_l = [take_lenvec("<u4") for _ in range(nc)]
            codes_l = [take_lenvec("u1") for _ in range(nc)]
            nrm_l = [take_lenvec("u1") for _ in range(nc)]
            ids_flat = np.concatenate(ids_l) if ids_l else np.empty(0, "<u4")
            codes_flat = (np.concatenate(codes_l) if codes_l
                          else np.empty(0, "u1"))
            nrm_flat = (np.concatenate(nrm_l) if nrm_l
                        else np.empty(0, "u1"))
        nn, pos = io.read_len_rows(buf, pos, nc, nsubc, "<u4")
        sub_sizes, pos = io.read_len_rows(buf, pos, nc, nsubc, "<u4")
        self.alphas = jnp.asarray(take_lenvec("<f4").copy())
        cnorms = take_lenvec("<f4")
        if cnorms.size == nc:
            self.centroid_norms = jnp.asarray(cnorms.copy())
        icd, pos = io.read_len_rows(buf, pos, nc, nsubc, "<f4")
        self.nn_centroid_idxs = jnp.asarray(nn.astype(np.int32))
        self.inter_centroid_dists = jnp.asarray(icd)
        offsets = np.zeros(nc * nsubc + 1, np.int64)
        np.cumsum(sub_sizes.astype(np.int64).reshape(-1), out=offsets[1:])
        self.store = PostingListStore(
            codes=codes_flat.reshape(-1, self.config.pq_m),
            ids=ids_flat.astype(np.int32),
            norm_codes=nrm_flat,
            list_offsets=offsets.astype(np.int32),
            nc=nc * nsubc)
        self.builder = PostingListBuilder(nc * nsubc, self.config.pq_m)
