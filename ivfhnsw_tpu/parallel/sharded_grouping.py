"""Mesh-sharded Grouping(+Pruning) search.

Groups (coarse centroids) are partitioned in contiguous ranges like
ShardedIVFADC; per-group state (neighbor ids, alphas, inter-centroid
distances, subgroup offsets) lives with the owner. The centroid table is
replicated (neighbor-centroid distances reference arbitrary rows), but each
shard still computes only its own coarse block.

Collectives per query batch:
  1. all-gather of per-shard coarse top-nprobe -> identical global probe
     list everywhere (ascending distance);
  2. psum of owner-computed group/effective sizes -> global max_codes budget
     bookkeeping identical to single-chip;
  3. psum of qsd sums/counts -> the global pruning threshold (the mean over
     all scanned slots, IndexIVF_HNSW_Grouping.cpp:261) is exact, not
     per-shard;
  4. all-gather + top-k merge of per-shard results.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ivfhnsw_tpu.ops import adc as adc_ops
from ivfhnsw_tpu.ops.distances import streaming_topk_l2
from ivfhnsw_tpu.ops.topk import topk_smallest
from ivfhnsw_tpu.parallel.mesh import SHARD_AXIS
from ivfhnsw_tpu.utils.config import SearchParams

HIGHEST = jax.lax.Precision.HIGHEST


def _shard_grouping_fn(nprobe, k, L, nsubc, nc_loc, coarse_block, use_opq,
                       do_pruning, precision):
    """Per-shard grouping search (portable gather-based local scan)."""

    def fn(queries, all_centroids, all_cnorms, codebooks, norm_centroids, R,
           codes, ids, norm_codes, sub_offsets, nn_idxs, alphas, inter_dists,
           max_codes):
        # Strip shard_map's size-1 leading axis from sharded operands.
        codes, ids, norm_codes = codes[0], ids[0], norm_codes[0]
        sub_offsets = sub_offsets[0]
        nn_idxs, alphas, inter_dists = nn_idxs[0], alphas[0], inter_dists[0]

        B = queries.shape[0]
        sid = jax.lax.axis_index(SHARD_AXIS)

        # 1. Coarse: local block of the replicated table, global merge.
        lo = sid * nc_loc
        local_cents = jax.lax.dynamic_slice_in_dim(all_centroids, lo, nc_loc)
        local_norms = jax.lax.dynamic_slice_in_dim(all_cnorms, lo, nc_loc)
        ld, li = streaming_topk_l2(queries, local_cents,
                                   min(nprobe, nc_loc), block=coarse_block,
                                   point_sqnorms=local_norms,
                                   precision=precision)
        all_d = jax.lax.all_gather(ld, SHARD_AXIS)
        all_i = jax.lax.all_gather(li + lo, SHARD_AXIS)
        cat_d = jnp.moveaxis(all_d, 0, 1).reshape(B, -1)
        cat_i = jnp.moveaxis(all_i, 0, 1).reshape(B, -1)
        qc_dists, sel = topk_smallest(cat_d, nprobe)
        probes = jnp.take_along_axis(cat_i, sel, axis=1)      # global ids

        own = (probes // nc_loc) == sid
        lp = jnp.where(own, probes - lo, 0)                   # local probe id

        # 2. Per-owned-probe grouping terms.
        p_nn = nn_idxs[lp]                                    # [B, P, S] global
        q_sq = jnp.sum(queries ** 2, axis=1)

        def nn_dist_one(nn_p):
            cn = all_centroids[nn_p]
            ip = jnp.einsum("bsd,bd->bs", cn, queries, precision=precision,
                            preferred_element_type=jnp.float32)
            return q_sq[:, None] - 2.0 * ip + all_cnorms[nn_p]

        qn = jnp.moveaxis(jax.lax.map(nn_dist_one,
                                      jnp.moveaxis(p_nn, 1, 0)), 0, 1)

        a = alphas[lp]
        one_m_a = (1.0 - a)[:, :, None]
        a_b = a[:, :, None]
        slot0 = lp * nsubc
        slot_ids = slot0[:, :, None] + jnp.arange(nsubc)[None, None, :]
        all_sizes = sub_offsets[1:] - sub_offsets[:-1]
        ssz = jnp.where(own[:, :, None],
                        all_sizes[slot_ids].astype(jnp.int32), 0)
        nonempty = ssz > 0

        qsd = (one_m_a * qc_dists[:, :, None] + a_b * qn
               - a_b * one_m_a * inter_dists[lp])
        g_sizes = jax.lax.psum(jnp.sum(ssz, axis=2), SHARD_AXIS)  # global
        if do_pruning:
            g_cum_before = jnp.concatenate(
                [jnp.zeros((B, 1), jnp.int32),
                 jnp.cumsum(g_sizes, axis=1)[:, :-1]], axis=1)
            thr_probe = jnp.logical_or(max_codes <= 0,
                                       g_cum_before < 2 * max_codes)
            thr_mask = nonempty & thr_probe[:, :, None]
            part_sum = jnp.sum(jnp.where(thr_mask, qsd, 0.0), axis=(1, 2))
            part_cnt = jnp.sum(thr_mask, axis=(1, 2))
            tot_sum = jax.lax.psum(part_sum, SHARD_AXIS)
            tot_cnt = jnp.maximum(jax.lax.psum(part_cnt, SHARD_AXIS), 1)
            threshold = tot_sum / tot_cnt
            scan_slot = nonempty & (qsd < threshold[:, None, None])
        else:
            scan_slot = nonempty

        # 3. Budget: probe-granular over global effective sizes.
        eff_local = jnp.where(scan_slot, ssz, 0)
        probe_eff = jax.lax.psum(jnp.sum(eff_local, axis=2), SHARD_AXIS)
        cum_before = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32),
             jnp.cumsum(probe_eff, axis=1)[:, :-1]], axis=1)
        probe_inc = jnp.logical_or(max_codes <= 0, cum_before < max_codes)
        final_sizes = (eff_local * probe_inc[:, :, None]).reshape(B, -1)

        slot_flat = jnp.where(own[:, :, None],
                              slot_ids, 0).reshape(B, -1)
        bounds = jnp.cumsum(final_sizes, axis=1)
        starts = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), bounds[:, :-1]], axis=1)
        j = jnp.arange(L, dtype=jnp.int32)

        def window_one(bounds_q, starts_q, slots_q):
            seg = jnp.searchsorted(bounds_q, j,
                                   side="right").astype(jnp.int32)
            seg_c = jnp.minimum(seg, slots_q.shape[0] - 1)
            within = j - starts_q[seg_c]
            pos = sub_offsets[slots_q[seg_c]].astype(jnp.int32) + within
            valid = j < bounds_q[-1]
            return jnp.where(valid, pos, 0), seg_c, valid

        pos, seg, valid = jax.vmap(window_one)(bounds, starts, slot_flat)

        term1 = one_m_a * (qc_dists - all_cnorms[probes])[:, :, None]
        term2 = a_b * (qn - all_cnorms[p_nn])
        slot_bias = (term1 + term2).reshape(B, -1)

        q_rot = queries @ R.T if use_opq else queries
        from ivfhnsw_tpu.ops.pq import _pq_ip_luts
        luts = _pq_ip_luts(q_rot, codebooks, precision=precision)

        g_codes = jnp.take(codes, pos, axis=0)
        g_ids = jnp.take(ids, pos, axis=0)
        g_norm = jnp.take(norm_centroids,
                          jnp.take(norm_codes, pos, axis=0).astype(jnp.int32),
                          axis=0)
        bias = jnp.take_along_axis(slot_bias, seg, axis=1) + g_norm

        ldists, lsel = adc_ops.adc_scan(luts, g_codes, bias, valid, k)
        llabels = jnp.take_along_axis(g_ids, lsel, axis=1)
        llabels = jnp.where(jnp.isfinite(ldists), llabels, jnp.int32(-1))

        ad = jax.lax.all_gather(ldists, SHARD_AXIS)
        al = jax.lax.all_gather(llabels, SHARD_AXIS)
        fd, fsel = topk_smallest(jnp.moveaxis(ad, 0, 1).reshape(B, -1), k)
        fl = jnp.take_along_axis(jnp.moveaxis(al, 0, 1).reshape(B, -1),
                                 fsel, axis=1)
        return fd, fl

    return fn


class ShardedGrouping:
    """Wraps a built IVFADCGroupingIndex across a 1-D mesh."""

    def __init__(self, index, mesh):
        store = index._ensure_store()
        self.mesh = mesh
        self.index = index
        D = mesh.devices.size
        nc, nsubc = index.nc, index.nsubc
        if nc % D != 0:
            raise ValueError(f"nc={nc} must divide evenly over {D} shards")
        self.nc_loc = nc // D
        self.nsubc = nsubc

        off = np.asarray(store.list_offsets).astype(np.int64)
        codes = np.asarray(store.codes)
        ids_arr = np.asarray(store.ids)
        ncodes = np.asarray(store.norm_codes)
        M = codes.shape[1]

        per_shard_lists = self.nc_loc * nsubc
        lo = off[0::per_shard_lists][:D]
        hi = np.concatenate([lo[1:], [off[-1]]])
        loads = hi - lo
        nmax = max(int(loads.max()), 1)
        s_codes = np.zeros((D, nmax, M), np.uint8)
        s_ids = np.full((D, nmax), -1, np.int32)
        s_ncodes = np.zeros((D, nmax), np.uint8)
        s_off = np.zeros((D, per_shard_lists + 1), np.int32)
        for s in range(D):
            n = int(loads[s])
            s_codes[s, :n] = codes[lo[s]:hi[s]]
            s_ids[s, :n] = ids_arr[lo[s]:hi[s]]
            s_ncodes[s, :n] = ncodes[lo[s]:hi[s]]
            s_off[s] = (off[s * per_shard_lists:(s + 1) * per_shard_lists + 1]
                        - lo[s]).astype(np.int32)

        shard = NamedSharding(mesh, P(SHARD_AXIS))
        repl = NamedSharding(mesh, P())
        self.codes = jax.device_put(s_codes, shard)
        self.ids = jax.device_put(s_ids, shard)
        self.norm_codes = jax.device_put(s_ncodes, shard)
        self.sub_offsets = jax.device_put(s_off, shard)
        self.nn_idxs = jax.device_put(
            np.asarray(index.nn_centroid_idxs).reshape(D, self.nc_loc, nsubc),
            shard)
        self.alphas = jax.device_put(
            np.asarray(index.alphas).reshape(D, self.nc_loc), shard)
        self.inter_dists = jax.device_put(
            np.asarray(index.inter_centroid_dists)
            .reshape(D, self.nc_loc, nsubc), shard)
        self.centroids = jax.device_put(np.asarray(index.centroids), repl)
        self.cnorms = jax.device_put(np.asarray(index.centroid_norms), repl)
        self.codebooks = jax.device_put(np.asarray(index.pq.codebooks), repl)
        self.norm_centroids = jax.device_put(
            np.asarray(index.norm_pq.centroids), repl)
        self.R = jax.device_put(
            np.asarray(index.opq_R) if index.do_opq else
            np.zeros((0, 0), np.float32), repl)

        off2 = np.asarray(store.list_offsets)
        gsz = (off2[1:] - off2[:-1]).reshape(nc, nsubc).sum(1)
        self.max_group = int(gsz.max()) if gsz.size else 0
        self._jitted = {}

    def _get_step(self, nprobe, k, L, do_pruning):
        key = (nprobe, k, L, do_pruning)
        if key not in self._jitted:
            fn = _shard_grouping_fn(
                nprobe, k, L, self.nsubc, self.nc_loc,
                coarse_block=min(16384, self.nc_loc),
                use_opq=self.index.do_opq, do_pruning=do_pruning,
                precision=HIGHEST)
            spec = P(SHARD_AXIS)
            repl = P()
            mapped = jax.shard_map(
                fn, mesh=self.mesh,
                in_specs=(repl, repl, repl, repl, repl, repl,
                          spec, spec, spec, spec, spec, spec, spec, repl),
                out_specs=(repl, repl),
                check_vma=False)
            self._jitted[key] = jax.jit(mapped)
        return self._jitted[key]

    def search(self, queries, params: SearchParams, engine: str = "auto"):
        """engine: 'auto' or 'xla' — the grouping index has no scan kernel,
        and naming one raises instead of falling back."""
        if engine not in ("auto", "xla"):
            raise ValueError(f"engine {engine!r}: the grouping index has no "
                             "scan kernel; use 'auto' or 'xla'")
        queries = jnp.asarray(np.asarray(queries, np.float32))
        nprobe = min(params.nprobe, self.index.nc)
        if params.scan_budget is not None:
            L = params.scan_budget
        elif params.max_codes and params.max_codes > 0:
            L = -(-(params.max_codes + self.max_group) // 128) * 128
        else:
            L = -(-(self.max_group * nprobe) // 128) * 128
        step = self._get_step(nprobe, params.k, L, params.do_pruning)
        d, l = step(queries, self.centroids, self.cnorms, self.codebooks,
                    self.norm_centroids, self.R, self.codes, self.ids,
                    self.norm_codes, self.sub_offsets, self.nn_idxs,
                    self.alphas, self.inter_dists,
                    jnp.int32(params.max_codes))
        return np.asarray(d), np.asarray(l)
