"""Sharded IVFADC search over a device mesh.

Design (SURVEY.md §2.4 / §5 "distributed communication backend"):

- Coarse centroids are partitioned in **contiguous ranges** across the mesh
  (shard s owns global centroids [s*nc_loc, (s+1)*nc_loc)), and each shard
  holds the flat posting-list arrays for its own centroids, padded to the max
  shard size so shapes are uniform.
- A search step under `shard_map`:
    1. queries are replicated; each shard computes an exact local
       top-nprobe over its centroid block (matmul sweep),
    2. `all_gather` of the per-shard candidates + a global top-nprobe merge
       (every shard deterministically computes the same global probe list,
       sorted ascending by distance — the order the max_codes budget
       depends on),
    3. probe list sizes are combined with `psum` (each shard contributes
       sizes for the probes it owns), so the *global* budget semantics are
       identical to the single-chip path,
    4. each shard scans only the included probes it owns (local ADC LUT
       scan, masked static window) and produces a local top-k,
    5. `all_gather` + top-k merge -> identical final (dists, labels) on
       every shard.

The result is bit-identical to `IVFADCIndex.search` (up to f32 reduction
order) — asserted in tests/test_sharded.py.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ivfhnsw_tpu.ops import adc as adc_ops
from ivfhnsw_tpu.ops import adc_kernel
from ivfhnsw_tpu.ops.distances import streaming_topk_l2
from ivfhnsw_tpu.ops.pq import _pq_ip_luts
from ivfhnsw_tpu.ops.topk import topk_smallest
from ivfhnsw_tpu.parallel.mesh import SHARD_AXIS
from ivfhnsw_tpu.utils.config import SearchParams

HIGHEST = jax.lax.Precision.HIGHEST


def _shard_search_fn(nprobe, k, L, nc_loc, coarse_block, use_opq, precision,
                     engine="xla", n_slots=0):
    """Returns the per-shard function run under shard_map.

    engine "xla": the portable gather-based local scan over a static
    L-lane window; "pallas" / "pallas_interpret": the fused scan kernel
    (ops.adc_kernel) over ``n_slots`` slots of the shard's own store —
    compiled for the GPU, or through the Pallas interpreter."""

    def fn(queries, centroids, centroid_norms, codebooks, norm_centroids, R,
           codes, ids, norm_codes, offsets, max_codes):
        # shard_map keeps the sharded leading axis as size 1 — drop it to get
        # the local views: centroids [nc_loc, d], codes [Nmax, M], offsets
        # [nc_loc+1]; queries replicated [B, d].
        centroids = centroids[0]
        centroid_norms = centroid_norms[0]
        codes = codes[0]
        ids = ids[0]
        norm_codes = norm_codes[0]
        offsets = offsets[0]
        B = queries.shape[0]
        sid = jax.lax.axis_index(SHARD_AXIS)
        nshards = jax.lax.axis_size(SHARD_AXIS)

        # 1. Local coarse top-nprobe.
        np_loc = min(nprobe, nc_loc)
        ld, li = streaming_topk_l2(queries, centroids, np_loc,
                                   block=coarse_block,
                                   point_sqnorms=centroid_norms,
                                   precision=precision)
        gi = li + sid * nc_loc

        # 2. Global probe merge (deterministic, replicated result).
        all_d = jax.lax.all_gather(ld, SHARD_AXIS)        # [D, B, np_loc]
        all_i = jax.lax.all_gather(gi, SHARD_AXIS)
        cat_d = jnp.moveaxis(all_d, 0, 1).reshape(B, -1)  # [B, D*np_loc]
        cat_i = jnp.moveaxis(all_i, 0, 1).reshape(B, -1)
        qc_dists, sel = topk_smallest(cat_d, nprobe)      # ascending
        probes = jnp.take_along_axis(cat_i, sel, axis=1)  # global ids [B, P]

        # 3. Global probe sizes via psum of owner contributions.
        own = (probes // nc_loc) == sid                   # [B, P]
        local_probe = jnp.where(own, probes - sid * nc_loc, 0)
        own_sizes = jnp.where(
            own,
            (offsets[local_probe + 1] - offsets[local_probe]).astype(jnp.int32),
            0)
        sizes = jax.lax.psum(own_sizes, SHARD_AXIS)       # [B, P] global

        # Budget semantics identical to single-chip probe_positions.
        cum_before = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32),
             jnp.cumsum(sizes, axis=1)[:, :-1]], axis=1)
        included = jnp.logical_or(max_codes <= 0, cum_before < max_codes)

        # term1 per probe (centroid norms live on the owner; qc_dists are
        # replicated). Use local cnorms for owned probes only.
        own_cn = jnp.where(own, centroid_norms[local_probe], 0.0)
        term1_probe = qc_dists - jax.lax.psum(own_cn, SHARD_AXIS)
        eff = sizes * (included & own)
        q_rot = queries @ R.T if use_opq else queries
        luts = _pq_ip_luts(q_rot, codebooks, precision=precision)

        # 4. Local scan over owned, included probes -> local top-k.
        if engine != "xla":
            start, length, bias = adc_kernel.slot_schedule(
                offsets[local_probe], eff, term1_probe, n_slots=n_slots)
            dists = adc_kernel.adc_block_scan(
                -2.0 * luts, norm_centroids, codes, norm_codes, start,
                length, bias, interpret=engine == "pallas_interpret")
            ldists, llabels = adc_kernel.scan_topk(dists, start, ids, k)
        else:
            bounds = jnp.cumsum(eff, axis=1)
            starts = jnp.concatenate(
                [jnp.zeros((B, 1), jnp.int32), bounds[:, :-1]], axis=1)
            j = jnp.arange(L, dtype=jnp.int32)

            def window_one(bounds_q, starts_q, lp_q):
                seg = jnp.searchsorted(bounds_q, j,
                                       side="right").astype(jnp.int32)
                seg_c = jnp.minimum(seg, nprobe - 1)
                within = j - starts_q[seg_c]
                pos = offsets[lp_q[seg_c]].astype(jnp.int32) + within
                valid = j < bounds_q[-1]
                return jnp.where(valid, pos, 0), seg_c, valid

            pos, seg, valid = jax.vmap(window_one)(bounds, starts,
                                                   local_probe)
            g_codes = jnp.take(codes, pos, axis=0)
            g_ids = jnp.take(ids, pos, axis=0)
            g_norm = jnp.take(
                norm_centroids,
                jnp.take(norm_codes, pos, axis=0).astype(jnp.int32), axis=0)
            bias = jnp.take_along_axis(term1_probe, seg, axis=1) + g_norm
            ldists, lsel = adc_ops.adc_scan(luts, g_codes, bias, valid, k)
            llabels = jnp.take_along_axis(g_ids, lsel, axis=1)
            llabels = jnp.where(jnp.isfinite(ldists), llabels,
                                jnp.int32(-1))

        # 5. Global top-k merge.
        ad = jax.lax.all_gather(ldists, SHARD_AXIS)       # [D, B, k]
        al = jax.lax.all_gather(llabels, SHARD_AXIS)
        md = jnp.moveaxis(ad, 0, 1).reshape(B, -1)
        ml = jnp.moveaxis(al, 0, 1).reshape(B, -1)
        fd, fsel = topk_smallest(md, k)
        fl = jnp.take_along_axis(ml, fsel, axis=1)
        return fd, fl

    return fn


class ShardedIVFADC:
    """Wraps a built (finalized) IVFADCIndex, re-laying its arrays out across
    a 1-D mesh: centroids sharded by contiguous range, each range's posting
    lists local to the owning device."""

    def __init__(self, index, mesh):
        from ivfhnsw_tpu.models.ivfadc import IVFADCIndex  # noqa: F401
        store = index._ensure_store()
        self.mesh = mesh
        self.index = index
        D = mesh.devices.size
        nc = index.nc
        if nc % D != 0:
            raise ValueError(f"nc={nc} must divide evenly over {D} shards "
                             "(pad nc or choose a different mesh)")
        self.nc_loc = nc // D

        cents = np.asarray(index.centroids)
        cnorms = np.asarray(index.centroid_norms)
        off = np.asarray(store.list_offsets).astype(np.int64)
        codes = np.asarray(store.codes)
        ids_arr = np.asarray(store.ids)
        ncodes = np.asarray(store.norm_codes)
        M = codes.shape[1]

        # Per-shard flat arrays, padded to the max shard load.
        lo = off[0::self.nc_loc][:D]
        hi = np.concatenate([lo[1:], [off[-1]]])
        loads = hi - lo
        nmax = int(loads.max()) if D > 0 else 0
        nmax = max(nmax, 1)
        s_codes = np.zeros((D, nmax, M), np.uint8)
        s_ids = np.full((D, nmax), -1, np.int32)
        s_ncodes = np.zeros((D, nmax), np.uint8)
        s_off = np.zeros((D, self.nc_loc + 1), np.int32)
        for s in range(D):
            n = int(loads[s])
            s_codes[s, :n] = codes[lo[s]:hi[s]]
            s_ids[s, :n] = ids_arr[lo[s]:hi[s]]
            s_ncodes[s, :n] = ncodes[lo[s]:hi[s]]
            s_off[s] = (off[s * self.nc_loc:(s + 1) * self.nc_loc + 1]
                        - lo[s]).astype(np.int32)

        shard = NamedSharding(mesh, P(SHARD_AXIS))
        repl = NamedSharding(mesh, P())
        self.centroids = jax.device_put(
            cents.reshape(D, self.nc_loc, -1), shard)
        self.centroid_norms = jax.device_put(
            cnorms.reshape(D, self.nc_loc), shard)
        self.codes = jax.device_put(s_codes, shard)
        self.ids = jax.device_put(s_ids, shard)
        self.norm_codes = jax.device_put(s_ncodes, shard)
        self.offsets = jax.device_put(s_off, shard)
        self.codebooks = jax.device_put(np.asarray(index.pq.codebooks), repl)
        self.norm_centroids = jax.device_put(
            np.asarray(index.norm_pq.centroids), repl)
        self.R = jax.device_put(
            np.asarray(index.opq_R) if index.do_opq else
            np.zeros((0, 0), np.float32), repl)
        self.max_list_size = store.max_list_size()
        self._jitted = {}

    def _get_step(self, nprobe, k, L, engine, n_slots):
        key = (nprobe, k, L, engine, n_slots)
        if key not in self._jitted:
            fn = _shard_search_fn(
                nprobe, k, L, self.nc_loc,
                coarse_block=min(16384, self.nc_loc),
                use_opq=self.index.do_opq, precision=HIGHEST,
                engine=engine, n_slots=n_slots)
            spec = P(SHARD_AXIS)
            repl = P()
            mapped = jax.shard_map(
                fn, mesh=self.mesh,
                in_specs=(repl, spec, spec, repl, repl, repl,
                          spec, spec, spec, spec, repl),
                out_specs=(repl, repl),
                check_vma=False)
            self._jitted[key] = jax.jit(mapped)
        return self._jitted[key]

    def search(self, queries, params: SearchParams, engine: str = "auto"):
        """engine: resolved like IVFADCIndex.engine
        (ops.adc_kernel.resolve_engine) — 'auto' is the scan kernel on the
        GPU and the XLA path elsewhere."""
        engine = adc_kernel.resolve_engine(engine, self.index.config.pq_m)
        queries = jnp.asarray(np.asarray(queries, np.float32))
        nprobe = min(params.nprobe, self.index.nc)
        if engine != "xla":
            L = 0
            n_slots = adc_kernel.n_slots_for(
                params.max_codes or 0, self.max_list_size, nprobe,
                params.scan_budget)
        else:
            n_slots = 0
            if params.scan_budget is not None:
                L = params.scan_budget
            elif params.max_codes and params.max_codes > 0:
                L = -(-(params.max_codes + self.max_list_size) // 128) * 128
            else:
                L = -(-(self.max_list_size * nprobe) // 128) * 128
        step = self._get_step(nprobe, params.k, L, engine, n_slots)
        d, l = step(queries, self.centroids, self.centroid_norms,
                    self.codebooks, self.norm_centroids, self.R,
                    self.codes, self.ids, self.norm_codes, self.offsets,
                    jnp.int32(params.max_codes))
        return np.asarray(d), np.asarray(l)
