"""ADC posting-list scan, XLA version.

This is the dense re-architecture of the reference's hot loop 2
(IndexIVF_HNSW.cpp:268-293): instead of walking std::vector posting lists with
a max-heap, we

1. turn the per-query probe set into a *static-length* flat gather index
   (:func:`probe_positions`) that reproduces the reference's `max_codes`
   budget semantics — probes are consumed in ascending centroid-distance
   order and scanning stops after the list that crosses the budget
   (IndexIVF_HNSW.cpp:290-292); the fixed tail is masked, and

2. evaluate the ADC decomposition ``d = term1 + ||y||^2 - 2<q, y_R>``
   (documented at IndexIVF_HNSW.cpp:206-233) as a batched LUT gather +
   top-k (:func:`adc_scan`).

On the GPU a fused Pallas kernel (ivfhnsw_tpu.ops.adc_kernel) replaces
step 2; this XLA version is the portable reference implementation and the
correctness oracle. Both engines select probes with :func:`select_probes`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ivfhnsw_tpu.ops.distances import streaming_topk_l2
from ivfhnsw_tpu.ops.topk import topk_smallest


def select_probes(queries, centroids, centroid_norms, *, nprobe: int,
                  coarse_block: int, coarse_approx=False,
                  coarse_recall: float = 0.95, routed=None,
                  routed_w: int = 0,
                  precision=jax.lax.Precision.HIGHEST):
    """Coarse probe selection, shared by both search engines so they scan
    the same lists: (qc_dists, probes, term1), each [B, nprobe], ascending
    by query-centroid distance (the order the max_codes budget walks).

    term1 = ||q - c||^2 - ||c||^2 (IndexIVF_HNSW.cpp:277). coarse_approx
    is tri-state: False = exact lax.top_k, True = approx_min_k, "binned" =
    the exact 3-pass bin-min reduction. ``routed`` (with routed_w > 0)
    selects probes through ops.routed_coarse instead."""
    if routed is not None and routed_w > 0:
        from ivfhnsw_tpu.ops.routed_coarse import routed_select_ext
        qc, probes, term1 = routed_select_ext(queries, *routed,
                                              nprobe=nprobe, w=routed_w)
        return qc, probes, term1
    qc, probes = streaming_topk_l2(
        queries, centroids, nprobe, block=coarse_block,
        point_sqnorms=centroid_norms, precision=precision,
        approx=coarse_approx is True, recall_target=coarse_recall,
        exact_reduce="binned" if coarse_approx == "binned" else "topk")
    return qc, probes, qc - jnp.take(centroid_norms, probes, axis=0)


@functools.partial(jax.jit, static_argnames=("L",))
def probe_positions(probes: jax.Array, list_offsets: jax.Array,
                    max_codes: jax.Array, L: int):
    """Flatten per-query probe lists into fixed-length gather indices.

    probes: [B, nprobe] centroid ids sorted by ascending query-centroid
    distance. list_offsets: [nc + 1] int32/int64 prefix sums of list sizes.
    max_codes: scalar scan budget (0 = unlimited).

    Returns (pos [B, L] int32 — indices into the flat code arrays,
             seg [B, L] int32 — which probe slot each position belongs to,
             valid [B, L] bool,
             included [B, nprobe] bool — which probes made the budget).
    """
    nprobe = probes.shape[1]

    def per_query(p):
        sizes = (list_offsets[p + 1] - list_offsets[p]).astype(jnp.int32)
        cum_before = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(sizes)[:-1]])
        unlimited = max_codes <= 0
        included = jnp.logical_or(unlimited, cum_before < max_codes)
        eff = sizes * included
        bounds = jnp.cumsum(eff)                       # [nprobe]
        starts = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), bounds[:-1]])
        j = jnp.arange(L, dtype=jnp.int32)
        seg = jnp.searchsorted(bounds, j, side="right").astype(jnp.int32)
        seg_c = jnp.minimum(seg, nprobe - 1)
        within = j - starts[seg_c]
        pos = (list_offsets[p[seg_c]].astype(jnp.int32) + within)
        valid = j < bounds[-1]
        pos = jnp.where(valid, pos, 0)
        return pos, seg_c, valid, included

    return jax.vmap(per_query)(probes)


@functools.partial(jax.jit, static_argnames=("k", "precision"))
def adc_scan(luts: jax.Array, codes: jax.Array, bias: jax.Array,
             valid: jax.Array, k: int, precision=None):
    """ADC distance evaluation + top-k over a gathered scan window.

    luts:  [B, M, ksub] f32 per-query inner-product tables.
    codes: [B, L, M] uint8 gathered PQ codes.
    bias:  [B, L] f32 — precombined term1 + decoded norm (everything except
           the -2<q, y_R> LUT term).
    valid: [B, L] bool mask.

    Returns (dists [B, k] ascending, positions [B, k] int32 into the scan
    window).
    """
    idx = codes.astype(jnp.int32).transpose(0, 2, 1)          # [B, M, L]
    t3 = jnp.take_along_axis(luts, idx, axis=2)               # [B, M, L]
    t3 = jnp.sum(t3, axis=1)                                  # [B, L]
    dist = bias - 2.0 * t3
    dist = jnp.where(valid, dist, jnp.inf)
    return topk_smallest(dist, k)
