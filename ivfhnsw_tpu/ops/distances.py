"""Batched distance computation in matmul form — the matmul replacement for the
reference's AVX L2 kernels (utils.cpp:22-94, hnswalg.cpp:326-399) and for the
HNSW graph walk itself (hnswalg.cpp:48-109).

Everything is expressed as ``||q - c||^2 = ||q||^2 - 2 q C^T + ||c||^2`` so the
inner product rides the matrix units; top-k over large centroid sets streams centroid
blocks through a running top-k merge instead of materializing [B, nc] scores.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ivfhnsw_tpu.ops.topk import binned_topk_smallest, topk_smallest

# Precision for argmin/assignment sweeps: HIGH (three bf16 passes). A
# single-pass bf16 matmul quantizes near-tie distances, so argmin
# tie-breaks by index and hot lists grow. On an NVIDIA H100, HIGH's
# assignment agreed with HIGHEST (full f32) on 0.99989 of 2^17
# SIFT-statistics vectors at nc=2^15 (chip_smoke.py phase 2 prints this
# every run); HIGH's speed against HIGHEST on the card is not measured.
ARGMIN_PRECISION = jax.lax.Precision.HIGH


def l2sqr_pairwise(x: jax.Array, y: jax.Array, y_sqnorm: jax.Array | None = None,
                   precision=None) -> jax.Array:
    """Squared L2 distances between rows of x [n, d] and y [m, d] -> [n, m].

    ``precision`` may be a jax.lax.Precision or None; pass
    ``jax.lax.Precision.HIGHEST`` for f32-exact results.
    """
    if y_sqnorm is None:
        y_sqnorm = jnp.sum(y.astype(jnp.float32) ** 2, axis=-1)
    x_sqnorm = jnp.sum(x.astype(jnp.float32) ** 2, axis=-1)
    ip = jax.lax.dot_general(
        x, y,
        dimension_numbers=(((x.ndim - 1,), (y.ndim - 1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    return x_sqnorm[:, None] - 2.0 * ip + y_sqnorm[None, :]


def inner_product(x: jax.Array, y: jax.Array, precision=None) -> jax.Array:
    """x [n, d] @ y [m, d]^T -> [n, m] in f32 accumulation."""
    return jax.lax.dot_general(
        x, y,
        dimension_numbers=(((x.ndim - 1,), (y.ndim - 1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )


@functools.partial(jax.jit, static_argnames=("k", "block", "precision",
                                             "approx", "recall_target",
                                             "exact_reduce"))
def streaming_topk_l2(queries: jax.Array, points: jax.Array, k: int,
                      block: int = 65536, precision=None,
                      point_sqnorms: jax.Array | None = None,
                      approx: bool = False, recall_target: float = 0.95,
                      exact_reduce: str = "topk"):
    """k nearest points (squared L2) for each query, streaming `points`
    in blocks of `block` rows with a running top-k merge.

    This is the coarse quantizer primitive: it replaces HNSW searchKnn
    (hnswalg.h:72-101) with an exact, batched matmul sweep. Returns
    (dists [B, k], idxs [B, k]) sorted ascending.

    approx=True swaps each block's exact lax.top_k for
    jax.lax.approx_min_k(recall_target), a bucketed partial reduction on
    backends that implement one (on the GPU and the CPU XLA lowers it to an
    exact sort). The cross-block merge stays exact, and the result stays
    sorted ascending (aggregate_to_topk runs an exact top-k over the
    retained candidates), so downstream max_codes budget semantics are
    unchanged — the analog of the reference's approximate HNSW probe order
    at efSearch=80-220.

    exact_reduce="binned" swaps each block's exact lax.top_k for the
    3-pass binned select (ops.topk.binned_topk_smallest, bin 32): the
    same result modulo equal-distance tie order (the contract every
    top-k in this codebase already carries), but the wide pass is a
    bandwidth-bound bin-min instead of a sort. It falls back to lax.top_k
    internally when kk > width/bin or width % bin != 0.

    `points` is padded internally to a multiple of `block`; padded rows get
    +inf distance.
    """
    B = queries.shape[0]
    n, d = points.shape
    # Never pad the point set past its own (128-rounded) size: a caller
    # passing block=16384 for a 512-point set would otherwise materialize a
    # [B, 16384] score matrix of 97% padding (16 GB at B=256k — a real OOM).
    block = max(128, min(block, -(-n // 128) * 128))
    nblocks = -(-n // block)
    n_pad = nblocks * block
    if point_sqnorms is None:
        point_sqnorms = jnp.sum(points.astype(jnp.float32) ** 2, axis=-1)
    if n_pad != n:
        points = jnp.pad(points, ((0, n_pad - n), (0, 0)))
        point_sqnorms = jnp.pad(point_sqnorms, (0, n_pad - n),
                                constant_values=jnp.inf)
    points = points.reshape(nblocks, block, d)
    point_sqnorms = point_sqnorms.reshape(nblocks, block)

    q_sqnorm = jnp.sum(queries.astype(jnp.float32) ** 2, axis=-1)
    kk = min(k, block)

    def scan_body(carry, xs):
        best_d, best_i = carry
        blk_pts, blk_sq, blk_idx0 = xs
        ip = jax.lax.dot_general(
            queries, blk_pts,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision,
        )
        dists = q_sqnorm[:, None] - 2.0 * ip + blk_sq[None, :]
        if approx and kk < dists.shape[1]:
            blk_d, blk_j = jax.lax.approx_min_k(
                dists, kk, recall_target=recall_target)
        elif exact_reduce == "binned":
            blk_d, blk_j = binned_topk_smallest(dists, kk, bin_size=32)
        else:
            blk_d, blk_j = topk_smallest(dists, kk)
        blk_i = blk_j + blk_idx0
        merged_d = jnp.concatenate([best_d, blk_d], axis=1)
        merged_i = jnp.concatenate([best_i, blk_i], axis=1)
        new_d, sel = topk_smallest(merged_d, k)
        new_i = jnp.take_along_axis(merged_i, sel, axis=1)
        return (new_d, new_i), None

    init = (jnp.full((B, k), jnp.inf, jnp.float32),
            jnp.zeros((B, k), jnp.int32))
    block_starts = jnp.arange(nblocks, dtype=jnp.int32) * block
    (best_d, best_i), _ = jax.lax.scan(
        scan_body, init, (points, point_sqnorms, block_starts))
    return best_d, best_i


def assign_top1(queries: jax.Array, points: jax.Array, block: int = 65536,
                precision=None, point_sqnorms: jax.Array | None = None):
    """Nearest-point id for each query (the reference's `assign`,
    IndexIVF_HNSW.cpp:68-72, minus the graph). Returns (dist [B], idx [B])."""
    d, i = streaming_topk_l2(queries, points, 1, block=block,
                             precision=precision, point_sqnorms=point_sqnorms)
    return d[:, 0], i[:, 0]
