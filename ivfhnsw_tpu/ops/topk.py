"""Top-k helpers: smallest-k selection and pairwise merge.

These replace the reference's faiss max-heap usage (maxheap_heapify/push at
IndexIVF_HNSW.cpp:265,282-289) with `lax.top_k` — the heap is a CPU idiom;
on an accelerator a full-block sort/select is the fast path and composes
with blockwise streaming merges.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def topk_smallest(x: jax.Array, k: int):
    """k smallest entries along the last axis, ascending. If k exceeds the
    axis size, the result is padded with +inf values (index 0).
    Returns (values, indices)."""
    n = x.shape[-1]
    if k > n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, k - n)]
        x = jnp.pad(x, pad, constant_values=jnp.inf)
    neg, idx = jax.lax.top_k(-x, k)
    return -neg, jnp.minimum(idx, n - 1)


def binned_topk_smallest(x: jax.Array, k: int, bin_size: int = 32):
    """EXACT k smallest along the last axis, in three cheap passes.

    ``lax.top_k`` over a wide axis is sort-bound (linear in width); the
    scan output this feeds on is 100k+ lanes at canonical geometry.
    Instead:

      1. min-reduce bins of ``bin_size`` lanes (bandwidth-bound pass),
      2. exact top-k over the n/bin_size bin minima,
      3. gather those k bins' full contents and top-k over k*bin_size lanes.

    Exactness: a bin holding any of the true k smallest values has
    bin-min <= d_k, and at most k bins can satisfy that (each such bin
    contains one of the k smallest), so the k bins chosen in (2) cover all
    candidates. Ties at d_k may resolve to different (equal-distance)
    labels than the one-shot sort — same contract as the reference's
    epsilon-tie rerank comparator (utils.cpp:193-202).

    Returns (values, indices) like :func:`topk_smallest`.
    """
    n = x.shape[-1]
    nb = n // bin_size
    if k > nb or n % bin_size:
        return topk_smallest(x, k)
    xb = x.reshape(x.shape[:-1] + (nb, bin_size))
    bmin = xb.min(axis=-1)
    _, bsel = jax.lax.top_k(-bmin, k)                    # [..., k] bins
    cand = jnp.take_along_axis(xb, bsel[..., None], axis=-2)
    cand = cand.reshape(x.shape[:-1] + (k * bin_size,))
    best, csel = topk_smallest(cand, k)
    idx = (jnp.take_along_axis(bsel, csel // bin_size, axis=-1) * bin_size
           + csel % bin_size)
    return best, idx


def merge_topk(d_a: jax.Array, i_a: jax.Array, d_b: jax.Array, i_b: jax.Array,
               k: int):
    """Merge two (dists, ids) top-k sets along the last axis into one."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    best_d, sel = topk_smallest(d, k)
    best_i = jnp.take_along_axis(i, sel, axis=-1)
    return best_d, best_i
