"""Batched Lloyd's k-means in matmul form.

This is the trainer the reference *outsources*: coarse centroids are an input
file produced by an external k-means tool (README.md:56,62; Parser.h:54), and
PQ codebooks come from faiss's ProductQuantizer::train. Here both are
first-class:

- :func:`kmeans` — streaming Lloyd's for large k (coarse centroids, up to
  2^20): data and centroids are both processed in blocks so nothing [n, k]
  ever materializes.
- :func:`kmeans_batched` — vmapped small-k variant for PQ subspace codebooks
  (M independent (n, dsub) -> 256 problems in one call) and the 1-D norm
  quantizer.

Empty clusters are relocated next to the largest cluster's centroid with a
small deterministic offset (faiss-style splitting): in the following Lloyd
iteration the big cluster's points divide between the original and relocated
centroids, escaping merged-cluster minima.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ivfhnsw_tpu.ops.distances import (ARGMIN_PRECISION, assign_top1,
                                        l2sqr_pairwise)


@functools.partial(jax.jit, static_argnames=("k", "precision"))
def kmeanspp_init(key, data, k: int, precision=ARGMIN_PRECISION):
    """k-means++ seeding on data [n, d] (D^2-weighted sampling). O(n*k) —
    callers subsample for very large n."""
    n, d = data.shape
    data = data.astype(jnp.float32)
    k0, k1 = jax.random.split(key)
    first = data[jax.random.randint(k0, (), 0, n)]
    mind = jnp.sum((data - first[None]) ** 2, axis=1)
    keys = jax.random.split(k1, k)

    def body(i, carry):
        cents, mind = carry
        idx = jax.random.categorical(keys[i], jnp.log(mind + 1e-30))
        c = data[idx]
        cents = cents.at[i].set(c)
        mind = jnp.minimum(mind, jnp.sum((data - c[None]) ** 2, axis=1))
        return cents, mind

    cents = jnp.zeros((k, d), jnp.float32).at[0].set(first)
    cents, _ = jax.lax.fori_loop(1, k, body, (cents, mind))
    return cents


def hierarchical_seed(key, data, k: int, block_c: int = 16384,
                      precision=ARGMIN_PRECISION) -> np.ndarray:
    """Two-level ++-style seeding for very large k (coarse centroids at
    2^17-2^20, where the sequential k-step ++ loop is impractical).

    1. Learn k_sup = ~k/256 super-centroids (++ init + a few Lloyd rounds on
       a subsample).
    2. Assign a large subsample to the super-centroids and draw each
       super-cluster's proportional quota of seeds uniformly from its own
       members (largest-remainder rounding to hit exactly k).

    Proportional allocation reproduces D^2-ish coverage at cluster
    granularity: dense regions get many seeds, so no seed starts responsible
    for a huge slab of points — the failure mode of flat random init.
    Returns seeds [k, d] float32 (numpy).
    """
    data = np.asarray(data, np.float32)
    n = data.shape[0]
    k_sup = int(np.clip(k // 256, 1, 8192))
    k_seed, k_sub, k_draw = jax.random.split(key, 3)
    rng = np.random.RandomState(
        int(jax.random.randint(k_draw, (), 0, 2**31 - 1)))

    sub_n = min(n, max(32 * k_sup, 16384))
    sub = data[rng.permutation(n)[:sub_n]]
    sup = kmeanspp_init(k_seed, jnp.asarray(sub), k_sup, precision=precision)
    for _ in range(4):
        _, idx = assign_top1(jnp.asarray(sub), sup, block=block_c,
                             precision=precision)
        sums = jax.ops.segment_sum(jnp.asarray(sub), idx, num_segments=k_sup)
        counts = jax.ops.segment_sum(jnp.ones((sub_n,), jnp.float32), idx,
                                     num_segments=k_sup)
        sup = _update_with_split(sums, counts, sup)

    # Assign a seed pool >= 8x k so every quota can usually be met.
    pool_n = min(n, max(8 * k, sub_n))
    pool_idx = rng.permutation(n)[:pool_n]
    pool = data[pool_idx]
    members = np.empty(pool_n, np.int32)
    step = 1 << 18
    for off in range(0, pool_n, step):
        _, ii = assign_top1(jnp.asarray(pool[off:off + step]), sup,
                            block=block_c, precision=precision)
        members[off:off + step] = np.asarray(ii)
    counts = np.bincount(members, minlength=k_sup).astype(np.int64)

    # Largest-remainder proportional quotas, capped by availability.
    exact = k * counts / max(counts.sum(), 1)
    quota = np.floor(exact).astype(np.int64)
    rem = k - int(quota.sum())
    if rem > 0:
        order = np.argsort(-(exact - quota))
        quota[order[:rem]] += 1
    quota = np.minimum(quota, counts)
    # Redistribute any shortfall (tiny clusters) to clusters with headroom.
    short = k - int(quota.sum())
    if short > 0:
        head = counts - quota
        order = np.argsort(-head)
        for s in order:
            take = min(short, int(head[s]))
            quota[s] += take
            short -= take
            if short == 0:
                break
    if short > 0:  # pool smaller than k: top up with random data points
        quota_total = int(quota.sum())
        extra = data[rng.permutation(n)[:short]]
    else:
        quota_total, extra = int(quota.sum()), None

    order = np.argsort(members, kind="stable")
    starts = np.zeros(k_sup + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    seeds = np.empty((k, data.shape[1]), np.float32)
    w = 0
    for s in range(k_sup):
        q = int(quota[s])
        if q == 0:
            continue
        mem = order[starts[s]:starts[s + 1]]
        pick = mem if q == counts[s] else rng.choice(mem, q, replace=False)
        seeds[w:w + q] = pool[pick]
        w += q
    if extra is not None:
        seeds[w:] = extra
    return seeds


@functools.partial(jax.jit, static_argnames=("k", "block_c", "precision"))
def _stream_iter(data_blocks, valid, centroids, k: int, block_c: int,
                 precision=ARGMIN_PRECISION):
    """One Lloyd iteration over pre-blocked data [nb, bs, d] with a validity
    mask [nb, bs]. Returns (sums [k, d], counts [k], sse)."""

    def body(carry, xs):
        sums, counts, sse = carry
        blk, msk = xs
        dist, idx = assign_top1(blk, centroids, block=block_c,
                                precision=precision)
        w = msk.astype(jnp.float32)
        sums = sums + jax.ops.segment_sum(blk * w[:, None], idx,
                                          num_segments=k)
        counts = counts + jax.ops.segment_sum(w, idx, num_segments=k)
        sse = sse + jnp.sum(dist * w)
        return (sums, counts, sse), None

    init = (jnp.zeros((k, data_blocks.shape[-1]), jnp.float32),
            jnp.zeros((k,), jnp.float32), jnp.float32(0.0))
    (sums, counts, sse), _ = jax.lax.scan(body, init, (data_blocks, valid))
    return sums, counts, sse


def kmeans(key, data, k: int, niter: int = 25, block_c: int = 16384,
           block_n: int = 131072, precision=ARGMIN_PRECISION, verbose: bool = False):
    """Streaming Lloyd's k-means. data: [n, d] (numpy or jax). Returns
    (centroids [k, d] f32, final mean squared error)."""
    data = np.asarray(data, dtype=np.float32)
    n, d = data.shape
    if n < k:
        raise ValueError(f"kmeans: n={n} < k={k}")
    # Cap the per-step [block_n, block_c] score matrix at ~1 GB f32 — at
    # k=2^17+ an uncapped 131072 x 16384 block needs 8 GB of device memory.
    eff_c = max(128, min(block_c, -(-k // 128) * 128))
    block_n = min(block_n, max(1024, (1 << 28) // eff_c))
    block_n = min(block_n, max(8, n))
    nb = -(-n // block_n)
    n_pad = nb * block_n
    padded = np.zeros((n_pad, d), np.float32)
    padded[:n] = data
    valid = np.zeros((n_pad,), np.bool_)
    valid[:n] = True
    data_blocks = jnp.asarray(padded.reshape(nb, block_n, d))
    valid = jnp.asarray(valid.reshape(nb, block_n))

    # k-means++ on a subsample (D^2 seeding fixes merged-cluster minima that
    # random init falls into). Its sequential k-step loop is only worth it
    # for small/medium k; very large k (coarse centroids at 2^20) uses
    # hierarchical ++ seeding (super-clusters, then proportional per-cluster
    # sampling) — flat random init left badly skewed list sizes.
    k_init, key = jax.random.split(key)
    rng = np.random.RandomState(
        int(jax.random.randint(k_init, (), 0, 2**31 - 1)))
    if k <= 8192:
        # >= 32 samples per cluster: a thin subsample seeds k-means++ poorly
        # and leaves badly skewed cluster sizes (observed 24x skew at
        # nc=8192 with random init — oversized lists blow up scan windows).
        sub_n = min(n, max(32 * k, 16384))
        sub = data[rng.permutation(n)[:sub_n]]
        centroids = kmeanspp_init(k_init, jnp.asarray(sub), k,
                                  precision=precision)
    else:
        centroids = jnp.asarray(hierarchical_seed(
            k_init, data, k, block_c=block_c, precision=precision))

    sse = jnp.float32(0.0)
    for it in range(niter):
        sums, counts, sse = _stream_iter(data_blocks, valid, centroids, k,
                                         block_c, precision)
        centroids = _update_with_split(sums, counts, centroids)
        if verbose:
            print(f"  kmeans iter {it}: mse={float(sse) / n:.4f} "
                  f"empty={int(jnp.sum(counts == 0))}")
    return centroids, float(sse) / n


@jax.jit
def _update_with_split(sums, counts, centroids):
    """Mean update; empty clusters relocate beside the biggest cluster's
    centroid with a per-cluster deterministic offset (split-the-biggest)."""
    k = counts.shape[0]
    nonempty = counts > 0
    means = sums / jnp.maximum(counts, 1.0)[:, None]
    big = jnp.argmax(counts)
    offs = ((jnp.arange(k, dtype=jnp.float32) % 7.0) + 1.0)[:, None] * 1e-4
    cand = means[big][None, :] * (1.0 + offs) + offs
    return jnp.where(nonempty[:, None], means, cand)


@functools.partial(jax.jit, static_argnames=("k", "niter", "precision"))
def kmeans_batched(key, data, k: int, niter: int = 25, precision=None,
                   init=None):
    """Lloyd's k-means over a batch of independent problems.

    data: [B, n, d]; returns centroids [B, k, d]. Used for PQ subspace
    codebooks (B = M subquantizers) and the norm quantizer (B=1, d=1).
    Fully jitted: the iteration loop is unrolled at trace time.

    init: optional warm-start centroids [B, k, d] (used by the OPQ
    alternation, which re-trains PQ a few iterations per rotation update).
    """
    B, n, d = data.shape
    data = data.astype(jnp.float32)
    keys = jax.random.split(key, B)
    if init is None:
        sub_n = min(n, max(4 * k, 4096))
        centroids = jax.vmap(
            lambda kk, x: kmeanspp_init(kk, x[:sub_n], k,
                                        precision=precision))(keys, data)
    else:
        centroids = init

    def one_iter(cent, x):
        dists = l2sqr_pairwise(x, cent, precision=precision)
        idx = jnp.argmin(dists, axis=1)
        sums = jax.ops.segment_sum(x, idx, num_segments=k)
        counts = jax.ops.segment_sum(jnp.ones((n,), jnp.float32), idx,
                                     num_segments=k)
        return _update_with_split(sums, counts, cent)

    for _ in range(niter):
        centroids = jax.vmap(one_iter)(centroids, data)
    return centroids
