import jax
import jax.numpy as jnp
import numpy as np

from ivfhnsw_tpu.ops.distances import (assign_top1, l2sqr_pairwise,
                                       streaming_topk_l2)
from ivfhnsw_tpu.ops.kmeans import kmeans, kmeans_batched
from ivfhnsw_tpu.ops.topk import merge_topk, topk_smallest

HI = jax.lax.Precision.HIGHEST


def exact_l2(x, y):
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def test_l2sqr_pairwise_matches_numpy(rng):
    x = rng.rand(13, 8).astype(np.float32)
    y = rng.rand(29, 8).astype(np.float32)
    got = np.asarray(l2sqr_pairwise(jnp.asarray(x), jnp.asarray(y),
                                    precision=HI))
    np.testing.assert_allclose(got, exact_l2(x, y), rtol=1e-4, atol=1e-4)


def test_streaming_topk_exact(rng):
    x = rng.rand(7, 16).astype(np.float32)
    y = rng.rand(1000, 16).astype(np.float32)
    d, i = streaming_topk_l2(jnp.asarray(x), jnp.asarray(y), 5, block=128,
                             precision=HI)
    ref = exact_l2(x, y)
    ref_i = np.argsort(ref, axis=1)[:, :5]
    np.testing.assert_array_equal(np.asarray(i), ref_i)
    np.testing.assert_allclose(np.asarray(d),
                               np.take_along_axis(ref, ref_i, 1),
                               rtol=1e-4, atol=1e-4)
    # Ascending order is part of the contract (max_codes budget relies on it).
    assert (np.diff(np.asarray(d), axis=1) >= -1e-6).all()


def test_streaming_topk_binned_reduce_matches(rng):
    # exact_reduce="binned" is the same exact selection through the 3-pass
    # binned block reduction (modulo equal-distance tie order).
    x = rng.rand(16, 32).astype(np.float32)
    y = rng.rand(4096, 32).astype(np.float32)
    for k, block in ((1, 1024), (10, 1024), (32, 512)):
        dt, it = streaming_topk_l2(jnp.asarray(x), jnp.asarray(y), k,
                                   block=block, precision=HI)
        db, ib = streaming_topk_l2(jnp.asarray(x), jnp.asarray(y), k,
                                   block=block, precision=HI,
                                   exact_reduce="binned")
        np.testing.assert_allclose(np.asarray(db), np.asarray(dt), rtol=1e-6)
        mism = np.asarray(ib) != np.asarray(it)
        assert np.allclose(np.asarray(db)[mism], np.asarray(dt)[mism])


def test_streaming_topk_nondivisible_block(rng):
    x = rng.rand(3, 8).astype(np.float32)
    y = rng.rand(77, 8).astype(np.float32)
    d, i = streaming_topk_l2(jnp.asarray(x), jnp.asarray(y), 4, block=32,
                             precision=HI)
    ref_i = np.argsort(exact_l2(x, y), axis=1)[:, :4]
    np.testing.assert_array_equal(np.asarray(i), ref_i)


def test_assign_top1(rng):
    x = rng.rand(50, 8).astype(np.float32)
    c = rng.rand(20, 8).astype(np.float32)
    _, idx = assign_top1(jnp.asarray(x), jnp.asarray(c), precision=HI)
    np.testing.assert_array_equal(np.asarray(idx),
                                  exact_l2(x, c).argmin(1))


def test_topk_merge(rng):
    a = rng.rand(4, 6).astype(np.float32)
    b = rng.rand(4, 6).astype(np.float32)
    da, ia = topk_smallest(jnp.asarray(a), 3)
    db, ib = topk_smallest(jnp.asarray(b), 3)
    d, i = merge_topk(da, ia + 100, db, ib + 200, 3)
    ref = np.sort(np.concatenate([a, b], axis=1), axis=1)[:, :3]
    np.testing.assert_allclose(np.asarray(d), ref, rtol=1e-6)


def test_binned_topk_exact(rng):
    from ivfhnsw_tpu.ops.topk import binned_topk_smallest
    x = rng.rand(8, 4096).astype(np.float32)
    x[2, 100:110] = 0.0  # clustered minima land in one bin
    for k in (1, 10, 64):
        dv, iv = binned_topk_smallest(jnp.asarray(x), k)
        dr, ir = topk_smallest(jnp.asarray(x), k)
        np.testing.assert_allclose(np.asarray(dv), np.asarray(dr), rtol=1e-7)
        # label agreement up to exact-distance ties
        mism = np.asarray(iv) != np.asarray(ir)
        assert np.allclose(np.asarray(dv)[mism], np.asarray(dr)[mism])
    # +inf-padded tails (the masked scan output shape)
    x[:, 2000:] = np.inf
    dv, iv = binned_topk_smallest(jnp.asarray(x), 16)
    dr, _ = topk_smallest(jnp.asarray(x), 16)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(dr), rtol=1e-7)
    # non-divisible width falls back to the one-shot path
    dv, _ = binned_topk_smallest(jnp.asarray(x[:, :4000]), 8)
    dr, _ = topk_smallest(jnp.asarray(x[:, :4000]), 8)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(dr), rtol=1e-7)


def test_kmeans_separated_clusters(rng):
    # 4 well-separated blobs; k-means must find all 4 centers.
    centers = np.array([[0, 0], [10, 0], [0, 10], [10, 10]], np.float32)
    data = (centers[rng.randint(0, 4, 500)] +
            rng.randn(500, 2).astype(np.float32) * 0.1)
    cents, mse = kmeans(jax.random.PRNGKey(0), data, 4, niter=20,
                        block_c=128, block_n=64, precision=HI)
    cents = np.asarray(cents)
    # Each true center has a learned centroid within 0.2.
    d = exact_l2(centers, cents)
    assert (d.min(axis=1) < 0.2 ** 2 * 2).all()
    assert mse < 0.1


def test_kmeans_batched_matches_flat(rng):
    data = rng.rand(2, 300, 4).astype(np.float32)
    cents = kmeans_batched(jax.random.PRNGKey(1), jnp.asarray(data), 8,
                           niter=15)
    assert cents.shape == (2, 8, 4)
    # Quantization error should be well below data variance.
    for b in range(2):
        d = exact_l2(data[b], np.asarray(cents[b]))
        assert d.min(axis=1).mean() < data[b].var(axis=0).sum() * 0.5


def test_kmeans_key_threading(rng):
    """Two different PRNG keys must give different subsamples/inits (the
    subsample permutation used to be pinned to RandomState(0))."""
    import jax
    from ivfhnsw_tpu.ops.kmeans import kmeans

    data = rng.randn(4096, 8).astype(np.float32)
    c1, _ = kmeans(jax.random.PRNGKey(0), data, 16, niter=0)
    c2, _ = kmeans(jax.random.PRNGKey(1), data, 16, niter=0)
    c1b, _ = kmeans(jax.random.PRNGKey(0), data, 16, niter=0)
    assert not np.allclose(np.asarray(c1), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c1b))


def test_hierarchical_seed_large_k(rng):
    """Large-k seeding: exactly k seeds, drawn from the data, and the
    resulting clustering has bounded size skew after a few Lloyd rounds."""
    import jax
    from ivfhnsw_tpu.ops.kmeans import hierarchical_seed
    from ivfhnsw_tpu.ops.distances import assign_top1
    import jax.numpy as jnp

    # Clustered data (the regime where flat random init skews badly).
    centers = rng.randn(64, 8).astype(np.float32) * 8
    data = (centers[rng.randint(0, 64, 65536)]
            + rng.randn(65536, 8).astype(np.float32))
    k = 1024
    seeds = hierarchical_seed(jax.random.PRNGKey(3), data, k)
    assert seeds.shape == (k, 8)
    seeds2 = hierarchical_seed(jax.random.PRNGKey(3), data, k)
    np.testing.assert_array_equal(seeds, seeds2)
    assert np.unique(seeds, axis=0).shape[0] > 0.98 * k
    # Size-skew bound after assignment to the raw seeds.
    _, idx = assign_top1(jnp.asarray(data), jnp.asarray(seeds))
    counts = np.bincount(np.asarray(idx), minlength=k)
    assert counts.max() / max(counts.mean(), 1) < 20.0


def test_streaming_topk_approx_mode(rng):
    """approx=True (the large-nc coarse probe-selection mode,
    SearchParams.coarse_mode) keeps the sorted-ascending contract and on
    the CPU backend matches the exact path (approx_min_k falls back to an
    exact sort on the CPU)."""
    import jax.numpy as jnp
    from ivfhnsw_tpu.ops.distances import streaming_topk_l2

    pts = jnp.asarray(rng.randn(2048, 16).astype(np.float32))
    q = jnp.asarray(rng.randn(8, 16).astype(np.float32))
    de, ie = streaming_topk_l2(q, pts, 16, block=512)
    da, ia = streaming_topk_l2(q, pts, 16, block=512, approx=True)
    np.testing.assert_array_equal(np.asarray(ie), np.asarray(ia))
    d_np = np.asarray(da)
    assert (np.diff(d_np, axis=1) >= -1e-6).all()


def test_inner_product_matches_numpy(rng):
    from ivfhnsw_tpu.ops.distances import inner_product
    x = rng.rand(9, 24).astype(np.float32)
    y = rng.rand(17, 24).astype(np.float32)
    got = np.asarray(inner_product(jnp.asarray(x), jnp.asarray(y),
                                   precision=HI))
    np.testing.assert_allclose(got, x @ y.T, rtol=1e-5, atol=1e-5)
