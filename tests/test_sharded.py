"""Sharded search must reproduce single-chip results exactly (up to f32
reduction-order ties) on an 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from ivfhnsw_tpu import IVFADCIndex, IndexConfig, SearchParams
from ivfhnsw_tpu.parallel import ShardedIVFADC, make_mesh


@pytest.fixture(scope="module")
def built():
    rng = np.random.RandomState(5)
    nb, d = 12000, 32
    centers = rng.randn(48, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 48, nb)] + rng.randn(nb, d).astype(np.float32)
    queries = centers[rng.randint(0, 48, 32)] + rng.randn(32, d).astype(np.float32)
    cfg = IndexConfig(d=d, nc=64, code_size=8)
    idx = IVFADCIndex(cfg)
    key = jax.random.PRNGKey(0)
    idx.train_centroids(key, base[:4000], niter=12)
    idx.train_pq(key, base[:4000])
    idx.add_batch(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    return idx, queries


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_matches_single_chip(built, ndev):
    idx, queries = built
    mesh = make_mesh(ndev)
    sharded = ShardedIVFADC(idx, mesh)
    p = SearchParams(k=10, nprobe=8, max_codes=0)
    d1, l1 = idx.search(queries, p)
    d2, l2 = sharded.search(queries, p)
    np.testing.assert_allclose(d2, d1, rtol=1e-4, atol=1e-3)
    mism = l1 != l2
    if mism.any():  # ties may swap
        assert np.allclose(d1[mism], d2[mism], rtol=1e-4, atol=1e-3)


def test_sharded_max_codes_budget(built):
    idx, queries = built
    mesh = make_mesh(4)
    sharded = ShardedIVFADC(idx, mesh)
    p = SearchParams(k=10, nprobe=16, max_codes=500)
    d1, l1 = idx.search(queries, p)
    d2, l2 = sharded.search(queries, p)
    np.testing.assert_allclose(d2, d1, rtol=1e-4, atol=1e-3)


def test_sharded_rejects_bad_partition(built):
    idx, _ = built
    mesh = make_mesh(3)  # 64 % 3 != 0
    with pytest.raises(ValueError):
        ShardedIVFADC(idx, mesh)


@pytest.fixture(scope="module")
def built_grouping():
    import jax as _jax
    from ivfhnsw_tpu import IVFADCGroupingIndex
    rng = np.random.RandomState(6)
    nb, d = 10000, 32
    centers = rng.randn(40, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, nb)] + rng.randn(nb, d).astype(np.float32)
    queries = centers[rng.randint(0, 40, 24)] + rng.randn(24, d).astype(np.float32)
    cfg = IndexConfig(d=d, nc=32, code_size=8, nsubc=4)
    idx = IVFADCGroupingIndex(cfg)
    key = _jax.random.PRNGKey(0)
    idx.train_centroids(key, base[:4000], niter=10)
    idx.compute_neighbor_centroids()
    idx.train_pq(key, base[:3000])
    idx.add(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    return idx, queries


@pytest.mark.parametrize("ndev,pruning", [(4, False), (8, True)])
def test_sharded_grouping_matches_single_chip(built_grouping, ndev, pruning):
    from ivfhnsw_tpu.parallel.sharded_grouping import ShardedGrouping
    idx, queries = built_grouping
    idx.engine = "xla"
    p = SearchParams(k=10, nprobe=8, max_codes=800, do_pruning=pruning)
    d1, l1 = idx.search(queries, p)
    sharded = ShardedGrouping(idx, make_mesh(ndev))
    d2, l2 = sharded.search(queries, p)
    np.testing.assert_allclose(d2, d1, rtol=1e-4, atol=1e-3)
    mism = l1 != l2
    if mism.any():
        assert np.allclose(d1[mism], d2[mism], rtol=1e-4, atol=1e-3)


def test_sharded_grouping_rejects_kernel_engine(built_grouping):
    """Sharded grouping has only the XLA scan; a kernel engine raises."""
    from ivfhnsw_tpu.parallel.sharded_grouping import ShardedGrouping
    idx, queries = built_grouping
    sharded = ShardedGrouping(idx, make_mesh(4))
    with pytest.raises(ValueError, match="no scan kernel"):
        sharded.search(queries, SearchParams(k=10, nprobe=8),
                       engine="pallas_interpret")


@pytest.mark.parametrize("max_codes", [0, 500])
def test_sharded_pallas_engine_matches(built, max_codes):
    """Shard-local scan kernel (Pallas interpreter) == XLA shard scan ==
    single chip, with and without a budget."""
    idx, queries = built
    sharded = ShardedIVFADC(idx, make_mesh(4))
    p = SearchParams(k=10, nprobe=8, max_codes=max_codes)
    d0, _ = idx.search(queries, p)
    d1, l1 = sharded.search(queries, p, engine="xla")
    d2, l2 = sharded.search(queries, p, engine="pallas_interpret")
    np.testing.assert_allclose(d2, d1, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(d2, d0, rtol=1e-4, atol=1e-3)
    mism = l1 != l2
    if mism.any():
        assert np.allclose(d1[mism], d2[mism], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("use_opq", [False, True])
def test_build_step_matches_encode_batch(use_opq):
    """The sharded assign+encode step must reproduce IVFADCIndex._encode_batch
    (incl. the OPQ rotation and RECONSTRUCTION-norm codes) exactly."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ivfhnsw_tpu.parallel.build import make_assign_encode_step
    from ivfhnsw_tpu.parallel.mesh import SHARD_AXIS
    from ivfhnsw_tpu.parallel import ShardedIVFADC

    rng = np.random.RandomState(7)
    nb, d = 4000, 32
    base = rng.randn(nb, d).astype(np.float32)
    cfg = IndexConfig(d=d, nc=64, code_size=8, do_opq=use_opq)
    idx = IVFADCIndex(cfg)
    key = jax.random.PRNGKey(1)
    idx.train_centroids(key, base[:2000], niter=8)
    idx.train_pq(key, base[:2000], opq_niter=4)
    idx.add_batch(base[:64], np.arange(64, dtype=np.int32))
    idx.finalize()

    mesh = make_mesh(8)
    sharded = ShardedIVFADC(idx, mesh)
    step = make_assign_encode_step(mesh, use_opq=use_opq)
    x = base[1000:1512]
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(SHARD_AXIS)))
    R = idx.opq_R if use_opq else jnp.zeros((0, 0), jnp.float32)
    keys, codes, norm_codes = step(xs, sharded.centroids, sharded.codebooks,
                                   R, idx.norm_pq.centroids)

    ref_keys = idx.assign(x)
    ref_codes, ref_norms = idx._encode_batch(jnp.asarray(x), ref_keys)
    np.testing.assert_array_equal(np.asarray(keys), ref_keys)
    np.testing.assert_array_equal(np.asarray(codes), np.asarray(ref_codes))
    np.testing.assert_array_equal(np.asarray(norm_codes),
                                  np.asarray(ref_norms))
