"""The grouping index's XLA search (its one engine) against the numpy
oracle of the reference Grouping(+Pruning) search in test_grouping.py, over
the budget and pruning modes, OPQ, the device-resident path and profiled
scan budgets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ivfhnsw_tpu import IVFADCGroupingIndex, IndexConfig, SearchParams
from test_grouping import assert_matches_oracle, grouping_oracle


@pytest.fixture(scope="module")
def built():
    rng = np.random.RandomState(13)
    nb, d = 8000, 32
    centers = rng.randn(40, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, nb)] + rng.randn(nb, d).astype(np.float32)
    queries = centers[rng.randint(0, 40, 20)] + rng.randn(20, d).astype(np.float32)
    cfg = IndexConfig(d=d, nc=32, code_size=8, nsubc=8)
    idx = IVFADCGroupingIndex(cfg)
    key = jax.random.PRNGKey(0)
    idx.train_centroids(key, base[:4000], niter=10)
    idx.compute_neighbor_centroids()
    idx.train_pq(key, base[:3000])
    idx.add(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    return idx, queries


def check(idx, queries, nprobe, k, max_codes, do_pruning=False):
    d, l = idx.search(queries, SearchParams(k=k, nprobe=nprobe,
                                            max_codes=max_codes,
                                            do_pruning=do_pruning))
    rd, ri = grouping_oracle(idx, queries, nprobe, k, max_codes=max_codes,
                             do_pruning=do_pruning)
    assert_matches_oracle(d, l, rd, ri)


def test_grouping_pallas_unlimited(built):
    idx, queries = built
    check(idx, queries, 6, 10, 0)


def test_grouping_pallas_pruning(built):
    idx, queries = built
    check(idx, queries, 8, 10, 600, do_pruning=True)


def test_grouping_pallas_budget(built):
    idx, queries = built
    check(idx, queries, 8, 10, 400)


def test_grouping_pallas_aggressive_pruning(built):
    """Under heavy pruning the budget gate admits many probes (effective
    sizes are small) while each included probe keeps its full group span:
    the static window must be provisioned for that demand."""
    idx, queries = built
    check(idx, queries, 12, 10, 100, do_pruning=True)


def test_grouping_pallas_opq():
    rng = np.random.RandomState(31)
    nb, d = 6000, 32
    base = rng.randn(nb, d).astype(np.float32)
    queries = rng.randn(12, d).astype(np.float32)
    cfg = IndexConfig(d=d, nc=32, code_size=8, nsubc=8, do_opq=True)
    idx = IVFADCGroupingIndex(cfg)
    key = jax.random.PRNGKey(2)
    idx.train_centroids(key, base[:3000], niter=8)
    idx.compute_neighbor_centroids()
    idx.train_pq(key, base[:3000], opq_niter=5)
    idx.add(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    check(idx, queries, 8, 10, 500, do_pruning=True)


def test_grouping_search_device_matches_host(built):
    """Grouping device-resident serving path vs host search API."""
    idx, queries = built
    p = SearchParams(k=10, nprobe=8, max_codes=2000, do_pruning=True)
    d1, l1 = idx.search(queries, p)
    dd, ll = idx.search_device(jnp.asarray(queries[:16]), p)
    np.testing.assert_allclose(np.asarray(dd), d1[:16], rtol=1e-4,
                               atol=1e-3)


def test_grouping_profiled_scan_budget(built):
    """A profiled scan_budget (scan_slot_demand max) caps the grouping
    window without changing any result, with and without pruning."""
    idx, queries = built
    for extra in ({"do_pruning": True}, {}):
        base_p = SearchParams(k=5, nprobe=8, max_codes=600, **extra)
        dem = idx.scan_slot_demand(queries, base_p)
        assert dem.min() > 0
        capped = SearchParams(k=5, nprobe=8, max_codes=600,
                              scan_budget=-(-int(dem.max()) // 128) * 128,
                              **extra)
        if not extra:   # exact demand: never above the worst-case window
            assert capped.scan_budget <= idx._scan_budget(base_p)
        d1, l1 = idx.search(queries, base_p)
        d2, l2 = idx.search(queries, capped)
        np.testing.assert_allclose(np.asarray(d2), np.asarray(d1),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(l2), np.asarray(l1))


def test_grouping_rejects_kernel_engine(built):
    """The grouping index has no scan kernel: naming one raises instead of
    silently running the XLA path."""
    idx, queries = built
    idx.engine = "pallas_interpret"
    try:
        with pytest.raises(ValueError, match="no scan kernel"):
            idx.search(queries[:2], SearchParams(k=3, nprobe=4))
    finally:
        idx.engine = "auto"
