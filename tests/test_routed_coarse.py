"""Routed two-level coarse probe selection (ops.routed_coarse).

Oracle strategy: with w = n_super (all supers probed) routing degenerates
to an exact sweep over a permutation of the centroid set, so results must
match streaming_topk_l2 exactly; with small w on mesoscale-structured data
the probe overlap must stay high. End-to-end, the Pallas-interpret engine
with coarse_mode="routed" must reproduce the exact engine's labels when
coverage is total.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ivfhnsw_tpu import IVFADCIndex, IndexConfig, SearchParams
from ivfhnsw_tpu.ops.distances import streaming_topk_l2
from ivfhnsw_tpu.ops.routed_coarse import (RoutedCoarse, greedy_partition,
                                           routed_select_ext)


def _clustered_centroids(nc=512, d=32, n_groups=16, seed=0):
    """Centroid set WITH mesoscale structure (what routing presumes)."""
    rng = np.random.RandomState(seed)
    g = rng.randn(n_groups, d).astype(np.float32) * 8.0
    which = rng.randint(0, n_groups, nc)
    return (g[which] + rng.randn(nc, d).astype(np.float32)).astype(np.float32)


def test_partition_covers_every_centroid_once():
    cents = _clustered_centroids()
    rc = RoutedCoarse(cents, n_super=16, key=jax.random.PRNGKey(1))
    members = np.asarray(rc.members)[np.asarray(rc.valid)]
    assert members.size == cents.shape[0]
    assert np.array_equal(np.sort(members), np.arange(cents.shape[0]))


def test_partition_capacity_respected():
    cents = _clustered_centroids(nc=256)
    supers = jnp.asarray(_clustered_centroids(nc=8, seed=3))
    members, valid = greedy_partition(cents, supers, cap=48)
    assert valid.sum(axis=1).max() <= 48
    assert valid.sum() == 256


def test_full_w_matches_exact_sweep():
    cents = _clustered_centroids(nc=384, d=16)
    nc = cents.shape[0]
    rng = np.random.RandomState(7)
    rc = RoutedCoarse(cents, n_super=12, key=jax.random.PRNGKey(2))
    cn = (cents ** 2).sum(1)
    table = rc.build_table(cn)
    assert table.shape == (rc.n_super, rc.cap, 16 + 2)
    q = rng.randn(24, 16).astype(np.float32)

    nprobe = 10
    d2, probes, term1 = routed_select_ext(
        jnp.asarray(q), rc.supers, rc.super_sqn, table,
        nprobe=nprobe, w=rc.n_super)
    ed, ei = streaming_topk_l2(jnp.asarray(q), jnp.asarray(cents), nprobe,
                               point_sqnorms=jnp.asarray(cn))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(ed),
                               rtol=1e-4, atol=1e-3)
    # Probe SETS must match (ties may reorder within equal distances).
    for i in range(q.shape[0]):
        assert set(np.asarray(probes)[i].tolist()) == set(
            np.asarray(ei)[i].tolist())
    p = np.asarray(probes)
    # term1 = qc_dist - ||c||^2 (IndexIVF_HNSW.cpp:277).
    np.testing.assert_allclose(np.asarray(term1),
                               np.asarray(d2) - cn[p], rtol=1e-4, atol=1e-2)


def test_small_w_overlap_on_structured_data():
    cents = _clustered_centroids(nc=512, d=32, n_groups=16)
    rc = RoutedCoarse(cents, n_super=16, key=jax.random.PRNGKey(4))
    cn = (cents ** 2).sum(1)
    table = rc.build_table(cn)
    rng = np.random.RandomState(11)
    which = rng.randint(0, 512, 64)
    q = cents[which] + rng.randn(64, 32).astype(np.float32) * 0.3

    _, probes, _ = routed_select_ext(jnp.asarray(q), rc.supers,
                                      rc.super_sqn, table, nprobe=8, w=4)
    _, exact = streaming_topk_l2(jnp.asarray(q), jnp.asarray(cents), 8,
                                 point_sqnorms=jnp.asarray(cn))
    pr, ex = np.asarray(probes), np.asarray(exact)
    overlap = np.mean([np.intersect1d(pr[i], ex[i]).size / 8
                       for i in range(64)])
    assert overlap > 0.9


def test_w_cap_must_cover_nprobe():
    cents = _clustered_centroids(nc=128, d=16)
    rc = RoutedCoarse(cents, n_super=8, key=jax.random.PRNGKey(5))
    table = rc.build_table((cents ** 2).sum(1))
    with pytest.raises(ValueError, match="nprobe"):
        routed_select_ext(jnp.zeros((4, 16)), rc.supers, rc.super_sqn,
                          table, nprobe=rc.cap + 1, w=1)


def _tiny_index(nc=64, nb=20000, d=32, seed=0):
    rng = np.random.RandomState(seed)
    cfg = IndexConfig(d=d, nc=nc, code_size=8)
    idx = IVFADCIndex(cfg)
    groups = rng.randn(8, d).astype(np.float32) * 6.0
    cents = (groups[rng.randint(0, 8, nc)]
             + rng.randn(nc, d).astype(np.float32))
    idx.set_centroids(cents)
    base = (cents[rng.randint(0, nc, nb)]
            + rng.randn(nb, d).astype(np.float32) * 0.5)
    idx.train_pq(jax.random.PRNGKey(0), base[:4096])
    idx.add_batch(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    return idx, base, rng


def test_end_to_end_routed_interpret_matches_exact():
    """Scan kernel (Pallas interpreter), coarse_mode='routed' with total
    coverage (w = n_super) == the exact engine's results."""
    idx, base, rng = _tiny_index()
    idx.engine = "pallas_interpret"
    q = base[rng.randint(0, base.shape[0], 32)]
    p_exact = SearchParams(k=5, nprobe=6, max_codes=3000,
                           coarse_mode="exact")
    d0, l0 = idx.search(q, p_exact)

    idx.enable_routed_coarse(w=64, n_super=8, key=jax.random.PRNGKey(9))
    p_routed = SearchParams(k=5, nprobe=6, max_codes=3000,
                            coarse_mode="routed")
    d1, l1 = idx.search(q, p_routed)
    np.testing.assert_allclose(d1, d0, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(l1, l0)


def test_routed_requires_structure():
    idx, base, rng = _tiny_index(nb=5000)
    idx.engine = "pallas_interpret"
    with pytest.raises(ValueError, match="enable_routed_coarse"):
        idx.search(base[:4], SearchParams(k=3, nprobe=4, max_codes=0,
                                          coarse_mode="routed"))


def test_auto_mode_ignores_structure_at_small_nc():
    """auto keeps exact selection at nc <= 16384 even when a routing
    structure exists (routing only replaces the approx regime)."""
    idx, base, rng = _tiny_index(nb=5000)
    idx.enable_routed_coarse(w=2, n_super=8)
    routed, rw = idx._routed_for(SearchParams(coarse_mode="auto"), 6)
    assert routed is None and rw == 0
    routed, rw = idx._routed_for(SearchParams(coarse_mode="routed"), 6)
    assert routed is not None and rw == 2


def test_from_state_cache_roundtrip(tmp_path):
    """enable_routed_coarse(cache_path=...) persists the derived routing
    structure; a reload from the cache reproduces identical probe
    selection without re-running k-means/partition."""
    idx, base, rng = _tiny_index(nb=5000)
    idx.engine = "pallas_interpret"
    p = str(tmp_path / "routed.npz")
    idx.enable_routed_coarse(w=4, n_super=8, cache_path=p)
    sp = SearchParams(k=3, nprobe=6, max_codes=0, coarse_mode="routed")
    q = base[:16]
    d1, l1 = idx.search(q, sp)
    rc1 = idx._routed_coarse
    idx._routed_coarse = None
    idx.enable_routed_coarse(w=4, n_super=8, cache_path=p)
    rc2 = idx._routed_coarse
    assert rc2 is not rc1
    np.testing.assert_array_equal(rc2.members, rc1.members)
    np.testing.assert_array_equal(rc2.valid, rc1.valid)
    assert rc2.cap == rc1.cap and rc2.n_super == rc1.n_super
    d2, l2 = idx.search(q, sp)
    np.testing.assert_array_equal(np.asarray(l2), np.asarray(l1))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1))
