"""The GPU scan kernel (ops.adc_kernel) must produce the same results as the
portable XLA path (itself oracle-verified in test_ivfadc.py). On the CPU the
kernel runs in the Pallas interpreter; tests marked ``gpu`` compile it for
the card and skip elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ivfhnsw_tpu import IVFADCIndex, IndexConfig, SearchParams
from ivfhnsw_tpu.ops import adc as adc_ops
from ivfhnsw_tpu.ops import adc_kernel


@pytest.fixture(scope="module")
def built():
    rng = np.random.RandomState(9)
    nb, d = 9000, 32
    centers = rng.randn(48, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 48, nb)] + rng.randn(nb, d).astype(np.float32)
    queries = centers[rng.randint(0, 48, 24)] + rng.randn(24, d).astype(np.float32)
    cfg = IndexConfig(d=d, nc=64, code_size=8)
    idx = IVFADCIndex(cfg)
    key = jax.random.PRNGKey(0)
    idx.train_centroids(key, base[:4000], niter=12)
    idx.train_pq(key, base[:4000])
    idx.add_batch(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    return idx, queries


def both_engines(idx, queries, params, kernel="pallas_interpret"):
    prev = idx.engine
    try:
        idx.engine = "xla"
        d1, l1 = idx.search(queries, params)
        idx.engine = kernel
        d2, l2 = idx.search(queries, params)
    finally:
        idx.engine = prev
    return d1, l1, d2, l2


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=1e-4, atol=1e-3)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=1e-4, atol=1e-3)


def test_pallas_matches_xla_unlimited(built):
    idx, queries = built
    d1, l1, d2, l2 = both_engines(idx, queries,
                                  SearchParams(k=10, nprobe=8, max_codes=0))
    assert_same(d1, l1, d2, l2)


def test_pallas_matches_xla_budget(built):
    idx, queries = built
    d1, l1, d2, l2 = both_engines(
        idx, queries, SearchParams(k=10, nprobe=16, max_codes=300))
    assert_same(d1, l1, d2, l2)


def test_pallas_opq():
    rng = np.random.RandomState(10)
    nb, d = 5000, 32
    base = rng.randn(nb, d).astype(np.float32)
    queries = rng.randn(10, d).astype(np.float32)
    cfg = IndexConfig(d=d, nc=32, code_size=8, do_opq=True)
    idx = IVFADCIndex(cfg)
    key = jax.random.PRNGKey(1)
    idx.train_centroids(key, base[:3000], niter=8)
    idx.train_pq(key, base[:3000], opq_niter=5)
    idx.add_batch(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    d1, l1, d2, l2 = both_engines(idx, queries,
                                  SearchParams(k=5, nprobe=4, max_codes=0))
    assert_same(d1, l1, d2, l2)


def test_search_device_matches_host(built):
    """The device-resident serving path (search_device) through the kernel
    must agree with the host search API on the XLA path."""
    idx, queries = built
    p = SearchParams(k=10, nprobe=8, max_codes=1000)
    idx.engine = "xla"
    d1, l1 = idx.search(queries, p)
    idx.engine = "pallas_interpret"
    try:
        dd, ll = idx.search_device(jnp.asarray(queries[:16]), p)
        dg, lg = idx.search_device(
            jnp.asarray(queries[:16]).reshape(2, 8, -1), p)
    finally:
        idx.engine = "auto"
    assert dd.shape == (16, 10) and dg.shape == (2, 8, 10)
    assert_same(d1[:16], l1[:16], np.asarray(dd), np.asarray(ll))
    assert_same(d1[:16], l1[:16], np.asarray(dg).reshape(16, -1),
                np.asarray(lg).reshape(16, -1))


def test_coarse_approx_ext_path(built):
    """coarse_mode='approx' routes through streaming_topk_l2's approx_min_k
    path inside the kernel engine. With recall_target ~1.0 on a small
    centroid set the probe cut matches exact coarse, so results must agree
    with the exact-coarse engine."""
    idx, queries = built
    prev = idx.engine
    try:
        idx.engine = "pallas_interpret"
        p_ex = SearchParams(k=10, nprobe=8, max_codes=2000,
                            coarse_mode="exact")
        d1, l1 = idx.search(queries, p_ex)
        p_ap = SearchParams(k=10, nprobe=8, max_codes=2000,
                            coarse_mode="approx", coarse_recall=1.0)
        d2, l2 = idx.search(queries, p_ap)
    finally:
        idx.engine = prev
    assert_same(d1, l1, d2, l2)


def test_profiled_scan_budget_exact(built):
    """scan_budget >= the profiled max demand caps the kernel's slot count
    without changing ANY result (profile-guided serving config)."""
    idx, queries = built
    params = SearchParams(k=5, nprobe=8, max_codes=2000)
    dem = idx.scan_slot_demand(queries, params)
    assert dem.shape == (queries.shape[0],) and dem.min() > 0
    assert (dem % adc_kernel.BLOCK == 0).all()
    worst = idx._n_slots(params, 8)
    capped = SearchParams(k=5, nprobe=8, max_codes=2000,
                          scan_budget=int(dem.max()))
    assert idx._n_slots(capped, 8) <= worst
    assert idx._n_slots(capped, 8) * adc_kernel.BLOCK >= int(dem.max())
    prev = idx.engine
    try:
        idx.engine = "pallas_interpret"
        d1, l1 = idx.search(queries, params)
        d2, l2 = idx.search(queries, capped)
    finally:
        idx.engine = prev
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(l2), np.asarray(l1))


def test_tiny_scan_budget_truncates_farthest(built):
    """A scan_budget BELOW demand drops the farthest probes' tails: still
    returns valid results, and truncation only removes candidates."""
    idx, queries = built
    full = SearchParams(k=5, nprobe=8, max_codes=0)
    tiny = SearchParams(k=5, nprobe=8, max_codes=0,
                        scan_budget=3 * adc_kernel.BLOCK)
    assert idx._n_slots(tiny, 8) == 3
    prev = idx.engine
    try:
        idx.engine = "pallas_interpret"
        df, lf = idx.search(queries, full)
        dt, lt = idx.search(queries, tiny)
    finally:
        idx.engine = prev
    lt, dt = np.asarray(lt), np.asarray(dt)
    df = np.asarray(df)
    assert (lt >= -1).all()
    assert np.isfinite(dt[lt >= 0]).all()
    # Each query's best truncated distance can never beat its best
    # full-scan distance.
    assert (dt[:, 0] >= df[:, 0] - 1e-5).all()


def test_coarse_binned_matches_exact(built):
    """coarse_mode='binned' (the 3-pass bin-min reduction) is an EXACT
    probe selection: end-to-end results match coarse_mode='exact' through
    the kernel engine (modulo equal-distance tie labels)."""
    idx, queries = built
    prev = idx.engine
    try:
        idx.engine = "pallas_interpret"
        p_ex = SearchParams(k=10, nprobe=8, max_codes=3000,
                            coarse_mode="exact")
        d1, l1 = idx.search(queries, p_ex)
        p_bn = SearchParams(k=10, nprobe=8, max_codes=3000,
                            coarse_mode="binned")
        d2, l2 = idx.search(queries, p_bn)
    finally:
        idx.engine = prev
    assert_same(d1, l1, d2, l2)
    # scan_slot_demand follows the same mode without error
    dem = idx.scan_slot_demand(queries, p_bn)
    assert (dem > 0).all()


# ---------------------------------------------------------------------------
# The kernel against ops.adc.adc_scan on the same schedule
# ---------------------------------------------------------------------------

def _store(rng, sizes, m):
    """A random canonical store with the given list sizes."""
    n = int(np.sum(sizes))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return (jnp.asarray(rng.randint(0, 256, (n, m)).astype(np.uint8)),
            jnp.asarray(rng.randint(0, 256, n).astype(np.uint8)),
            jnp.asarray(rng.permutation(n).astype(np.int32) + 1000),
            jnp.asarray(offsets))


def _kernel_vs_reference(rng, sizes, m, max_codes, k, nq=3, nprobe=5,
                         block=adc_kernel.BLOCK, n_slots=None):
    codes, ncodes, ids, offsets = _store(rng, sizes, m)
    nc = len(sizes)
    probes = jnp.asarray(np.stack([rng.choice(nc, min(nprobe, nc),
                                              replace=False)
                                   for _ in range(nq)]).astype(np.int32))
    term1 = jnp.asarray(rng.randn(*probes.shape).astype(np.float32))
    luts = jnp.asarray(rng.randn(nq, m, 256).astype(np.float32))
    ntab = jnp.asarray(rng.rand(256).astype(np.float32) * 4)
    row_start = offsets[probes]
    eff = adc_kernel.budget_sizes(offsets[probes + 1] - row_start,
                                  jnp.int32(max_codes))
    if n_slots is None:
        n_slots = adc_kernel.n_slots_for(max_codes, int(max(sizes)),
                                         probes.shape[1], block=block)
    start, length, bias = adc_kernel.slot_schedule(
        row_start, eff, term1, n_slots=n_slots, block=block)
    dists = adc_kernel.adc_block_scan(-2.0 * luts, ntab, codes, ncodes,
                                      start, length, bias, block=block,
                                      interpret=True)
    kd, kl = adc_kernel.scan_topk(dists, start, ids, k, block)
    rd, rl = adc_kernel.reference_topk(luts, ntab, codes, ncodes, ids, start,
                                       length, bias, k, block)
    kd, kl, rd, rl = map(np.asarray, (kd, kl, rd, rl))
    np.testing.assert_allclose(kd, rd, rtol=1e-5, atol=1e-4)
    mism = kl != rl
    if mism.any():
        assert np.allclose(kd[mism], rd[mism], rtol=1e-5, atol=1e-4)
    # Rows past each slot's length are +inf; every scheduled row is finite.
    live = (np.arange(block)[None, None, :]
            < np.asarray(length)[:, :, None]).reshape(nq, -1)
    np.testing.assert_array_equal(np.isfinite(np.asarray(dists)), live)
    return np.asarray(eff), np.asarray(length)


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("max_codes", [0, 700])
@pytest.mark.parametrize("m", [8, 16, 32])
def test_kernel_matches_adc_scan(m, max_codes, k):
    rng = np.random.RandomState(m * 100 + k + max_codes)
    sizes = rng.randint(0, 600, 24)
    eff, length = _kernel_vs_reference(rng, sizes, m, max_codes, k)
    # The schedule covers exactly the rows the budget admits.
    assert length.sum(axis=1).tolist() == eff.sum(axis=1).tolist()


@pytest.mark.parametrize("case", ["empty_list", "one_code_list",
                                  "list_longer_than_block", "last_rows"])
def test_kernel_edge_cases(case):
    rng = np.random.RandomState(7)
    block = adc_kernel.BLOCK
    sizes = {"empty_list": [0, 0, 37, 0, 5],
             "one_code_list": [1, 1, 1, 1, 1],
             "list_longer_than_block": [3 * block + 17, 2, block, 9, 1],
             # The last list ends on the store's last row mid-slot: the
             # masked load must not read past the store.
             "last_rows": [5, 8, 3, 11, block + 3]}[case]
    _kernel_vs_reference(rng, np.asarray(sizes), 16, 0, 4, nq=2, nprobe=5)


def test_kernel_batch_padding(built):
    """A query batch that does not divide the launch batch is padded and
    trimmed: the last, short launch agrees with one full launch."""
    idx, queries = built
    p = SearchParams(k=5, nprobe=8, max_codes=500)
    idx.engine = "pallas_interpret"
    try:
        d_all, l_all = idx.search(queries, p)
        d_b, l_b = idx.search(queries, p, batch=16)    # 16 + 8 (padded)
    finally:
        idx.engine = "auto"
    assert d_b.shape == (queries.shape[0], 5)
    np.testing.assert_allclose(d_b, d_all, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(l_b, l_all)


@pytest.mark.parametrize("max_codes", [0, 300, 2000])
def test_slot_schedule_covers_probe_positions(max_codes):
    """The kernel's slot schedule scans exactly the rows of the XLA path's
    probe_positions window — the reference's max_codes semantics."""
    rng = np.random.RandomState(max_codes)
    sizes = rng.randint(0, 700, 40)
    offsets = jnp.asarray(np.concatenate([[0], np.cumsum(sizes)])
                          .astype(np.int32))
    probes = jnp.asarray(np.stack([rng.choice(40, 6, replace=False)
                                   for _ in range(4)]).astype(np.int32))
    row_start = offsets[probes]
    eff = adc_kernel.budget_sizes(offsets[probes + 1] - row_start,
                                  jnp.int32(max_codes))
    n_slots = adc_kernel.n_slots_for(max_codes, int(sizes.max()), 6)
    start, length, _ = adc_kernel.slot_schedule(
        row_start, eff, jnp.zeros(probes.shape), n_slots=n_slots)
    pos, _, valid, _ = adc_ops.probe_positions(
        probes, offsets, jnp.int32(max_codes), int(sizes.sum()) + 128)
    for b in range(probes.shape[0]):
        rows = [int(s) + i for s, n in zip(np.asarray(start[b]),
                                           np.asarray(length[b]))
                for i in range(int(n))]
        want = np.asarray(pos[b])[np.asarray(valid[b])].tolist()
        assert sorted(rows) == sorted(want)


@pytest.mark.parametrize("max_codes", [10_000, 100_000])
def test_xla_batch_bounded_by_window_bytes(built, max_codes):
    """The XLA path sizes its launch batch from the window's bytes
    ([B, L, M] u8 gather, its int32 widening and the [B, M, L] f32 LUT
    gather), not a fixed 8192: a 100k-code budget takes fewer queries per
    launch than a 10k one, and every launch stays within WINDOW_BYTES."""
    from ivfhnsw_tpu.models.ivfadc import WINDOW_BYTES
    idx, _ = built
    p = SearchParams(k=10, nprobe=8, max_codes=max_codes)
    cap = idx._batch_cap("xla", p, 8)
    L, m = idx._scan_budget(p), idx.config.pq_m
    assert cap % 8 == 0 and cap * L * (9 * m + 40) <= WINDOW_BYTES
    if max_codes == 100_000:
        assert cap < idx._batch_cap(
            "xla", SearchParams(k=10, nprobe=8, max_codes=10_000), 8)
    kcap = idx._batch_cap("pallas", p, 8)
    assert kcap * idx._n_slots(p, 8) * adc_kernel.BLOCK * 12 <= WINDOW_BYTES


# ---------------------------------------------------------------------------
# Engine resolution
# ---------------------------------------------------------------------------

def test_auto_resolves_to_xla_on_cpu():
    assert jax.default_backend() == "cpu"
    assert adc_kernel.resolve_engine("auto", 16) == "xla"
    idx = IVFADCIndex(IndexConfig(d=32, nc=8, code_size=8))
    assert idx._resolve_engine(trace=False) == "xla"


def test_kernel_engine_raises_off_gpu(built):
    """An explicit kernel engine on a backend that cannot compile it raises
    instead of falling back to the XLA path."""
    idx, queries = built
    with pytest.raises(ValueError, match="GPU"):
        adc_kernel.resolve_engine("pallas", 16)
    idx.engine = "pallas"
    try:
        with pytest.raises(ValueError, match="GPU"):
            idx.search(queries[:2], SearchParams(k=3, nprobe=4))
    finally:
        idx.engine = "auto"
    with pytest.raises(ValueError, match="unknown engine"):
        adc_kernel.resolve_engine("batch", 16)
    with pytest.raises(ValueError, match="power-of-two"):
        adc_kernel.resolve_engine("pallas_interpret", 12)


# ---------------------------------------------------------------------------
# On the card (skip elsewhere)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 16, 32])
def test_compiled_kernel_matches_adc_scan(gpu, m):
    """The kernel compiled for the GPU (no interpreter) against the XLA
    scan on the same schedule."""
    rng = np.random.RandomState(m)
    block = adc_kernel.BLOCK
    sizes = rng.randint(0, 3 * block, 64)
    codes, ncodes, ids, offsets = _store(rng, sizes, m)
    probes = jnp.asarray(np.stack([rng.choice(64, 16, replace=False)
                                   for _ in range(32)]).astype(np.int32))
    term1 = jnp.asarray(rng.randn(32, 16).astype(np.float32))
    luts = jnp.asarray(rng.randn(32, m, 256).astype(np.float32))
    ntab = jnp.asarray(rng.rand(256).astype(np.float32))
    row_start = offsets[probes]
    eff = adc_kernel.budget_sizes(offsets[probes + 1] - row_start,
                                  jnp.int32(2000))
    start, length, bias = adc_kernel.slot_schedule(
        row_start, eff, term1,
        n_slots=adc_kernel.n_slots_for(2000, int(sizes.max()), 16))
    dists = adc_kernel.adc_block_scan(-2.0 * luts, ntab, codes, ncodes,
                                      start, length, bias)
    kd, kl = adc_kernel.scan_topk(dists, start, ids, 10)
    rd, rl = adc_kernel.reference_topk(luts, ntab, codes, ncodes, ids, start,
                                       length, bias, 10)
    tol = 1e-4 * float(np.max(np.abs(np.asarray(rd))))
    np.testing.assert_allclose(np.asarray(kd), np.asarray(rd), atol=tol)


@pytest.mark.gpu
def test_kernel_engine_matches_xla_on_gpu(gpu, built):
    idx, queries = built
    d1, l1, d2, l2 = both_engines(idx, queries,
                                  SearchParams(k=10, nprobe=16, max_codes=300),
                                  kernel="pallas")
    assert_same(d1, l1, d2, l2)
