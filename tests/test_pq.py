import jax
import jax.numpy as jnp
import numpy as np

from ivfhnsw_tpu.ops.opq import (apply_rotation, apply_rotation_transpose,
                                 load_rotation, random_rotation,
                                 save_rotation, train_opq)
from ivfhnsw_tpu.ops.pq import NormQuantizer, ProductQuantizer


def test_pq_encode_decode_roundtrip_error(rng):
    d, M, n = 32, 8, 2000
    data = rng.randn(n, d).astype(np.float32)
    pq = ProductQuantizer(d, M).train(jax.random.PRNGKey(0), data, niter=20)
    codes = pq.encode(data)
    assert codes.shape == (n, M) and codes.dtype == jnp.uint8
    recon = np.asarray(pq.decode(codes))
    mse = ((recon - data) ** 2).sum(1).mean()
    # 8 subquantizers x 256 codewords on gaussian data: large error reduction.
    assert mse < data.var(0).sum() * 0.5


def test_pq_encode_is_nearest_codeword(rng):
    d, M = 16, 4
    data = rng.randn(500, d).astype(np.float32)
    pq = ProductQuantizer(d, M).train(jax.random.PRNGKey(1), data, niter=10)
    codes = np.asarray(pq.encode(data))
    cbs = np.asarray(pq.codebooks)  # [M, 256, dsub]
    sub = data.reshape(500, M, d // M)
    for m in range(M):
        dist = ((sub[:, m, None, :] - cbs[None, m]) ** 2).sum(-1)
        np.testing.assert_array_equal(codes[:, m], dist.argmin(1))


def test_pq_ip_luts(rng):
    d, M = 16, 4
    data = rng.randn(300, d).astype(np.float32)
    q = rng.randn(5, d).astype(np.float32)
    pq = ProductQuantizer(d, M).train(jax.random.PRNGKey(2), data, niter=10)
    luts = np.asarray(pq.ip_luts(q))  # [5, M, 256]
    cbs = np.asarray(pq.codebooks)
    qs = q.reshape(5, M, d // M)
    ref = np.einsum("bmd,mkd->bmk", qs, cbs)
    np.testing.assert_allclose(luts, ref, rtol=1e-4, atol=1e-4)
    # LUT-summed IP == decoded-vector IP
    codes = pq.encode(data)
    dec = np.asarray(pq.decode(codes))
    ip_ref = dec @ q.T  # [n, 5]
    idx = np.asarray(codes).astype(np.int64)
    ip_lut = np.stack([luts[b, np.arange(M)[None, :], idx].sum(1)
                       for b in range(5)], axis=1)
    np.testing.assert_allclose(ip_lut, ip_ref, rtol=1e-3, atol=1e-3)


def test_pq_save_load(tmp_path, rng):
    data = rng.randn(400, 16).astype(np.float32)
    pq = ProductQuantizer(16, 4).train(jax.random.PRNGKey(3), data, niter=5)
    path = str(tmp_path / "q.pq")
    pq.save(path)
    pq2 = ProductQuantizer.load(path)
    np.testing.assert_array_equal(np.asarray(pq.codebooks),
                                  np.asarray(pq2.codebooks))


def test_norm_quantizer(rng):
    norms = (rng.rand(5000).astype(np.float32) * 100) ** 2
    nq = NormQuantizer().train(jax.random.PRNGKey(4), norms)
    codes = nq.encode(norms)
    assert codes.dtype == jnp.uint8
    dec = np.asarray(nq.decode(codes))
    rel = np.abs(dec - norms) / (norms + 1e-6)
    assert np.median(rel) < 0.02


def test_rotation_orthogonal():
    R = np.asarray(random_rotation(jax.random.PRNGKey(5), 16))
    np.testing.assert_allclose(R @ R.T, np.eye(16), atol=1e-5)


def test_rotation_apply_inverse(rng):
    R = random_rotation(jax.random.PRNGKey(6), 8)
    x = rng.randn(10, 8).astype(np.float32)
    back = np.asarray(apply_rotation_transpose(apply_rotation(x, R), R))
    np.testing.assert_allclose(back, x, atol=1e-5)


def test_rotation_save_load(tmp_path):
    R = random_rotation(jax.random.PRNGKey(7), 8)
    p = str(tmp_path / "r.opq")
    save_rotation(p, R)
    np.testing.assert_allclose(np.asarray(load_rotation(p)), np.asarray(R),
                               atol=1e-7)


def test_opq_beats_plain_pq(rng):
    # Correlated data: OPQ's rotation should reduce quantization error
    # vs plain PQ with the same budget.
    d, M, n = 16, 4, 3000
    A = rng.randn(d, d).astype(np.float32)
    data = rng.randn(n, d).astype(np.float32) @ A  # strongly anisotropic
    data /= data.std()
    key = jax.random.PRNGKey(8)
    pq = ProductQuantizer(d, M).train(key, data, niter=20)
    plain_mse = float(((np.asarray(pq.decode(pq.encode(data))) - data) ** 2)
                      .sum(1).mean())
    R, opq_pq = train_opq(key, data, M, niter=10, final_pq_niter=20)
    xr = apply_rotation(data, R)
    rec = apply_rotation_transpose(opq_pq.decode(opq_pq.encode(xr)), R)
    opq_mse = float(((np.asarray(rec) - data) ** 2).sum(1).mean())
    assert opq_mse < plain_mse * 0.95, (opq_mse, plain_mse)


def test_pq_decode_chunked_matches_direct(rng):
    # The decode gather is chunked at _DECODE_CHUNK rows to bound the
    # [n, M, dsub] temp; every chunk-boundary shape
    # (below, exact multiple, multiple + ragged tail) must decode
    # identically to the direct gather.
    from ivfhnsw_tpu.ops.pq import _DECODE_CHUNK, _pq_decode

    d, M = 32, 8
    cb = jnp.asarray(rng.randn(M, 256, d // M).astype(np.float32))
    ch = _DECODE_CHUNK
    for n in (257, ch, 2 * ch, 2 * ch + 777):
        codes = jnp.asarray(
            rng.randint(0, 256, size=(n, M)).astype(np.uint8))
        got = np.asarray(_pq_decode(codes, cb))
        ref = np.asarray(cb)[np.arange(M)[None, :],
                             np.asarray(codes, np.int32)].reshape(n, d)
        np.testing.assert_array_equal(got, ref)
