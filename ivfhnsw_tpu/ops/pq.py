"""Product quantizer and 1-byte norm quantizer, batched XLA.

Replaces the faiss primitives the reference leans on
(faiss::ProductQuantizer train/compute_codes/decode and the per-query
compute_inner_prod_table at IndexIVF_HNSW.cpp:98,102,262, plus the
norm_pq = ProductQuantizer(1, 1, 8) used for 1-byte norm codes).

All per-subspace problems are batched along a leading M axis so encode is
one [n, M, dsub] x [M, ksub, dsub] batched distance computation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ivfhnsw_tpu.ops.kmeans import kmeans_batched


@functools.partial(jax.jit, static_argnames=("precision",))
def _pq_encode(x, codebooks, precision=jax.lax.Precision.HIGHEST):
    """x [n, d], codebooks [M, ksub, dsub] -> codes [n, M] uint8."""
    n, d = x.shape
    M, ksub, dsub = codebooks.shape
    xs = x.reshape(n, M, dsub).transpose(1, 0, 2)            # [M, n, dsub]
    ip = jax.lax.dot_general(
        xs, codebooks,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),      # [M, n, ksub]
        preferred_element_type=jnp.float32, precision=precision)
    cb_sq = jnp.sum(codebooks.astype(jnp.float32) ** 2, axis=-1)  # [M, ksub]
    dists = cb_sq[:, None, :] - 2.0 * ip                     # + ||x||^2 (const per row)
    codes = jnp.argmin(dists, axis=-1).astype(jnp.uint8)     # [M, n]
    return codes.T


_DECODE_CHUNK = 65536


@jax.jit
def _pq_decode(codes, codebooks):
    """codes [n, M] uint8 -> [n, d] f32.

    Chunking the gather with lax.map bounds the [n, M, dsub] temp the
    one-shot gather would materialize (a backend may pad its short
    trailing dsub axis) to _DECODE_CHUNK rows regardless of n.
    """
    n, M = codes.shape
    _, _, dsub = codebooks.shape
    midx = jnp.arange(M)[None, :]

    def gather(c):
        g = codebooks[midx, c.astype(jnp.int32)]
        return g.reshape(c.shape[0], M * dsub)

    ch = _DECODE_CHUNK
    if n <= ch:
        return gather(codes)
    main, tail = (n // ch) * ch, n % ch
    out = jax.lax.map(gather, codes[:main].reshape(main // ch, ch, M))
    out = out.reshape(main, M * dsub)
    if tail:
        out = jnp.concatenate([out, gather(codes[main:])], axis=0)
    return out


@functools.partial(jax.jit, static_argnames=("precision",))
def _pq_ip_luts(q, codebooks, precision=jax.lax.Precision.HIGHEST):
    """Per-query inner-product LUTs: q [B, d] -> [B, M, ksub] f32.

    LUT[b, m, k] = <q_b restricted to subspace m, codebook[m, k]>
    (compute_inner_prod_table equivalent, IndexIVF_HNSW.cpp:262).
    """
    B, d = q.shape
    M, ksub, dsub = codebooks.shape
    # Block-diagonal flattening turns the M tiny-contraction (dsub=8) einsums
    # into ONE [B, d] @ [d, M*ksub] matmul instead of M matmuls with an
    # 8-deep contraction each.
    blk = jnp.einsum("mkd,mn->mknd", codebooks,
                     jnp.eye(M, dtype=codebooks.dtype))
    cb_flat = blk.reshape(M * ksub, M * dsub)
    return jax.lax.dot_general(
        q, cb_flat, dimension_numbers=(((1,), (1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32).reshape(B, M, ksub)


class ProductQuantizer:
    """M-subquantizer, 8-bit product quantizer (ksub=256).

    Capability parity with faiss::ProductQuantizer as used by the reference:
    train (k-means per subspace), compute_codes (encode), decode,
    compute_inner_prod_table (ip_luts), and file IO.
    """

    def __init__(self, d: int, M: int, ksub: int = 256):
        if d % M != 0:
            raise ValueError(f"d={d} not divisible by M={M}")
        self.d, self.M, self.ksub = d, M, ksub
        self.dsub = d // M
        self.codebooks: jax.Array | None = None  # [M, ksub, dsub]

    def train(self, key, data, niter: int = 25, init=None):
        """data [n, d]: k-means per subspace, all M subspaces batched."""
        data = jnp.asarray(data, jnp.float32)
        n = data.shape[0]
        sub = data.reshape(n, self.M, self.dsub).transpose(1, 0, 2)
        self.codebooks = kmeans_batched(key, sub, self.ksub, niter=niter,
                                        init=init)
        return self

    def encode(self, x) -> jax.Array:
        return _pq_encode(jnp.asarray(x, jnp.float32), self.codebooks)

    def decode(self, codes) -> jax.Array:
        return _pq_decode(jnp.asarray(codes), self.codebooks)

    def ip_luts(self, q, precision=None) -> jax.Array:
        return _pq_ip_luts(jnp.asarray(q, jnp.float32), self.codebooks,
                           precision=precision)

    # -- IO: faiss write_ProductQuantizer byte layout, so .pq artifacts
    # interchange with the reference (test_ivfhnsw_sift1b.cpp:57-89);
    # load() also sniffs the round-1 legacy header for old caches. --

    def save(self, path: str) -> None:
        from ivfhnsw_tpu.utils import faiss_io
        faiss_io.write_product_quantizer(path, self.codebooks)

    @classmethod
    def load(cls, path: str) -> "ProductQuantizer":
        from ivfhnsw_tpu.utils import faiss_io
        if faiss_io.is_faiss_pq(path):
            cb = faiss_io.read_product_quantizer(path)
            M, ksub, dsub = cb.shape
            pq = cls(M * dsub, M, ksub)
        else:  # legacy [u32 d | u32 M | u32 ksub | f32 blob]
            with open(path, "rb") as f:
                d, M, ksub = (int(v) for v in np.fromfile(f, "<u4", 3))
                pq = cls(d, M, ksub)
                cb = np.fromfile(f, "<f4",
                                 M * ksub * (d // M)).reshape(M, ksub, d // M)
        pq.codebooks = jnp.asarray(cb)
        return pq


class NormQuantizer:
    """1-byte scalar quantizer for L2-squared norms — the reference's
    norm_pq = faiss::ProductQuantizer(1, 1, 8) (IndexIVF_HNSW.cpp:14,
    decode at :280)."""

    def __init__(self, ksub: int = 256):
        self.ksub = ksub
        self.centroids: jax.Array | None = None  # [ksub] f32, ascending

    def train(self, key, norms, niter: int = 25):
        norms = jnp.asarray(norms, jnp.float32).reshape(1, -1, 1)
        cents = kmeans_batched(key, norms, self.ksub, niter=niter)
        # Sort so codes are monotone in norm (nice for debugging; decode is
        # gather either way).
        self.centroids = jnp.sort(cents.reshape(self.ksub))
        return self

    def encode(self, norms) -> jax.Array:
        norms = jnp.asarray(norms, jnp.float32)
        d = jnp.abs(norms[:, None] - self.centroids[None, :])
        return jnp.argmin(d, axis=1).astype(jnp.uint8)

    def decode(self, codes) -> jax.Array:
        return self.centroids[jnp.asarray(codes, jnp.int32)]

    def save(self, path: str) -> None:
        """faiss layout: the reference's norm quantizer is a
        ProductQuantizer(1, 1, 8), i.e. d=M=1, nbits=8, 256 centroids."""
        from ivfhnsw_tpu.utils import faiss_io
        faiss_io.write_product_quantizer(
            path, np.asarray(self.centroids, np.float32).reshape(1, -1, 1))

    @classmethod
    def load(cls, path: str) -> "NormQuantizer":
        from ivfhnsw_tpu.utils import faiss_io
        if faiss_io.is_faiss_pq(path):
            cb = faiss_io.read_product_quantizer(path)
            nq = cls(cb.shape[1])
            nq.centroids = jnp.sort(jnp.asarray(cb.reshape(-1)))
        else:  # legacy [u32 ksub | f32 blob]
            with open(path, "rb") as f:
                ksub = int(np.fromfile(f, "<u4", 1)[0])
                nq = cls(ksub)
                nq.centroids = jnp.asarray(np.fromfile(f, "<f4", ksub))
        return nq
