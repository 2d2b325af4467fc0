"""Sharded index-build step: data-parallel assign + PQ-encode over a mesh.

This is the accelerator analog of the reference's OpenMP `assign` sweep plus the
add_batch encode pipeline (IndexIVF_HNSW.cpp:68-72, :75-138) at pod scale:
base-vector batches are sharded over the mesh (data parallel); the centroid
table is sharded by range and all-gathered fsdp-style for the local top-1
sweep; codes come back sharded by batch. One step of this, streamed over a
1B-vector corpus, is the "assign + encode in hours" path (BASELINE.md north
star). The streaming orchestrator around it lives in
:mod:`ivfhnsw_tpu.parallel.pipeline`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ivfhnsw_tpu.ops.distances import assign_top1
from ivfhnsw_tpu.parallel.mesh import SHARD_AXIS

HIGHEST = jax.lax.Precision.HIGHEST


def make_assign_encode_step(mesh, coarse_block: int = 16384,
                            precision=HIGHEST, use_opq: bool = False):
    """Returns a jitted step mirroring IVFADCIndex._encode_batch
    (IndexIVF_HNSW.cpp:87-121) exactly — residual -> [OPQ rotate] -> PQ ->
    decode -> [unrotate] -> reconstruct -> norm-PQ code:

        (x [B, d] sharded-by-batch,
         centroids [D, nc_loc, d] sharded,
         codebooks [M, ksub, dsub] replicated,
         R [d, d] replicated OPQ rotation (pass zeros((0,0)) if not use_opq),
         norm_centroids [ksub] replicated norm-PQ codebook)
      -> (keys [B] int32, codes [B, M] uint8, norm_codes [B] uint8)
    with B sharded over the mesh. The norm codes quantize RECONSTRUCTION
    norms ||decode(code) + centroid||^2 (the quantity term-2 of the ADC
    decomposition needs), not residual norms.
    """

    def fn(x, centroids, codebooks, R, norm_centroids):
        from ivfhnsw_tpu.ops.pq import _pq_decode, _pq_encode

        cents = jax.lax.all_gather(centroids[0], SHARD_AXIS,
                                   tiled=True)            # [nc, d]
        _, keys = assign_top1(x, cents, block=coarse_block,
                              precision=precision)
        c = cents[keys]
        residuals = x - c
        r_rot = residuals @ R.T if use_opq else residuals
        codes = _pq_encode(r_rot, codebooks, precision=precision)
        decoded = _pq_decode(codes, codebooks)
        if use_opq:
            decoded = decoded @ R
        recon = decoded + c
        norms = jnp.sum(recon ** 2, axis=1)
        norm_codes = jnp.argmin(
            jnp.abs(norms[:, None] - norm_centroids[None, :]),
            axis=1).astype(jnp.uint8)
        return keys.astype(jnp.int32), codes, norm_codes

    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(), P(), P()),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False)
    return jax.jit(mapped)
