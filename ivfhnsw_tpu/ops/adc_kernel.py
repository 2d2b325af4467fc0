"""Fused ADC posting-list scan for the GPU: a Pallas kernel on the Triton
route.

The XLA path (ops.adc) gathers a ``[B, L, M]`` uint8 window out of the
code store, widens it to int32, transposes it and gathers a ``[B, M, L]``
f32 array from the LUTs before it reduces — every code is written and
re-read several times. This kernel reads each scanned code's ``M + 1``
bytes (PQ code + norm code) once, straight from the canonical
``[N, M]`` store (``PostingListStore.codes_d``), and writes one f32
distance per code.

Schedule. A probed posting list is a contiguous run of rows of the store
(``list_offsets``). In XLA, each query's probes are cut into fixed slots of
``block`` rows: (first row, length <= block, term1 bias) per slot, with the
reference's ``max_codes`` semantics (probes in ascending coarse distance,
stop after the list that crosses the budget — IndexIVF_HNSW.cpp:290-292,
the same rule as :func:`ivfhnsw_tpu.ops.adc.probe_positions`).

Kernel. Grid (query, slot). Each program loads its ``[block, M]`` run of
codes and ``[block]`` norm codes under a row mask, looks the codes up in
the query's ``[M, ksub]`` LUT (``-2 * <q_m, codebook_m>``, folded in XLA)
through a ref load with integer-array indices — the Triton lowering turns
that into a pointer gather — adds the decoded norm and the slot's bias,
masks the tail with +inf and stores ``block`` distances.

Top-k over the ``[B, slots * block]`` distances runs in XLA
(``lax.top_k``), and the k winners' ids are gathered from the store.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ivfhnsw_tpu.ops.adc import adc_scan, select_probes
from ivfhnsw_tpu.ops.pq import _pq_ip_luts
from ivfhnsw_tpu.ops.topk import topk_smallest

BLOCK = 256           # rows of the store per scan slot (a power of two)
ENGINES = ("auto", "xla", "pallas", "pallas_interpret")


def kernel_supports(m: int) -> bool:
    """The Triton route needs power-of-two tensor sizes: M in {1..64}."""
    return 0 < m <= 64 and m & (m - 1) == 0


def resolve_engine(engine: str, m: int) -> str:
    """Map a user engine name to the one that runs.

    "auto" is the kernel on the GPU (for power-of-two code sizes) and the
    XLA path elsewhere. "pallas" compiles the kernel for the GPU and raises
    on any other platform instead of falling back; "pallas_interpret" runs
    the same kernel through the Pallas interpreter (CPU testing)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         + "/".join(ENGINES))
    gpu = jax.default_backend() == "gpu"
    if engine == "auto":
        return "pallas" if gpu and kernel_supports(m) else "xla"
    if engine.startswith("pallas") and not kernel_supports(m):
        raise ValueError(f"the scan kernel needs a power-of-two code size "
                         f"(M <= 64), got M={m}; use engine='xla'")
    if engine == "pallas" and not gpu:
        raise ValueError(
            "engine='pallas' compiles the scan kernel for the GPU, and the "
            f"default backend is {jax.default_backend()!r}; use engine='xla' "
            "or engine='pallas_interpret'")
    return engine


def n_slots_for(max_codes: int, max_list: int, nprobe: int,
                scan_budget: int | None = None, block: int = BLOCK) -> int:
    """Static slot count per query. Worst case under the budget: the
    included probes hold at most max_codes + max_list codes, and each
    probe wastes at most one partial slot; without a budget, nprobe full
    longest lists. ``scan_budget`` (lanes) caps it: slots past the cap drop
    the farthest probes' tails."""
    if max_codes > 0:
        n = (max_codes + max_list) // block + nprobe + 1
    else:
        n = nprobe * max(1, -(-max_list // block))
    if scan_budget is not None:
        n = min(n, -(-scan_budget // block))
    return max(n, 1)


def budget_sizes(sizes, max_codes):
    """[B, P] list sizes in probe order -> sizes of the probes the
    max_codes budget admits (0 for the rest)."""
    cum_before = jnp.cumsum(sizes, axis=1) - sizes
    included = jnp.logical_or(max_codes <= 0, cum_before < max_codes)
    return jnp.where(included, sizes, 0)


def slot_schedule(row_start, sizes, term1, *, n_slots: int,
                  block: int = BLOCK):
    """Cut per-probe contiguous runs into fixed slots.

    row_start, sizes, term1: [B, P] — first store row, number of rows to
    scan (already budget-masked; 0 = skipped) and term1 of each probe.
    Returns (start [B, n_slots] i32, length [B, n_slots] i32 (<= block),
    bias [B, n_slots] f32); unused slots have length 0."""
    P = sizes.shape[1]
    nblk = (sizes + block - 1) // block                        # [B, P]
    bounds = jnp.cumsum(nblk, axis=1)
    first = bounds - nblk
    j = jnp.arange(n_slots, dtype=jnp.int32)
    p = jax.vmap(lambda b: jnp.searchsorted(b, j, side="right"))(bounds)
    p = jnp.minimum(p.astype(jnp.int32), P - 1)                # [B, S]
    take = lambda a: jnp.take_along_axis(a, p, axis=1)
    within = (j[None, :] - take(first)) * block
    valid = j[None, :] < bounds[:, -1:]
    start = take(row_start).astype(jnp.int32) + within
    length = jnp.clip(take(sizes) - within, 0, block)
    return (jnp.where(valid, start, 0).astype(jnp.int32),
            jnp.where(valid, length, 0).astype(jnp.int32),
            jnp.where(valid, take(term1), 0.0))


def _scan_kernel(start_ref, len_ref, bias_ref, codes_ref, ncodes_ref,
                 lut_ref, ntab_ref, out_ref, *, block: int, m: int):
    b = pl.program_id(0)
    s = pl.program_id(1)
    start = start_ref[b, s]
    length = len_ref[b, s]
    row = jnp.arange(block, dtype=jnp.int32)
    live = row < length
    codes = plgpu.load(codes_ref.at[pl.ds(start, block), :],
                       mask=live[:, None], other=0).astype(jnp.int32)
    sub = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32)[None, :],
                           (block, m))
    term3 = jnp.sum(lut_ref[b, sub, codes], axis=1)            # [block]
    ncode = plgpu.load(ncodes_ref.at[pl.ds(start, block)], mask=live,
                       other=0).astype(jnp.int32)
    dist = bias_ref[b, s] + ntab_ref[ncode] + term3
    out_ref[...] = jnp.where(live, dist, jnp.inf)


@functools.partial(jax.jit, static_argnames=("block", "interpret"))
def adc_block_scan(luts, norm_table, codes, norm_codes, start, length, bias,
                   *, block: int = BLOCK, interpret: bool = False):
    """Distances of every scheduled row.

    luts [B, M, ksub] f32 — folded term3 tables (-2 * inner product);
    norm_table [ksub_norm] f32 — norm-code decode table; codes [N, M] u8,
    norm_codes [N] u8 — the canonical store; start/length/bias
    [B, S] — the slot schedule. Returns [B, S * block] f32, +inf on rows
    past each slot's length."""
    B, S = start.shape
    m = codes.shape[1]
    if not kernel_supports(m):
        raise ValueError(f"scan kernel needs a power-of-two M, got {m}")
    out = pl.pallas_call(
        functools.partial(_scan_kernel, block=block, m=m),
        grid=(B, S),
        in_specs=[pl.no_block_spec] * 7,
        out_specs=pl.BlockSpec((None, None, block), lambda b, s: (b, s, 0)),
        out_shape=jax.ShapeDtypeStruct((B, S, block), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ivf_adc_block_scan",
    )(start, length, bias, codes, norm_codes, luts, norm_table)
    return out.reshape(B, S * block)


def reference_topk(luts, norm_table, codes, norm_codes, ids, start, length,
                   bias, k: int, block: int = BLOCK):
    """Top-k of the rows a slot schedule covers, by the XLA scan
    (:func:`ivfhnsw_tpu.ops.adc.adc_scan`) — the kernel's reference.

    luts are the plain inner-product tables (adc_scan applies the -2); the
    rest is :func:`adc_block_scan`'s input. Returns (dists [B, k], labels
    [B, k]) like :func:`scan_topk`."""
    B, S = start.shape
    lane = jnp.arange(block, dtype=jnp.int32)
    valid = (lane[None, None, :] < length[:, :, None]).reshape(B, S * block)
    rows = jnp.where(valid, (start[:, :, None] + lane).reshape(B, S * block),
                     0)
    g_bias = (jnp.repeat(bias, block, axis=1)
              + jnp.take(norm_table,
                         jnp.take(norm_codes, rows).astype(jnp.int32)))
    best, sel = adc_scan(luts, jnp.take(codes, rows, axis=0), g_bias, valid,
                         k)
    labels = jnp.take(ids, jnp.take_along_axis(rows, sel, axis=1))
    return best, jnp.where(jnp.isfinite(best), labels, -1)


def scan_topk(dists, start, ids, k: int, block: int = BLOCK):
    """Top-k of the kernel's distances and the ids of the winning rows."""
    best, sel = topk_smallest(dists, k)
    rows = (jnp.take_along_axis(start, sel // block, axis=1) + sel % block)
    labels = jnp.take(ids, rows, axis=0)
    return best, jnp.where(jnp.isfinite(best), labels, -1)


@functools.partial(
    jax.jit,
    static_argnames=("nprobe", "k", "n_slots", "coarse_block", "use_opq",
                     "interpret", "coarse_approx", "coarse_recall",
                     "routed_w"))
def kernel_search_core(queries, centroids, centroid_norms, codebooks,
                       norm_centroids, R, codes, ids, norm_codes,
                       list_offsets, max_codes, routed=None, *, nprobe: int,
                       k: int, n_slots: int, coarse_block: int,
                       use_opq: bool, interpret: bool = False,
                       coarse_approx=False, coarse_recall: float = 0.95,
                       routed_w: int = 0):
    """End-to-end IVFADC search step on the kernel engine: coarse probe
    selection (ops.adc.select_probes), LUTs, slot schedule, kernel scan and
    top-k in one program."""
    hp = jax.lax.Precision.HIGHEST
    with jax.named_scope("coarse"):
        _, probes, term1 = select_probes(
            queries, centroids, centroid_norms, nprobe=nprobe,
            coarse_block=coarse_block, coarse_approx=coarse_approx,
            coarse_recall=coarse_recall, routed=routed, routed_w=routed_w)
    with jax.named_scope("schedule"):
        row_start = jnp.take(list_offsets, probes, axis=0)
        sizes = jnp.take(list_offsets, probes + 1, axis=0) - row_start
        start, length, bias = slot_schedule(
            row_start, budget_sizes(sizes, max_codes), term1,
            n_slots=n_slots)
    with jax.named_scope("luts"):
        q_rot = queries @ R.T if use_opq else queries
        luts = -2.0 * _pq_ip_luts(q_rot, codebooks, precision=hp)
    dists = adc_block_scan(luts, norm_centroids, codes, norm_codes, start,
                           length, bias, interpret=interpret)
    with jax.named_scope("topk"):
        return scan_topk(dists, start, ids, k)
