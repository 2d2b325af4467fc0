"""SIFT-faithful synthetic corpus generator.

The primary bench corpus is a Gaussian mixture whose exact-ADC recall
ceiling at 16-byte codes is R@1 = 0.14 — far below the regime the
reference's paper reports on real SIFT1B (R@1 = 0.3-0.45 at the
run_sift1b.sh operating points). Real SIFT descriptors are not Gaussian:
they are 16 spatial cells x 8 orientation bins of non-negative gradient
energy with log-normal-ish magnitudes, L2-normalized, clipped at 0.2,
renormalized, and quantized to uint8 at a 512 scale (Lowe 2004 / the
bigann distribution readme). PQ residual error on that geometry is far
smaller relative to neighbor margins, which is what lifts the ceiling.

This generator reproduces that pipeline statistically:

1. Appearance classes: per class a [16, 8] log-normal cell x bin energy
   field with a dominant orientation per cell (circular von-Mises-like
   spread) and a radial cell-magnitude falloff.
2. A sample jitters its class field with multiplicative log-normal noise
   (``sigma`` controls intra-class tightness = the recall-ceiling knob)
   plus a small chance of orientation-bin shift (viewpoint rotation).
3. SIFT post-processing: L2-normalize, clip at 0.2, renormalize, scale
   by 512, clip to [0, 255], round -> uint8.

Queries are HELD OUT: drawn from the same generative process but never
inserted into the base set (the reference evaluates with disjoint query
files, test_ivfhnsw_sift1b.cpp:40-52).
"""

from __future__ import annotations

import numpy as np

D = 128
CELLS, BINS = 16, 8


class SiftLikeCorpus:
    """Deterministic streaming generator (same class field -> same bytes).

    sigma: intra-class multiplicative jitter (log scale). Calibrated on
    the exact-ADC ceiling at 16-byte codes (tools/siftlike_calibrate.py,
    512k vectors / nc=2048): sigma 0.35 -> ceiling@1 0.458, 0.55 -> 0.507,
    0.75 -> 0.500. Default 0.75 (the hardest measured point, nearest the
    paper's SIFT1B 0.3-0.45 band — ceilings compress further at the
    denser 2M bench corpus).
    """

    def __init__(self, n_classes: int = 65536, sigma: float = 0.75,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.sigma = float(sigma)
        self.n_classes = n_classes
        # Dominant orientation per (class, cell): a base direction per class
        # plus per-cell wobble, energy spread circularly around it.
        dom = rng.randint(0, BINS, size=(n_classes, 1))
        wob = rng.randint(-1, 2, size=(n_classes, CELLS))
        self._dom = ((dom + wob) % BINS).astype(np.int8)      # [ncls, 16]
        # Per-(class, cell) log-energy level: radial falloff (outer cells
        # weaker, as in real patches) + class-specific texture.
        ring = np.asarray([2, 1, 1, 2, 1, 0, 0, 1,
                           1, 0, 0, 1, 2, 1, 1, 2], np.float32)
        self._cell_log = (rng.randn(n_classes, CELLS).astype(np.float32)
                          * 0.9 - 0.45 * ring)
        # Circular orientation profile: energy decays away from dominant.
        self._prof = np.exp(-0.9 * np.minimum(np.arange(BINS),
                                              BINS - np.arange(BINS))
                            ).astype(np.float32)               # [8]

    def _fields(self, cls: np.ndarray, rng) -> np.ndarray:
        n = cls.shape[0]
        dom = self._dom[cls].astype(np.int32)                  # [n, 16]
        shift = (np.arange(BINS)[None, None, :]
                 - dom[:, :, None]) % BINS                     # [n, 16, 8]
        energy = self._prof[shift]                             # [n, 16, 8]
        energy = energy * np.exp(self._cell_log[cls])[:, :, None]
        jit = np.exp(rng.randn(n, CELLS, BINS).astype(np.float32)
                     * self.sigma)
        v = energy * jit
        # Empty bins: real SIFT histograms have no gradient mass in ~half
        # the (cell, bin) slots (zero fraction ~0.45 in bigann SIFT1M);
        # energies well below a cell's dominant response get no votes.
        v[v < 0.22 * v.max(axis=2, keepdims=True)] = 0.0
        return v.astype(np.float32)

    def batch(self, n: int, seed: int) -> np.ndarray:
        """n SIFT-like uint8 descriptors as float32 [n, 128] (the drivers
        promote uint8 .bvecs to f32 the same way, utils.h:112-127)."""
        rng = np.random.RandomState(seed)
        cls = rng.randint(0, self.n_classes, n)
        v = self._fields(cls, rng).reshape(n, D)
        # SIFT post-processing: normalize -> clip 0.2 -> renormalize ->
        # x512 -> uint8.
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        v = np.minimum(v, 0.2)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        q = np.clip(np.floor(v * 512.0), 0, 255).astype(np.uint8)
        return q.astype(np.float32)


class SiftLikeDeviceGen:
    """Device-side port of SiftLikeCorpus's generative process (jax PRNG).

    Same statistical pipeline — per-class cell x orientation-bin energy
    fields with a circular profile around a dominant orientation,
    log-normal intra-class jitter, empty-bin thresholding, and the SIFT
    normalize/clip/renormalize/x512/uint8 post-processing — but generated
    ON the accelerator, so a 134M-vector canonical-geometry corpus streams
    at device rate instead of pushing ~68 GB of host numpy to the device
    (the same reason bench.make_scale3_gen generates on device).
    Not bit-identical to the numpy class (different PRNG); only the
    statistics matter, and the exact-ADC recall ceiling is re-calibrated
    at the stage's own geometry (tools/siftlike_scale_calibrate.py).

    Deterministic per (seed, batch key): the same key always regenerates
    identical bytes, so resumed streaming builds are reproducible
    (reference evaluates on fixed files, test_ivfhnsw_sift1b.cpp:40-52).

    Class tables are jit ARGUMENTS, not closure constants: a captured
    ~320 MB constant (n_classes=2^22) would be embedded in the compiled
    program (the scale3 lesson, bench.py make_scale3_gen)."""

    def __init__(self, n_classes: int = 1 << 22, sigma: float = 0.75,
                 seed: int = 0, skew: float = 1.0):
        import functools
        import jax
        import jax.numpy as jnp
        import jax.random as jr

        self.n_classes = int(n_classes)
        self.sigma = float(sigma)
        # Class-popularity skew: cls = floor(ncls * u^skew), u~U(0,1).
        # skew=1 is uniform; skew>1 concentrates mass on low class ids
        # (density ~ c^(1/skew - 1), Zipf-like), mimicking real SIFT's
        # bursty near-duplicate patches. MEASURED INSENSITIVE to the
        # exact-ADC ceiling at canonical density (skew 3/5 -> ceiling@1
        # 0.98/0.97, same as uniform's 0.96-0.98 across n_classes
        # 2^18-2^21 at nb=8M nc=2^16; the ceiling is set by nb/nc, see
        # tools/siftlike_scale_calibrate.py, 2026-08-19). Kept as a
        # distribution-realism knob, default uniform.
        self.skew = float(skew)
        kd, kw, kc = jr.split(jr.PRNGKey(seed), 3)
        dom = jr.randint(kd, (self.n_classes, 1), 0, BINS)
        wob = jr.randint(kw, (self.n_classes, CELLS), -1, 2)
        ring = jnp.asarray([2, 1, 1, 2, 1, 0, 0, 1,
                            1, 0, 0, 1, 2, 1, 1, 2], jnp.float32)
        self._state = {
            "dom": ((dom + wob) % BINS).astype(jnp.int8),
            "cell_log": (jr.normal(kc, (self.n_classes, CELLS), jnp.float32)
                         * 0.9 - 0.45 * ring),
        }
        self._prof = jnp.exp(
            -0.9 * jnp.minimum(jnp.arange(BINS), BINS - jnp.arange(BINS))
        ).astype(jnp.float32)

        @functools.partial(jax.jit, static_argnames="n")
        def _gen(dom_t, cell_log_t, key, n):
            kc_, kj_ = jr.split(key)
            if self.skew != 1.0:
                u = jr.uniform(kc_, (n,), jnp.float32)
                cls = jnp.clip((u ** self.skew
                                * self.n_classes).astype(jnp.int32),
                               0, self.n_classes - 1)
            else:
                cls = jr.randint(kc_, (n,), 0, self.n_classes)
            domb = dom_t[cls].astype(jnp.int32)               # [n, 16]
            shift = (jnp.arange(BINS)[None, None, :]
                     - domb[:, :, None]) % BINS               # [n, 16, 8]
            energy = (self._prof[shift]
                      * jnp.exp(cell_log_t[cls])[:, :, None])
            jit_ = jnp.exp(jr.normal(kj_, (n, CELLS, BINS), jnp.float32)
                           * self.sigma)
            v = energy * jit_
            v = jnp.where(v < 0.22 * v.max(axis=2, keepdims=True), 0.0, v)
            v = v.reshape(n, D)
            v = v / (jnp.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
            v = jnp.minimum(v, 0.2)
            v = v / (jnp.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
            return jnp.clip(jnp.floor(v * 512.0), 0.0, 255.0)

        self._gen = _gen

    def batch_device(self, key, n: int):
        """n SIFT-like uint8-grid descriptors as a DEVICE f32 [n, 128]."""
        return self._gen(self._state["dom"], self._state["cell_log"],
                         key, n)

    def release(self) -> None:
        """Free the device-resident class tables (~320 MB at 2^22)."""
        self._state["dom"] = None
        self._state["cell_log"] = None
