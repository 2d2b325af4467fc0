"""Tracing / profiling utilities (SURVEY.md §5 aux-subsystem parity).

The reference's observability is StopW timers, a dist_calc counter, and
compile-time trace macros writing centroid logs (IndexIVF_HNSW.cpp:298-326).
Here:

- :class:`StageTimer` — named stage timing with a report, the structured
  version of the drivers' progress prints;
- :func:`device_trace` — context manager around jax.profiler for XLA device
  traces viewable in TensorBoard/Perfetto;
- :class:`Counters` — the dist_calc analog: explicit counts carried as
  search outputs (codes scanned, lists probed) accumulate here.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{name:28s} {self.totals[name]:9.3f}s  x{self.counts[name]}"
                 for name in sorted(self.totals, key=self.totals.get,
                                    reverse=True)]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a JAX device profile (device trace) for the enclosed block."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Counters:
    """Accumulating counters (dist_calc analog, hnswalg.h:58)."""

    def __init__(self):
        self.values = defaultdict(int)

    def add(self, name: str, n: int) -> None:
        self.values[name] += int(n)

    def __getitem__(self, name: str) -> int:
        return self.values[name]

    def report(self) -> dict:
        return dict(self.values)
