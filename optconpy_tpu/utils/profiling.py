"""Tracing/profiling harness (SURVEY.md SS5.1).

The reference prints wall-clock at most; here: jax.profiler trace
capture around any block (open the dump with TensorBoard or Perfetto),
plus simple wall-clock section timing that materializes device
results."""
from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np


@contextmanager
def trace(logdir: str | Path = "data/profile"):
    """Capture a jax.profiler trace of the enclosed block."""
    import jax

    Path(logdir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class SectionTimer:
    """Accumulating named section timer with device materialization."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def section(self, name: str, result=None):
        t0 = time.time()
        yield
        if result is not None:
            np.asarray(result)  # hard barrier
        dt = time.time() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k]}
            for k, v in sorted(
                self.totals.items(), key=lambda kv: -kv[1]
            )
        }
