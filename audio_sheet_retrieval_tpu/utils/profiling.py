"""Profiling / step-time instrumentation and the compile cache.

The reference's only telemetry is a 5-sample updates/sec running average in
the train progress bar (reference:utils/train_dcca_pool.py:216-231) and a
10-frame fps meter in the streaming server (audio_sheet_server.py:202-207).
This module adds JAX profiler traces (viewable in TensorBoard/XProf), a
lightweight step-time meter and the persistent compilation cache.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Mapping, Optional

import numpy as np

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ: Mapping[str, str], platform: str) -> str:
    """Where the persistent compilation cache lives: JAX's own
    ``JAX_COMPILATION_CACHE_DIR`` when set, else a fixed per-platform
    directory inside the checkout (a fixed path, so entries are found
    again by the next process)."""
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_DIR, ".jax_cache", platform))


def enable_compile_cache() -> Optional[str]:
    """Enable JAX's persistent compilation cache; call early in CLIs and
    benchmarks. Returns the directory, or None on the CPU backend.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX has already read it and
    nothing is set here. On the CPU backend the cache is not enabled:
    XLA:CPU AOT entries are checked against compile-machine features that
    include tuning pseudo-features no host reports, so every load warns of
    possible SIGILL; CPU runs recompile instead."""
    import jax

    platform = jax.default_backend()
    if platform == "cpu":
        return None
    cache_dir = compile_cache_dir(os.environ, platform)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a JAX profiler trace around a block of device work."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Running-average step timer (generalizes the reference 'ups' meter)."""

    def __init__(self, window: int = 5):
        self.times = np.zeros(window, np.float64)
        self.n = 0
        self._last: Optional[float] = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            self.times[:-1] = self.times[1:]
            self.times[-1] = now - self._last
            self.n += 1
        self._last = now
        return self.steps_per_sec

    @property
    def steps_per_sec(self) -> float:
        k = min(self.n, len(self.times))
        if k == 0:
            return 0.0
        return 1.0 / max(self.times[-k:].mean(), 1e-12)

    @property
    def mean_step_time(self) -> float:
        k = min(self.n, len(self.times))
        return float(self.times[-k:].mean()) if k else 0.0


def device_memory_stats() -> dict:
    """Per-device memory stats where the backend exposes them."""
    import jax

    out = {}
    for d in jax.devices():
        try:
            out[str(d)] = d.memory_stats()
        except Exception:
            out[str(d)] = None
    return out
