"""Tracing and timing (counterpart of danerf_tpu/utils/profiling.py).

- ``trace`` wraps a region in a ``torch.profiler`` run over the CPU and,
  where there is one, the card, and writes a Chrome trace into its
  directory (open it in chrome://tracing or Perfetto);
- ``timeit`` waits for the device before it reads the clock: PyTorch
  returns before the card finishes, so a host clock alone measures the
  enqueue;
- ``ThroughputMeter`` tracks rays/s over a sliding window.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str = "danerf-trace"):
    """Profile the with-block; on exit write ``trace_<time>_<pid>.json``
    into ``log_dir``.  Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _sync() -> None:
    """Wait for the card's queued work (the counterpart of ``_force``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, iters: int = 20, warmup: int = 5, **kw) -> float:
    """Mean seconds per call of ``fn(*args, **kw)``, the device synchronised
    before each clock read."""
    for _ in range(warmup):
        fn(*args, **kw)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    _sync()
    return (time.perf_counter() - t0) / iters


class ThroughputMeter:
    """Sliding-window rays/sec counter for training loops."""

    def __init__(self, window: int = 100):
        self.window = window
        self._events: list[tuple[float, int]] = []

    def update(self, n_rays: int):
        self._events.append((time.perf_counter(), n_rays))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def rays_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        rays = sum(n for _, n in self._events[1:])
        return rays / max(dt, 1e-9)
