"""Tracing/profiling: timers + throughput counters (+ torch profiler hook).

Counterpart of ``vote_saver_tpu/utils/profiling.py``: ``Timer``,
``mpoints_per_s`` and ``mbutterflies_per_s`` unchanged; ``device_trace``
records a ``torch.profiler`` trace (host and, where there is a card, CUDA
activity) and exports it as a Chrome trace, where the JAX package takes a
``jax.profiler`` trace of the TPU.
"""

from __future__ import annotations

import contextlib
import time

from .logging import log_metric


class Timer:
    """with Timer("vote_phase") as t: ...; t.ms afterwards."""

    def __init__(self, name: str, items: int | None = None, unit: str = "items"):
        self.name, self.items, self.unit = name, items, unit
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1e3
        log_metric(f"{self.name}_ms", round(self.ms, 2))
        if self.items:
            rate = self.items / (self.ms / 1e3)
            log_metric(f"{self.name}_{self.unit}_per_s", round(rate, 2))
        return False

    @property
    def per_second(self) -> float:
        return (self.items or 0) / (self.ms / 1e3) if self.ms else 0.0


def mpoints_per_s(n_points: int, seconds: float) -> float:
    return n_points / seconds / 1e6


def mbutterflies_per_s(domain: int, seconds: float) -> float:
    return (domain // 2) * (domain.bit_length() - 1) / seconds / 1e6


@contextlib.contextmanager
def device_trace(path: str | None):
    """torch.profiler trace exported as a Chrome trace to `path` (no-op
    when path is None)."""
    if path is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path))
