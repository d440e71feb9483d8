"""Profiling & tracing — first-class observability the reference lacks.

Counterpart of openpbso_tpu/runtime/profiling.py. The reference's only
runtime telemetry is the audio buffer-health ring (SURVEY.md section 5
'Tracing/profiling: none'). This package adds:

- :class:`BlockProfiler` — host-side per-block latency statistics against the
  real-time deadline (block_size / sample_rate), with a jitter histogram.
- :func:`device_trace` — context manager around ``torch.profiler.profile``
  that writes a Chrome trace of the host and, on a CUDA machine, the card
  (view with chrome://tracing or Perfetto).
- :class:`Timer` — tiny scoped wall-clock timer for host paths.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np


@dataclasses.dataclass
class BlockStats:
    count: int
    mean_ms: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    deadline_ms: float
    deadline_miss_rate: float
    rtf: float                      # realtime factor = deadline / mean


class BlockProfiler:
    """Per-block host latency tracker with deadline accounting."""

    def __init__(self, block_size: int, sample_rate: int,
                 capacity: int = 4096):
        self.deadline = block_size / sample_rate
        self._times = np.zeros(capacity, np.float64)
        self._n = 0
        self._cap = capacity
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._times[self._n % self._cap] = seconds
            self._n += 1

    def stats(self) -> BlockStats | None:
        with self._lock:
            n = min(self._n, self._cap)
            if n == 0:
                return None
            t = self._times[:n] * 1e3
        deadline_ms = self.deadline * 1e3
        mean = float(t.mean())
        return BlockStats(
            count=self._n,
            mean_ms=mean,
            p50_ms=float(np.percentile(t, 50)),
            p95_ms=float(np.percentile(t, 95)),
            p99_ms=float(np.percentile(t, 99)),
            max_ms=float(t.max()),
            deadline_ms=deadline_ms,
            deadline_miss_rate=float((t > deadline_ms).mean()),
            rtf=deadline_ms / mean if mean > 0 else float("inf"),
        )

    def jitter_histogram(self, bins: int = 20) -> tuple[np.ndarray,
                                                        np.ndarray]:
        with self._lock:
            n = min(self._n, self._cap)
            t = self._times[:n] * 1e3
        return np.histogram(t, bins=bins)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a trace of the enclosed work into ``logdir/trace.json``
    (Chrome trace format): host activity always, CUDA activity when a card
    is there. Yields the profiler, whose ``key_averages()`` can be read
    after the block ends."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
