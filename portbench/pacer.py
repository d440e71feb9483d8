"""The benchmark's audio device: a sink that plays blocks at the audio rate.

A frozen copy of openpbso_tpu_torch/runtime/audio.py::RealTimePacerSink.
Each ``write`` is one block handed to the device; it returns once that
block starts to play, so the next block is due one block later. A block
written after its due time is late: it counts, and the device's clock
restarts from it (an underrun, heard as a gap).
"""
from __future__ import annotations

import time


class PacedSink:
    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self._next_deadline: float | None = None
        self.late_blocks = 0
        self.total_blocks = 0
        self.closed = False

    def write(self, block) -> bool:
        now = time.perf_counter()
        if self._next_deadline is None:
            self._next_deadline = now
        on_time = now <= self._next_deadline + 1e-4
        self.total_blocks += 1
        if not on_time:
            self.late_blocks += 1
            self._next_deadline = now
        self._next_deadline += block.shape[0] / self.sample_rate
        sleep = (self._next_deadline - time.perf_counter()
                 - block.shape[0] / self.sample_rate)
        if sleep > 0:
            time.sleep(sleep)
        return on_time

    def close(self) -> None:
        self.closed = True
