"""Audio sinks — where synthesized blocks leave the engine.

Counterpart of openpbso_tpu/runtime/audio.py, numpy only: the engine hands
every sink host blocks. The reference pushes blocks to a PortAudio callback
(real_time_modal_sound.cpp:192-212, 542-553). Here a sink is anything with
``write(block) -> bool`` (False = this block was an underrun replacement) and
``close()``:

- :class:`WavFileSink` — offline render target (16-bit PCM stereo).
- :class:`RawCollectorSink` — in-memory capture for tests/benchmarks.
- :class:`RealTimePacerSink` — consumes blocks at wall-clock audio rate,
  emulating an audio device for latency testing without sound hardware.
- :class:`SoundDeviceSink` — real playback via the ``sounddevice`` package if
  present (gated import; the environment may not ship it).
"""
from __future__ import annotations

import time
import wave

import numpy as np

from ..config import SAMPLE_RATE


class WavFileSink:
    def __init__(self, path: str, sample_rate: int = SAMPLE_RATE,
                 normalize: bool = False, channels: int = 2):
        self._wave = wave.open(path, "wb")
        self._wave.setnchannels(channels)
        self._wave.setsampwidth(2)
        self._wave.setframerate(sample_rate)
        self._normalize = normalize
        self._chunks: list[np.ndarray] = []

    def write(self, block: np.ndarray) -> bool:
        if self._normalize:
            self._chunks.append(np.asarray(block, np.float32))
        else:
            pcm = np.clip(np.asarray(block), -1.0, 1.0)
            self._wave.writeframes((pcm * 32767).astype("<i2").tobytes())
        return True

    def close(self) -> None:
        if self._normalize and self._chunks:
            full = np.concatenate(self._chunks, axis=0)
            peak = np.abs(full).max()
            if peak > 0:
                full = full / peak * 0.9
            self._wave.writeframes((full * 32767).astype("<i2").tobytes())
        self._wave.close()


class RawCollectorSink:
    def __init__(self):
        self.blocks: list[np.ndarray] = []

    def write(self, block: np.ndarray) -> bool:
        self.blocks.append(np.asarray(block))
        return True

    def concatenated(self) -> np.ndarray:
        return (np.concatenate(self.blocks, axis=0) if self.blocks
                else np.zeros((0, 2), np.float32))

    def close(self) -> None:
        pass


class RealTimePacerSink:
    """Consumes at real-time rate; tracks deadline misses like the
    buffer-health ring (real_time_modal_sound.cpp:203-206)."""

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        self.sample_rate = sample_rate
        self._next_deadline: float | None = None
        self.late_blocks = 0
        self.total_blocks = 0

    def write(self, block: np.ndarray) -> bool:
        now = time.perf_counter()
        if self._next_deadline is None:
            self._next_deadline = now
        on_time = now <= self._next_deadline + 1e-4
        self.total_blocks += 1
        if not on_time:
            self.late_blocks += 1
            self._next_deadline = now
        self._next_deadline += block.shape[0] / self.sample_rate
        sleep = self._next_deadline - time.perf_counter() \
            - block.shape[0] / self.sample_rate
        if sleep > 0:
            time.sleep(sleep)
        return on_time

    def close(self) -> None:
        pass


class SoundDeviceSink:
    """Real audio output via sounddevice, if installed."""

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        try:
            import sounddevice  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "sounddevice is not available in this environment; use "
                "WavFileSink or RealTimePacerSink") from e
        import sounddevice as sd
        self._stream = sd.OutputStream(samplerate=sample_rate, channels=2,
                                       dtype="float32")
        self._stream.start()

    def write(self, block: np.ndarray) -> bool:
        self._stream.write(np.ascontiguousarray(block, np.float32))
        return True

    def close(self) -> None:
        self._stream.stop()
        self._stream.close()
