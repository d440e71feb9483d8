"""Profiling & tracing — first-class observability the reference lacks.

Counterpart of openpbso_tpu/runtime/profiling.py. The reference's only
runtime telemetry is the audio buffer-health ring (SURVEY.md section 5
'Tracing/profiling: none'). This package adds:

- the **span log**: the program's own spans (the engine's dispatch, event
  application, enqueue and copy wait; the session's span dispatches,
  table builds, FFAT lookups and interaural phases; the bake and its
  scheduling), recorded while a
  ``torch.profiler`` session records in the process and only then, on the
  clock the profiler stamps its events with (``time.time_ns``). Sites call
  :func:`begin` and :func:`end`; readers take :func:`spans` and
  :func:`overwritten`.
- :class:`BlockProfiler` — host-side dispatch latency statistics against
  the real-time deadline (blocks x block_size / sample_rate).
- :func:`device_trace` — context manager around ``torch.profiler.profile``
  that writes a Chrome trace of the host and, on a CUDA machine, the card,
  with the program's spans as a host track beside them (view with
  chrome://tracing or Perfetto).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import struct
import threading
import time

import numpy as np
# whether a torch.profiler session records in this process: the flag
# profile() sets on start and clears on stop, read alike by every thread
# (torch's C-level query reads False on threads started after it)
import torch.autograd.profiler as _flag

# the spans the program records, by id; each site's counters, by name
NAMES = ("engine.dispatch", "engine.apply", "engine.synth", "engine.copy",
         "session.span", "session.tables", "bake", "bake.schedule",
         "session.lookup", "session.itd")
(DISPATCH, APPLY, SYNTH, COPY, SPAN, TABLES, BAKE, SCHEDULE, LOOKUP,
 ITD) = range(10)
COUNTERS = {DISPATCH: ("blocks",), APPLY: ("events",), SYNTH: ("blocks",),
            SPAN: ("K", "live"), TABLES: ("bank",),
            SCHEDULE: ("events", "writes"),
            LOOKUP: ("L", "compressed"), ITD: ("L", "M")}

# a ring of this many spans holds the set-up and a 30 s window of the
# busiest stream several times over (~5 spans a 11.6 ms block)
CAPACITY = 1 << 17
# a span's row: begin() writes it whole, end() its last three fields
_FIELDS = ("index", "name", "trace", "parent", "thread", "t0",
           "t1", "c0", "c1")
_BEGIN = struct.Struct("9q")
_END = struct.Struct("3q")
_INDEX = struct.Struct("q")
_ROW = 8 * len(_FIELDS)


class _Log:
    """The ring: one preallocated int64 row a span, written by one struct
    pack at each end of the span (no Python object kept per span).
    ``index`` holds the span's sequence number + 1, so 0 marks a row never
    written; ``t1`` 0 marks a span still open."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.data = np.zeros((capacity, len(_FIELDS)), np.int64)
        self.buf = memoryview(self.data).cast("B")
        self.seq = itertools.count()


_log = _Log(CAPACITY)
_local = threading.local()     # this thread's open spans [(index, trace)]


def reset(capacity: int = CAPACITY) -> None:
    """Empty the log (a new ring of ``capacity`` spans)."""
    global _log
    _log = _Log(capacity)


def begin(name: int, trace: int | None = None, t0: int | None = None
          ) -> int:
    """Open a span ``name`` (an id of NAMES) on this thread: returns its
    token for :func:`end`, -1 when nothing records (one flag read, nothing
    stored). ``trace`` defaults to the enclosing span's; ``t0`` to now."""
    if not _flag._is_profiler_enabled:
        return -1
    log = _log
    seq = next(log.seq)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.thread = threading.get_native_id()
    parent, up = stack[-1] if stack else (-1, -1)
    if trace is None:
        trace = up
    stack.append((seq, trace))
    _BEGIN.pack_into(log.buf, (seq % log.capacity) * _ROW, seq + 1, name,
                     trace, parent, _local.thread,
                     time.time_ns() if t0 is None else t0, 0, 0, 0)
    return seq


def end(token: int, c0: int = 0, c1: int = 0, t1: int | None = None
        ) -> None:
    """Close the span ``token`` (from :func:`begin`; -1 does nothing) with
    its counters. Spans this thread opened inside it and never closed (an
    exception passed them) are dropped from its stack, still open."""
    if token < 0:
        return
    t = time.time_ns() if t1 is None else t1
    stack = _local.stack
    while stack and stack.pop()[0] != token:
        pass
    log = _log
    off = (token % log.capacity) * _ROW
    if _INDEX.unpack_from(log.buf, off)[0] == token + 1:  # not overwritten
        _END.pack_into(log.buf, off + 48, t, c0, c1)


def overwritten() -> int:
    """How many spans the ring has overwritten since the last reset."""
    top = int(_log.data[:, 0].max())
    return max(0, top - _log.capacity)


def spans(t0_ns: int | None = None, t1_ns: int | None = None
          ) -> dict | None:
    """The closed spans, in the order they opened: arrays ``index`` (a
    span's number, which ``parent`` gives of the enclosing one, -1 for a
    root), ``name`` (an id of NAMES), ``t0``, ``t1`` (ns, time.time_ns),
    ``trace``, ``parent``, ``c0``, ``c1`` (counters, COUNTERS) and
    ``thread`` (native id). With a window, only spans inside [t0_ns,
    t1_ns], or None when the ring has overwritten spans that may have lain
    in it."""
    data = _log.data.T.copy()
    f = {name: k for k, name in enumerate(_FIELDS)}
    data = data[:, (data[f["index"]] > 0) & (data[f["t1"]] > 0)]
    data = data[:, np.argsort(data[f["index"]], kind="stable")]
    data[f["index"]] -= 1
    if t0_ns is not None:
        t0, t1 = data[f["t0"]], data[f["t1"]]
        if overwritten() and (not t0.size or t0[0] >= t0_ns):
            return None
        data = data[:, (t0 >= t0_ns) & (t1 <= t1_ns)]
    return dict(zip(_FIELDS, data))


@dataclasses.dataclass
class BlockStats:
    count: int                      # blocks recorded in all
    mean_ms: float                  # a dispatch's time, over the ring
    p50_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    deadline_ms: float              # blocks x block period, the mean
    deadline_miss_rate: float       # dispatches past their own deadline
    rtf: float                      # realtime factor = deadline / mean
    dispatches: int                 # dispatches the percentiles cover


class BlockProfiler:
    """Dispatch latency tracker with deadline accounting: one sample a
    dispatch (its time and blocks), held in a ring of ``capacity``."""

    def __init__(self, block_size: int, sample_rate: int,
                 capacity: int = 4096):
        self.deadline = block_size / sample_rate
        self._times = np.zeros(capacity, np.float64)
        self._blocks = np.zeros(capacity, np.int64)
        self._n = 0
        self._total = 0
        self._cap = capacity
        self._lock = threading.Lock()

    def record(self, seconds: float, blocks: int = 1) -> None:
        """A dispatch of ``blocks`` blocks that took ``seconds`` from its
        start to its last block in host memory."""
        with self._lock:
            self._times[self._n % self._cap] = seconds
            self._blocks[self._n % self._cap] = blocks
            self._n += 1
            self._total += blocks

    def stats(self) -> BlockStats | None:
        with self._lock:
            n = min(self._n, self._cap)
            if n == 0:
                return None
            t = self._times[:n] * 1e3
            b = self._blocks[:n].astype(np.float64)
            total = self._total
        block_ms = self.deadline * 1e3
        deadline_ms = float(b.mean()) * block_ms
        mean = float(t.mean())
        return BlockStats(
            count=total,
            mean_ms=mean,
            p50_ms=float(np.percentile(t, 50)),
            p95_ms=float(np.percentile(t, 95)),
            p99_ms=float(np.percentile(t, 99)),
            max_ms=float(t.max()),
            deadline_ms=deadline_ms,
            deadline_miss_rate=float((t > b * block_ms).mean()),
            rtf=deadline_ms / mean if mean > 0 else float("inf"),
            dispatches=n,
        )


def _span_events(t0_ns: int, t1_ns: int, base_ns: int) -> list:
    """The program's spans inside [t0_ns, t1_ns] as Chrome trace events
    (microseconds after ``base_ns``), a track a thread."""
    s = spans()
    keep = (s["t0"] >= t0_ns) & (s["t1"] <= t1_ns)
    out = []
    for i in np.nonzero(keep)[0]:
        name = int(s["name"][i])
        args = {"trace": int(s["trace"][i]), "index": int(s["index"][i]),
                "parent": int(s["parent"][i])}
        for key, col in zip(COUNTERS.get(name, ()), ("c0", "c1")):
            args[key] = int(s[col][i])
        out.append({"ph": "X", "cat": "program", "name": NAMES[name],
                    "pid": "program spans", "tid": int(s["thread"][i]),
                    "ts": (int(s["t0"][i]) - base_ns) / 1e3,
                    "dur": (int(s["t1"][i]) - int(s["t0"][i])) / 1e3,
                    "args": args})
    return out


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a trace of the enclosed work into ``logdir/trace.json``
    (Chrome trace format): host activity always, CUDA activity when a card
    is there, and the program's spans of the window as the "program spans"
    track, on the same clock. Yields the profiler, whose
    ``key_averages()`` can be read after the block ends."""
    import json
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    t0 = time.time_ns()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        t1 = time.time_ns()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
        trace["traceEvents"] += _span_events(
            t0, t1, int(trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as fh:
            json.dump(trace, fh)
