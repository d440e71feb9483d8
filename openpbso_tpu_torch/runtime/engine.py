"""StreamingEngine — the real-time producer/consumer pipeline.

Counterpart of openpbso_tpu/runtime/engine.py: the reference's three-thread
architecture (UI thread -> [SPSC queues] -> sim thread -> [sound queue] ->
audio callback; modal_solver.h:100-141, real_time_modal_sound.cpp:527-553)
over a ModalSession of this package:

- a **synthesis thread** runs the block step ahead of playback and copies
  each dispatch's audio to the host. That copy is the loop's one
  synchronisation with the card: it waits until the dispatch has drained,
  so block k+1 is enqueued only after block k has reached the host.
- a bounded **sound queue** (capacity 2, like the reference's
  ``_queue_sound``) paces the producer: ``put`` blocks when the consumer lags
  (the reference's infinite-retry enqueue spin, modal_solver.h:275,348-357).
- **event queues** with the reference's exact drop semantics: force events
  bounded at 512 with drop-on-full (modal_solver.h:129, 330-333), transfer
  updates latest-wins capacity 1 (modal_solver.h:107,250-252), AR params
  latest-wins (modal_solver.h:109), qnorm telemetry best-effort capacity 2
  (modal_solver.h:272-273).
- a 100-slot **buffer-health ring** mirrors the underrun telemetry
  (real_time_modal_sound.cpp:74, 203-206).

Thread-safety is by construction: the synthesis thread owns the SolverState;
other threads only enqueue immutable event records. The engine works on the
device of the session's bank.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..config import SAMPLE_RATE
from ..ops.forces import ar_stability_radius
from . import profiling
from .session import ModalSession


@dataclasses.dataclass
class HitEvent:
    obj: int
    space: np.ndarray
    kind: str = "point"
    width_us: float = 100.0
    amp: float = 1.0


@dataclasses.dataclass
class SustainedEvent:
    obj: int
    action: str                      # 'start' | 'update' | 'end'
    space: np.ndarray | None = None


@dataclasses.dataclass
class ArParamEvent:
    obj: int
    a: tuple = (0.783, 0.116)
    sigma: float = 0.00148
    mu: float = 0.142


@dataclasses.dataclass
class TransferEvent:
    listener: np.ndarray             # [3] or [O, 3]


@dataclasses.dataclass
class ClearEvent:
    obj: int | None = None


@dataclasses.dataclass
class ControlEvent:
    fn: Callable                     # called with the session, synth thread


def _host(x) -> np.ndarray:
    """One explicit device-to-host copy of a device tensor (it waits for
    the work that produces it: the span ``engine.copy``); arrays pass
    through."""
    if isinstance(x, torch.Tensor):
        tok = profiling.begin(profiling.COPY)
        out = x.detach().cpu().numpy()
        profiling.end(tok)
        return out
    return np.asarray(x)


def _thread_first_use(device: torch.device) -> None:
    """PyTorch keeps its cuBLAS handle and workspace per thread, so the
    session's warmup on the caller's thread does not spare a new thread
    their creation (tens of ms at its first matrix product). Make them
    here, with one small product of each kind the block steps use, an FFT
    pair and a device-to-host copy."""
    x = torch.ones((8, 8, 8), device=device)
    y = torch.bmm(x, x) + torch.einsum("om,oms->os", x[0], x) @ x[0]
    y = y + torch.fft.irfft(torch.fft.rfft(y, n=16), n=16)[..., :8]
    y.cpu()


class LatestWins:
    """Capacity-1 slot: writers overwrite, reader takes-and-clears.

    The analog of the reference's capacity-1 trans/arprm queues
    (modal_solver.h:107-109): only the newest value matters.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None

    def put(self, value) -> None:
        with self._lock:
            self._value = value

    def take(self):
        with self._lock:
            v = self._value
            self._value = None
            return v


class LatestWinsPerObject:
    """Per-OBJECT capacity-1 slots: the newest retune per object wins.

    The reference's capacity-1 arprm queue (modal_solver.h:107-109) was
    safe only because it has a single object; with many objects a global
    slot would let retunes of two different objects within one apply
    window silently drop the first. take() drains all pending objects.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[int, object] = {}

    def put(self, ev) -> None:
        with self._lock:
            self._values[ev.obj] = ev

    def take(self) -> list:
        with self._lock:
            vs = list(self._values.values())
            self._values.clear()
            return vs


class BufferHealth:
    """100-slot success ring (real_time_modal_sound.cpp:74, 203-206)."""

    def __init__(self, size: int = 100):
        self._ring = np.ones(size, np.float32)
        self._ptr = 0
        self._lock = threading.Lock()
        # cumulative counters: the ring rotates old underruns out after
        # `size` blocks, so whole-run questions ("did ANY block ever
        # underrun?") need these — beyond-reference telemetry
        self.total = 0
        self.missed = 0

    def record(self, ok: bool) -> None:
        with self._lock:
            self._ring[self._ptr] = 1.0 if ok else 0.0
            self._ptr = (self._ptr + 1) % len(self._ring)
            self.total += 1
            if not ok:
                self.missed += 1

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return self._ring.copy()

    @property
    def health(self) -> float:
        return float(self.snapshot().mean())


class StreamingEngine:
    """Runs a ModalSession continuously against an audio sink."""

    def __init__(
        self,
        session: ModalSession,
        sink,
        *,
        sound_queue_depth: int = 2,
        force_queue_depth: int = 512,
        qnorm_every: int = 0,
        on_qnorm: Callable[[np.ndarray], None] | None = None,
        lookahead: int = 1,
        post_mix=None,
        record: bool = False,
    ):
        """``lookahead`` > 1 synthesizes that many blocks per dispatch
        (one span, or that many block steps with one host copy): latency
        rises to lookahead * block/rate, and the per-dispatch host cost is
        shared by the blocks. Events still apply between dispatches.

        ``record=True`` keeps a host-side log of every applied event with
        its sample time; ``export_timeline()`` turns it into the JSON
        schema render_timeline bakes — "bake what you played" (the
        reference has no way to reproduce an interactive session).

        ``post_mix(sound, mix) -> mix'`` replaces the session's plain gain
        mixdown per block: a plain callable on the device tensors ``sound``
        [O, S] and ``mix`` [S, C] that returns a tensor or an array.
        Optional hooks honored when present: ``.process_span(sound)`` (the
        same over a whole span's [O, N] sound, which keeps the stream on
        span dispatches), ``.on_listener(pos)`` (called when a listener
        event applies, so direction-dependent filters track the move) and
        ``.reset()`` (called after warmup so the stream starts with clean
        filter state). ``ops/hrtf.py::HRTFPostMix`` and
        ``ops/doppler.py::DopplerPostMix`` have all three: binaural HRTF
        and live Doppler streams keep their span dispatches."""
        self.session = session
        self.sink = sink
        self.lookahead = max(1, int(lookahead))
        self._events: queue.Queue = queue.Queue(maxsize=force_queue_depth)
        self._transfer = LatestWins()
        self._arprm = LatestWinsPerObject()
        self._sound: queue.Queue = queue.Queue(maxsize=sound_queue_depth)
        self._qnorm: queue.Queue = queue.Queue(maxsize=2)
        self._qnorm_every = qnorm_every
        self._on_qnorm = on_qnorm
        self._post_mix = post_mix
        self.health = BufferHealth()
        self.profiler = profiling.BlockProfiler(session.config.block_size,
                                                SAMPLE_RATE)
        self._stop = threading.Event()
        self._ready = threading.Event()   # the synth thread is warm
        self._synth_thread: threading.Thread | None = None
        self._consume_thread: threading.Thread | None = None
        self._last_block: np.ndarray | None = None
        self._blocks_done = 0
        self._dispatches = 0      # the trace id of the spans of a dispatch
        self._record = record
        self.recorded: list[tuple[int, object]] = []
        # the pre-stream listener position (a [3] world point only; Scene
        # sessions hold relative rows, which have no keyframe form)
        init = getattr(session, "_last_listener", None)
        self._initial_listener = (
            np.asarray(init, np.float64)
            if record and init is not None
            and np.asarray(init).ndim == 1 else None)
        # next _blocks_done at which to compute qnorm: a modulo test
        # starves with lookahead > 1 (blocks advance by lookahead, so e.g.
        # lookahead 4 / every 8 lands on 1+4k, never divisible by 8)
        self._next_qnorm = 0
        # failure detection: a dead synthesis pipeline must be observable,
        # not a silent stream of stale blocks (the reference's sim thread
        # can die invisibly; SURVEY section 5 'failure detection: none')
        self.error: BaseException | None = None

    # ----------------------------------------------------------- event API

    VALID_KINDS = ("point", "gaussian", "hertz")

    def hit(self, obj: int, space: np.ndarray, *, kind: str = "point",
            width_us: float = 100.0, amp: float = 1.0) -> bool:
        """Non-blocking enqueue; drops when full (modal_solver.h:330-333).

        Validates here, on the producer thread: a bad event applied inside
        the synthesis thread would kill the whole stream.
        """
        if kind not in self.VALID_KINDS:
            raise ValueError(f"unknown force kind {kind!r}")
        if not 0 <= int(obj) < self.session.bank.num_objects:
            raise IndexError(
                f"object {obj} out of range "
                f"[0, {self.session.bank.num_objects})")
        return self._put_event(HitEvent(int(obj), np.asarray(space),
                                        kind, width_us, amp))

    def _put_event(self, ev) -> bool:
        """Non-blocking enqueue, drop-on-full — the reference's semantics
        for EVERY force message (modal_solver.h:330-333). A blocking put
        here would wedge the caller (a server rx thread) for as long as
        the synthesis thread is stalled; the queue only fills when the
        stream is already broken (healthy goes false)."""
        try:
            self._events.put_nowait(ev)
            return True
        except queue.Full:
            return False

    def _check_obj(self, obj: int) -> int:
        """Producer-side range check: a bad event applied inside the
        synthesis thread would kill the whole stream (same contract as
        hit(); the numpy host-mirror writes raise IndexError there)."""
        if not 0 <= int(obj) < self.session.bank.num_objects:
            raise IndexError(
                f"object {obj} out of range "
                f"[0, {self.session.bank.num_objects})")
        return int(obj)

    def set_listener(self, pos: np.ndarray) -> None:
        self._transfer.put(TransferEvent(np.asarray(pos)))

    def sustained_start(self, obj: int, space: np.ndarray) -> bool:
        return self._put_event(SustainedEvent(self._check_obj(obj),
                                              "start", np.asarray(space)))

    def sustained_update(self, obj: int, space: np.ndarray) -> bool:
        return self._put_event(SustainedEvent(self._check_obj(obj),
                                              "update", np.asarray(space)))

    def sustained_end(self, obj: int) -> bool:
        return self._put_event(SustainedEvent(self._check_obj(obj), "end"))

    def set_ar_params(self, obj: int, a=(0.783, 0.116), sigma=0.00148,
                      mu=0.142) -> None:
        a = tuple(float(v) for v in a)
        if len(a) != 2:
            raise ValueError(f"AR(2) needs exactly 2 coefficients, got {a}")
        if not (ar_stability_radius(a) < 1.0):   # NaN-safe rejection
            # reject at enqueue (caller thread) — the session would raise
            # on the synthesis thread, after the event was already queued
            raise ValueError(
                f"unstable AR(2) tuning a={a}: characteristic root "
                f"magnitude >= 1")
        self._arprm.put(ArParamEvent(self._check_obj(obj), a,
                                     float(sigma), float(mu)))

    def clear_forces(self, obj: int | None = None) -> bool:
        return self._put_event(ClearEvent(
            None if obj is None else self._check_obj(obj)))

    def control(self, fn: Callable, timeout: float = 60.0) -> bool:
        """Run ``fn(session)`` on the SYNTHESIS thread and wait for it.

        session.state is owned by the synthesis loop (read -> compute ->
        assign per block): a session mutation made directly from another
        thread can be silently lost to a concurrent block assignment.
        Mutations with no dedicated event type (e.g. the wire transfer
        toggles) route through here instead. An exception inside ``fn``
        re-raises HERE, on the caller thread — never on the stream.
        Falls back to an inline call when the engine is not running (no
        concurrent owner to race). Returns False when the event could
        not be applied within ``timeout`` (stalled/dead synthesis)."""
        if self._synth_thread is None or not self._synth_thread.is_alive():
            fn(self.session)
            return True
        done = threading.Event()
        box: dict[str, BaseException] = {}

        def wrapped(sess):
            try:
                fn(sess)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["err"] = e
            finally:
                done.set()

        if not self._put_event(ControlEvent(wrapped)):
            return False
        ok = done.wait(timeout)
        if "err" in box:
            raise box["err"]
        return ok

    def export_timeline(self) -> dict:
        """Recorded events -> the render_timeline JSON schema.

        Hits replay exactly (block-quantized identically live and baked).
        Listener moves are STEP changes live, while the bake schema
        linearly interpolates keyframes — so each move exports as a pair
        (hold the previous position until one block before the move, then
        the new position), which np.interp reproduces as the same
        block-quantized step; the pre-stream position anchors t=0.
        Sustained AR contacts (start/update/end) and AR retunes export as
        ``sustained`` entries and replay DETERMINISTICALLY: the drag
        noise is a pure function of (session seed, block index) —
        ops/forces.py::_noise_for_blocks — and the exported ``seed``
        reseeds the baking session identically. Only clear_forces and
        per-object listener-row stacks remain live-only
        (``skipped_events``). Requires record=True.
        """
        if not self._record:
            raise ValueError("engine was not constructed with record=True")
        block_s = self.session.config.block_size / SAMPLE_RATE
        # an engine streaming through a live-Doppler post-mix exports a
        # Doppler timeline: "bake what you played" must replay the delay
        # physics, not just the amplitude.
        # Detect a Doppler post-mix by its velocity state (``velocities``
        # and ``positions`` attributes) — ``on_listener`` alone also
        # matches direction-filter stages, whose streams must bake
        # amplitude-only.
        doppler_live = (self._post_mix is not None
                        and hasattr(self._post_mix, "velocities"))
        events, listener, sustained, skipped = [], [], [], 0
        prev_pos = (self._initial_listener.tolist()
                    if self._initial_listener is not None else None)
        for clock, ev in self.recorded:
            t = clock / SAMPLE_RATE
            if isinstance(ev, HitEvent):
                events.append({"t": t, "obj": ev.obj,
                               "space": np.asarray(ev.space,
                                                   np.float64).tolist(),
                               "kind": ev.kind, "width_us": ev.width_us,
                               "amp": ev.amp})
            elif isinstance(ev, TransferEvent):
                pos = np.asarray(ev.listener, np.float64)
                if pos.ndim != 1:
                    skipped += 1   # per-object listener rows have no
                    #   single-keyframe representation in the schema
                    continue
                if doppler_live:
                    # live Doppler ramps the delay across the dispatch
                    # AFTER the event applies (DopplerPostMix._run), so
                    # the baked keyframes hold the OLD position at the
                    # applied block and reach the new one a block later —
                    # np.interp then reproduces the live delay trajectory
                    # (exactly, for block-sized dispatches / lookahead=1;
                    # span dispatches stretch the live ramp over the span
                    # and the bake remains the block-accurate render).
                    # The FFAT amplitude step consequently lands one
                    # block later than live — delay-exact is the priority
                    # (amplitude varies smoothly, delay errors decorrelate
                    # waveforms).
                    if prev_pos is not None and t > 0:
                        listener.append({"t": t, "pos": prev_pos})
                    listener.append({"t": t + block_s, "pos": pos.tolist()})
                elif prev_pos is not None and t > 0:
                    # hold until one block before the move -> np.interp
                    # reproduces the live step at block granularity
                    listener.append({"t": max(t - block_s, 0.0),
                                     "pos": prev_pos})
                    listener.append({"t": t, "pos": pos.tolist()})
                else:
                    listener.append({"t": t, "pos": pos.tolist()})
                prev_pos = pos.tolist()
            elif isinstance(ev, SustainedEvent):
                rec = {"t": t, "obj": ev.obj, "action": ev.action}
                if ev.space is not None:
                    rec["space"] = np.asarray(ev.space,
                                              np.float64).tolist()
                sustained.append(rec)
            elif isinstance(ev, ArParamEvent):
                sustained.append({"t": t, "obj": ev.obj,
                                  "action": "arparam",
                                  "a": [float(v) for v in ev.a],
                                  "sigma": float(ev.sigma),
                                  "mu": float(ev.mu)})
            else:
                skipped += 1       # clear_forces: live-only
        if prev_pos is not None and not listener:
            listener.append({"t": 0.0, "pos": prev_pos})
        elif listener and listener[0]["t"] > 0 \
                and self._initial_listener is not None:
            listener.insert(0, {"t": 0.0,
                                "pos": self._initial_listener.tolist()})
        duration = (self._blocks_done * self.session.config.block_size
                    / SAMPLE_RATE)
        out = {"duration_s": duration, "events": events,
               "smooth": self.session.config.smooth_transfer}
        if doppler_live and listener:
            out["doppler"] = True
            # non-origin object centers change the live delay frame
            # (DopplerPostMix measures |center - listener| / c); export
            # them so the bake's delay resample uses the same distances.
            # Live object MOTION (set_velocity integrating the centers)
            # has no timeline representation — the snapshot is the
            # centers as of export, like every other live-only effect.
            centers = np.asarray(self._post_mix.positions, np.float64)
            if centers.any():
                out["objects"] = centers.tolist()
        if listener:
            out["listener"] = listener
        if sustained:
            out["sustained"] = sustained
            out["seed"] = int(getattr(self.session, "seed", 0))
        if skipped:
            out["skipped_events"] = skipped
        return out

    def latest_qnorm(self) -> np.ndarray | None:
        try:
            return self._qnorm.get_nowait()
        except queue.Empty:
            return None

    # ----------------------------------------------------------- lifecycle

    def _apply_events(self) -> None:
        """The queued events, applied to the session: the span
        ``engine.apply``, counting them."""
        tok = profiling.begin(profiling.APPLY)
        applied = 0
        # <=16 events per block keeps the synthesis deadline safe while
        # draining bursts quickly (the reference applies <=1 per block,
        # modal_solver.h:184)
        for _ in range(16):
            try:
                ev = self._events.get_nowait()
            except queue.Empty:
                break
            applied += 1
            if self._record:
                self.recorded.append((self.session.sample_clock, ev))
            if isinstance(ev, HitEvent):
                self.session.hit(ev.obj, ev.space, kind=ev.kind,
                                 width_us=ev.width_us, amp=ev.amp)
            elif isinstance(ev, SustainedEvent):
                if ev.action == "start":
                    self.session.sustained_start(ev.obj, ev.space)
                elif ev.action == "update":
                    self.session.sustained_update(ev.obj, ev.space)
                else:
                    self.session.sustained_end(ev.obj)
            elif isinstance(ev, ClearEvent):
                self.session.clear_forces(ev.obj)
            elif isinstance(ev, ControlEvent):
                ev.fn(self.session)   # pre-wrapped: exceptions stay with
                #                       the caller, never kill the stream
        tr = self._transfer.take()
        if tr is not None:
            if self._record:
                self.recorded.append((self.session.sample_clock, tr))
            self.session.set_listener(tr.listener)
            if self._post_mix is not None and \
                    hasattr(self._post_mix, "on_listener"):
                self._post_mix.on_listener(tr.listener)
            applied += 1
        for ar in self._arprm.take():
            if self._record:
                self.recorded.append((self.session.sample_clock, ar))
            self.session.set_ar_params(ar.obj, ar.a, ar.sigma, ar.mu)
            applied += 1
        profiling.end(tok, applied)

    def _span_mix(self, n_blocks: int):
        """One span dispatch -> device mix [N, C]; routes through the
        post-mix's span entry when it has one (process_span: such streams
        keep the span rate)."""
        if self._post_mix is not None:
            sound = self.session._step_span_sound(n_blocks)
            return self._post_mix.process_span(sound)
        return self.session._step_span(n_blocks)

    def _synth_once(self) -> list[np.ndarray]:
        """One synthesis dispatch -> list of host audio blocks: the span
        ``engine.synth``, counting them (its enqueue, and each copy's wait
        as a child ``engine.copy``)."""
        tok = profiling.begin(profiling.SYNTH)
        blocks = self._synth_blocks()
        profiling.end(tok, len(blocks))
        return blocks

    def _synth_blocks(self) -> list[np.ndarray]:
        want_qnorm = (self._qnorm_every > 0
                      and self._blocks_done >= self._next_qnorm)
        if want_qnorm:
            self._next_qnorm = self._blocks_done + self._qnorm_every
        use_span = ((self._post_mix is None
                     or hasattr(self._post_mix, "process_span"))
                    and self.session.span_eligible()
                    and self.session._xfade_from is None)
        if use_span and want_qnorm \
                and self.session.qnorm_probe_eligible():
            # keep the span AND the telemetry: probe the pre-span state's
            # ring-down energy beside the span instead of breaking the
            # span for a per-block qnorm step
            qnorm = self.session.qnorm_probe()
            mix = self._span_mix(self.lookahead)
            mix_np = _host(mix)
            try:
                self._qnorm.put_nowait(_host(qnorm))
            except queue.Full:
                pass  # telemetry is best-effort (modal_solver.h:273)
            block = self.session.config.block_size
            return [mix_np[i * block:(i + 1) * block]
                    for i in range(self.lookahead)]
        if self.lookahead == 1 or want_qnorm:
            if not want_qnorm and use_span:
                # single-block span dispatch, the reference engine's
                # choice over both per-block forms whenever the session
                # holds span tables
                return [_host(self._span_mix(1))]
            if want_qnorm:
                self.session.config = dataclasses.replace(
                    self.session.config, compute_qnorm=True)
            sound, mix, qnorm = self.session.step()
            if self._post_mix is not None:
                mix = self._post_mix(sound, mix)
            mix_np = _host(mix)  # device sync point
            if want_qnorm:
                self.session.config = dataclasses.replace(
                    self.session.config, compute_qnorm=False)
                try:
                    self._qnorm.put_nowait(_host(qnorm))
                except queue.Full:
                    pass  # telemetry is best-effort (modal_solver.h:273)
            return [mix_np]
        # lookahead: when the session has span tables, ONE span dispatch
        # synthesizes all L blocks with no serial dependency (ops/span.py)
        # — the fastest path; span-capable post-mixes consume the whole
        # span's [O, N] sound in one call.
        if use_span:
            mix = _host(self._span_mix(self.lookahead))
            block = self.session.config.block_size
            return [mix[i * block:(i + 1) * block] for i in
                    range(self.lookahead)]
        # otherwise: L single-block steps enqueued back to back and ONE
        # stacked copy at the end, so the host waits for the card once per
        # dispatch and not once per block
        mixes = []
        for _ in range(self.lookahead):
            sound, mix, _ = self.session.step()
            if self._post_mix is not None:
                mix = self._post_mix(sound, mix)
            mixes.append(mix)
        if all(isinstance(m, torch.Tensor) for m in mixes):
            return list(_host(torch.stack(mixes)))
        return [_host(m) for m in mixes]

    def _synth_loop(self) -> None:
        try:
            # the reference pins its sim thread to SCHED_FIFO max priority
            # (real_time_modal_sound.cpp:527-539); best-effort equivalent —
            # needs CAP_SYS_NICE, silently skipped otherwise
            import os
            try:
                os.sched_setscheduler(
                    0, os.SCHED_FIFO,
                    os.sched_param(os.sched_get_priority_max(os.SCHED_FIFO)))
            except (OSError, AttributeError, PermissionError):
                pass
            # this thread did not build the session: kernels launch on the
            # calling thread's current device and stream, so make the
            # session's device this thread's
            device = self.session.device
            if device.type == "cuda":
                torch.cuda.set_device(device)
                for d in self.session.devices:   # a mesh's every card
                    _thread_first_use(d)
            self._ready.set()
            self._synth_loop_inner()
        except BaseException as e:  # noqa: BLE001 — surfaced via .error
            self.error = e
            self._stop.set()
            self._ready.set()

    def _synth_loop_inner(self) -> None:
        while not self._stop.is_set():
            # the span engine.dispatch and the profiler's sample share
            # their stamps
            t0 = time.time_ns()
            tok = profiling.begin(profiling.DISPATCH, self._dispatches, t0)
            self._apply_events()
            blocks = self._synth_once()
            t1 = time.time_ns()
            profiling.end(tok, len(blocks), t1=t1)
            self._dispatches += 1
            self.profiler.record((t1 - t0) * 1e-9, len(blocks))
            for mix_np in blocks:
                self._blocks_done += 1
                # pacing: blocks when the consumer lags sound_queue_depth
                while not self._stop.is_set():
                    try:
                        self._sound.put(mix_np, timeout=0.1)
                        break
                    except queue.Full:
                        continue

    def _consume_loop(self) -> None:
        block = self.session.config.block_size
        channels = int(self.session.gains.shape[-1])
        silent = np.zeros((block, channels), np.float32)
        while not self._stop.is_set():
            try:
                mix = self._sound.get(timeout=0.2)
                ok = True
            except queue.Empty:
                # underrun: replay stale buffer like the PortAudio callback
                # (real_time_modal_sound.cpp:203-210)
                mix = self._last_block if self._last_block is not None \
                    else silent
                ok = False
            self._last_block = mix
            wrote = self.sink.write(mix)  # stale/silent block still plays
            self.health.record(ok and wrote)

    def start(self) -> None:
        if self._synth_thread is not None and self._synth_thread.is_alive():
            raise RuntimeError("engine already running (stop() first) — a "
                               "second synth thread would race the first "
                               "for the session state")
        # after a synthesis failure the CONSUME thread of the old run can
        # still be draining (it only observes the stop flag at its next
        # 0.2 s queue timeout) — join both old threads under a SET flag
        # before clearing it, or a quick restart would leave two
        # consumers interleaving one sound queue into the sink
        self._stop.set()
        for t in (self._synth_thread, self._consume_thread):
            if t is not None:
                while t.is_alive():
                    t.join(timeout=5.0)
        self.error = None   # a restart after a failure starts clean
        self._stop.clear()
        # Run EVERY variant the steady-state loop will use BEFORE spawning
        # threads: the kernels' build and load, table builds and library
        # handles all cost at first use, and a daemon thread abandoned
        # inside a native call aborts the process at interpreter exit. The
        # session owns the variant set and snapshots/restores its own
        # state (session.warmup); the engine just declares which optional
        # paths this stream can reach.
        span_capable = (self._post_mix is None
                        or hasattr(self._post_mix, "process_span"))
        self.session.warmup(
            qnorm=self._qnorm_every > 0,
            post_mix=self._post_mix,
            sustained=True,
            span_blocks=(
                (self.lookahead,)
                if span_capable and self.session.span_eligible() else ()),
        )
        if self._qnorm_every > 0 and span_capable \
                and self.session.span_eligible() \
                and self.session.qnorm_probe_eligible():
            _host(self.session.qnorm_probe())  # the probe's first use

        self._synth_thread = threading.Thread(
            target=self._synth_loop, name="pbso-synth", daemon=True)
        self._consume_thread = threading.Thread(
            target=self._consume_loop, name="pbso-audio", daemon=True)
        self._ready.clear()
        self._synth_thread.start()
        # session.warmup ran on this thread; what the library keeps per
        # thread is made on the synthesis thread before its first block
        # (_thread_first_use), and start() returns once that is done
        self._ready.wait()
        self._consume_thread.start()

    def stop(self) -> None:
        self._stop.set()
        for t in (self._synth_thread, self._consume_thread):
            if t is None:
                continue
            # wait as long as it takes: killing a thread inside a native
            # device call aborts the whole process at exit
            while t.is_alive():
                t.join(timeout=5.0)
        self.sink.close()

    @property
    def healthy(self) -> bool:
        """False once the synthesis pipeline has died (see .error)."""
        return self.error is None and not self._stop.is_set()

    def run_for(self, seconds: float) -> None:
        """Convenience: start, run, stop. Raises if synthesis died."""
        self.start()
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline and self.healthy:
            time.sleep(min(0.1, max(0.0, deadline - time.monotonic())))
        self.stop()
        if self.error is not None:
            raise RuntimeError("synthesis pipeline failed") from self.error
