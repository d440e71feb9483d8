"""The live entry: the program's StreamingEngine over a session, played
open loop into the benchmark's paced audio device.

The engine's synthesis thread takes each dispatch as: apply the queued
events, synthesise, copy the block to the host. The benchmark wraps both
steps on the engine instance: a block's time is from the start of the
events' application to the block's samples in host memory.

The traffic's calls due by a block are put to the engine's public event
methods at the start of the dispatch that makes the block, on the
synthesis thread and before its clock starts, as a game thread would have
put them during the block before: each event applies at the block the
schedule gives it, on every run of a seed, and no other thread wakes
during the window. The session's public event methods are wrapped on the
instance (recorder.py), so that the reference replays each event at the
sample clock at which it applied.

Parameters of the mix: ``lookahead`` (blocks a dispatch) and
``qnorm_every`` (the engine's telemetry), and its event families.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from .. import generator, scene
from ..pacer import PacedSink
from ..recorder import Recorder

# how often the main thread looks whether the engine is still alive
WATCH_S = 0.25


def run(cell: dict, seed: int, seconds: float, tracer, t_proc: float,
        device) -> dict:
    """One run of a live cell: the harness's readings (the blocks' times,
    the paced device's counts, the produced audio, the recorded events)."""
    from openpbso_tpu_torch.runtime.engine import StreamingEngine
    cfg, mix = cell["config"], cell["mix"]
    rate, s = cfg["sample_rate"], cfg["block_size"]
    inputs = scene.make_inputs(cfg, seed)
    port = scene.port_scene(cfg, inputs, device)
    session_seed = int(seed) % (1 << 31)
    sess = scene.new_session(cfg, port, session_seed)
    n_blocks = int(np.ceil(seconds * rate / s)) + 64
    first, calls = generator.live_schedule(mix, cfg, inputs, seed, n_blocks)
    rec = Recorder(sess, listener_timing=tracer is not None)
    rec.on = True
    sess.set_listener(first)
    rec.on = False
    sink = PacedSink(rate)
    engine = StreamingEngine(sess, sink, lookahead=mix["lookahead"],
                             qnorm_every=mix["qnorm_every"])
    produced, dispatches = [], []
    apply, synth = engine._apply_events, engine._synth_once
    feed = dict(go=False, base=None, next=0, dropped=None)
    stamp = {}

    def put_due() -> None:
        if feed["base"] is None:
            feed["base"] = len(produced)
        block = len(produced) - feed["base"]
        while feed["next"] < len(calls) and calls[feed["next"]][0] <= block:
            method, args, kw = calls[feed["next"]][1]
            feed["next"] += 1
            if getattr(engine, method)(*args, **kw) is False:
                feed["dropped"] = method

    def timed_apply():
        if feed["go"]:
            put_due()
        stamp["t"] = time.perf_counter()
        stamp["ns"] = time.time_ns()
        apply()

    def timed_synth():
        blocks = synth()
        dispatches.append((stamp["t"], time.perf_counter(), stamp["ns"],
                           time.time_ns(), len(blocks)))
        produced.extend(blocks)
        return blocks
    engine._apply_events, engine._synth_once = timed_apply, timed_synth

    if tracer is not None:
        tracer.start()
    engine.start()
    gc.freeze()       # the set-up's objects: no collection scans them again
    try:
        rec.on = True
        if tracer is not None:
            tracer.mark()
        late0, due0 = sink.late_blocks, sink.total_blocks
        w0 = time.perf_counter()
        setup_s = w0 - t_proc
        feed["go"] = True
        w1 = w0 + seconds
        while (now := time.perf_counter()) < w1:
            if not engine.healthy:
                raise RuntimeError(f"the engine died: {engine.error!r}")
            if feed["dropped"] is not None:
                raise RuntimeError(f"the engine dropped a {feed['dropped']} "
                                   "call: the traffic outran its queue")
            time.sleep(min(WATCH_S, w1 - now))
        late, due = sink.late_blocks - late0, sink.total_blocks - due0
        if tracer is not None:
            tracer.stop()
    finally:
        engine.stop()
    if engine.error is not None:
        raise RuntimeError("the engine failed") from engine.error
    rec.on = False
    timed = [d for d in dispatches if w0 <= d[1] <= w1]
    ms = np.asarray([1e3 * (d[1] - d[0]) for d in timed for _ in range(d[4])])
    return dict(
        setup_s=setup_s, attempted=due, failed=late,
        values={"block_ms_p50": float(np.percentile(ms, 50)),
                "block_ms_p95": float(np.percentile(ms, 95))},
        items=[dict(audio=np.concatenate(produced), events=rec.events,
                    ar_seed=session_seed)],
        record=dict(dispatches=[(d[2], d[3], d[4]) for d in timed],
                    listener_ms=rec.listener_ms),
        keep=[engine, sess, port])


def host_spans(rec: dict) -> list:
    """What the host was doing, innermost first: a gap in no dispatch is
    the synthesis thread waiting for the paced device."""
    return [[("dispatch", a, b) for a, b, _ in rec["dispatches"]],
            [("waiting for the audio device", rec["t0_ns"], rec["t1_ns"])]]
