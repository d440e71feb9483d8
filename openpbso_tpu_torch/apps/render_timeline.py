"""render_timeline — bake a scripted event timeline to audio.

The port's counterpart of openpbso_tpu/apps/render_timeline.py (the same
schema and flags, ``--device {cuda,cpu}`` for ``--platform``). The
reference is interactive-only: every hit comes from a live mouse click
and every listener move from the live camera (real_time_modal_sound.cpp
:594-622, :1166-1175). A production sound pipeline bakes instead: a JSON
timeline of impacts and listener motion renders deterministically to a wav
in a handful of device dispatches (future-dated force slots + per-block
transfer schedules; optionally with physical Doppler).

Timeline schema (JSON)::

    {
      "duration_s": 2.0,
      "events": [
        {"t": 0.10, "obj": 0, "vertex": 12, "kind": "gaussian",
         "width_us": 200.0, "amp": 1.0},
        {"t": 0.50, "obj": 0, "space": [..], "kind": "point"}
      ],
      "listener": [
        {"t": 0.0, "pos": [1.0, 0.5, 0.0]},
        {"t": 2.0, "pos": [0.2, 0.5, 0.8]}
      ],
      "doppler": false,
      "smooth": true
    }

Event times are quantized to block starts — the reference's force
granularity (ModalSolver::step dequeues at most one force message per
block, modal_solver.h:184). The listener path is linearly interpolated
between keyframes at block rate; ``doppler`` adds the r(t)/c propagation
delay (session.render_doppler), ``smooth`` ramps the transfer per block.
An optional ``objects`` key ([O, 3] centers, exported by
StreamingEngine.export_timeline for DopplerPostMix streams with
non-origin object positions) offsets the DELAY distances only — the
amplitude transfer keeps the session frame, matching the live engine's
composition.

    python -m openpbso_tpu_torch.apps.render_timeline --demo-synth \
        --timeline events.json --out baked.wav
"""
from __future__ import annotations

import argparse
import itertools
import json
from functools import partial

import numpy as np

from ..config import DEFAULT_BLOCK, FILE_NOT_EXIST, SAMPLE_RATE
from ..runtime import profiling

_BAKES = itertools.count()     # the trace id of a bake's spans


def listener_blocks(keyframes: list[dict], n_blocks: int,
                    block_size: int) -> np.ndarray:
    """Keyframes [{"t": s, "pos": [3]}] -> per-block positions [T, 3]."""
    if not keyframes:
        raise ValueError("timeline needs at least one listener keyframe")
    ks = sorted(keyframes, key=lambda k: float(k["t"]))
    times = np.asarray([float(k["t"]) for k in ks])
    pos = np.asarray([[float(v) for v in k["pos"]] for k in ks])
    if pos.shape[1] != 3:
        raise ValueError("listener pos must be [x, y, z]")
    block_t = np.arange(n_blocks) * block_size / SAMPLE_RATE
    out = np.stack([np.interp(block_t, times, pos[:, i]) for i in range(3)],
                   axis=1)
    return out


def schedule_events(session, events: list[dict], model=None) -> int:
    """Future-date every event into the session's force slots.

    Times quantize to block starts (modal_solver.h:184 granularity).
    Events address a mesh vertex (needs ``model``) or raw modal
    amplitudes (``space``). Returns the number scheduled. The hits'
    device writes go in one batch (session.batched_writes).

    CAP: the per-object slot table holds ``num_slots`` concurrent
    future-dated hits — scheduling more than that on one object up
    front evicts the earliest unplayed ones (session._alloc_slot
    overwrites the oldest t0). ``bake`` therefore schedules in
    slot-budgeted WAVES (_hit_waves) instead of calling this once."""
    block = session.config.block_size
    count = 0
    with session.batched_writes():
        for ev in sorted(events, key=lambda e: float(e.get("t", 0.0))):
            t = float(ev.get("t", 0.0))
            when = int(round(t * SAMPLE_RATE / block)) * block
            if "space" in ev:
                space = np.asarray(ev["space"], np.float64)
            elif model is not None:
                space = model.modal_force_vertex(int(ev["vertex"]))
            else:
                raise ValueError(f"event at t={t} needs 'space' (no model "
                                 f"loaded for vertex addressing)")
            session.hit(int(ev.get("obj", 0)), space,
                        kind=str(ev.get("kind", "point")),
                        width_us=float(ev.get("width_us", 100.0)),
                        amp=float(ev.get("amp", 1.0)),
                        when=max(when, session.sample_clock))
            count += 1
    return count


def _hit_waves(session, events: list[dict],
               n_blocks: int) -> list[tuple[int, list[dict]]]:
    """Group timeline hits into [(schedule_block, [event, ...])] waves
    that fit the per-object force-slot table.

    One wave is future-dated in one go (an impact train inside a wave
    still costs zero extra dispatches); a new wave starts at the block
    of the first event that would OVERFLOW an object's slot count —
    by then every earlier hit (sorted order) has fired, so scheduling
    there can never evict an unplayed hit (round-5 review: >num_slots
    hits on one object up front silently dropped the earliest)."""
    block = session.config.block_size
    slots = session._expiry.shape[1]
    waves: list[tuple[int, list[dict]]] = []
    cur: list[dict] = []
    cur_block = 0
    counts: dict[int, int] = {}
    for ev in sorted(events, key=lambda e: float(e.get("t", 0.0))):
        obj = int(ev.get("obj", 0))
        b = min(int(round(float(ev.get("t", 0.0)) * SAMPLE_RATE / block)),
                n_blocks)
        if counts.get(obj, 0) >= slots:
            waves.append((cur_block, cur))
            cur, counts, cur_block = [], {}, b
        cur.append(ev)
        counts[obj] = counts.get(obj, 0) + 1
    if cur:
        waves.append((cur_block, cur))
    return waves


def _schedule_wave(session, evs: list[dict], model=None) -> None:
    """Future-date one wave of hits (see _hit_waves)."""
    schedule_events(session, evs, model)


def _apply_sustained(session, ev: dict) -> None:
    """Apply one ``sustained`` timeline entry to the session state
    (the bake-side mirror of the engine's SustainedEvent/ArParamEvent
    application, runtime/engine.py::_apply_events)."""
    obj = int(ev.get("obj", 0))
    action = str(ev["action"])
    if action == "start":
        session.sustained_start(obj, np.asarray(ev["space"], np.float64))
    elif action == "update":
        session.sustained_update(obj, np.asarray(ev["space"], np.float64))
    elif action == "end":
        session.sustained_end(obj)
    elif action == "arparam":
        session.set_ar_params(obj, a=tuple(ev["a"]),
                              sigma=float(ev["sigma"]),
                              mu=float(ev["mu"]))
    else:
        raise ValueError(f"unknown sustained action {action!r}")


def _apply_actions(session, fns: list, events: int) -> None:
    """The actions at one block, their device writes in one batch: the
    span bake.schedule, counting the events they schedule and the device
    writes they made."""
    tok = profiling.begin(profiling.SCHEDULE)
    writes = session.event_writes
    with session.batched_writes():
        for fn in fns:
            fn(session)
    profiling.end(tok, events, session.event_writes - writes)


def _reseed_sustained(session, seed: int) -> None:
    """Reset the per-object AR noise base keys to ``seed`` so a baked
    drag reproduces a live recording bit-for-bit (the noise stream is a
    pure function of these keys and the block index)."""
    import dataclasses

    from ..ops.forces import make_sustained_state
    fresh = make_sustained_state(session.bank.num_objects,
                                 session.bank.num_modes, seed=int(seed),
                                 dtype=session.state.z_re.dtype,
                                 device=session.device)
    session.state = dataclasses.replace(
        session.state, sustained=dataclasses.replace(
            session.state.sustained, key=fresh.key))


def bake(session, timeline: dict, model=None,
         blocks_per_dispatch: int = 64) -> np.ndarray:
    """Render one timeline; returns [N, C] float32: the span ``bake``,
    whose trace id numbers the process's bakes.

    ``sustained`` entries (exported by StreamingEngine.export_timeline,
    or hand-written) replay AR drags deterministically: the render is
    split at each entry's block, the state change applies at the
    boundary, and the drag noise — keyed by (timeline ``seed``, block
    index) — matches a live session seeded identically, sample for
    sample. Combines with ``doppler``: the sound GENERATION splits at
    event blocks (render_doppler's ``state_events``) while the global
    delay resample still sees the complete pre-delay stream — a dragged
    object under a moving listener bakes exactly like it played
    (round-4 VERDICT item 4; drag semantics modal_solver.h:190-240)."""
    tok = profiling.begin(profiling.BAKE, next(_BAKES))
    try:
        return _bake(session, timeline, model, blocks_per_dispatch)
    finally:
        profiling.end(tok)


def _bake(session, timeline: dict, model,
          blocks_per_dispatch: int) -> np.ndarray:
    block = session.config.block_size
    n_blocks = int(np.ceil(float(timeline["duration_s"])
                           * SAMPLE_RATE / block))
    keyframes = timeline.get("listener")
    doppler = bool(timeline.get("doppler", False))
    smooth = bool(timeline.get("smooth", True))
    sustained = sorted(timeline.get("sustained", []),
                       key=lambda e: float(e.get("t", 0.0)))
    if doppler and not keyframes:
        # validate BEFORE any session mutation: a caller that catches
        # the error must get its session back unaltered (same force
        # slots, same drag noise keys)
        raise ValueError("doppler needs a listener path")
    if sustained and "seed" in timeline:
        _reseed_sustained(session, timeline["seed"])
    # merged (block, order, fn, events) actions: slot-budgeted hit waves
    # (waves first at equal blocks — hits at an action block must be in
    # their slots when that block renders) + sustained state changes
    actions = [(b, 0, partial(_schedule_wave, evs=evs, model=model),
                len(evs))
               for b, evs in _hit_waves(session,
                                        timeline.get("events", []),
                                        n_blocks)]
    actions += [(min(int(round(float(ev.get("t", 0.0))
                              * SAMPLE_RATE / block)), n_blocks),
                 1, partial(_apply_sustained, ev=ev), 1)
                for ev in sustained]
    actions.sort(key=lambda a: (a[0], a[1]))
    groups = []
    for b, group in itertools.groupby(actions, key=lambda a: a[0]):
        group = list(group)
        groups.append((b, partial(_apply_actions,
                                  fns=[fn for _, _, fn, _ in group],
                                  events=sum(n for *_, n in group))))
    per_block = None
    if keyframes:
        per_block = listener_blocks(keyframes, n_blocks, block)
        if doppler:
            return session.render_doppler(
                per_block, blocks_per_dispatch=blocks_per_dispatch,
                smooth=smooth,
                state_events=groups,
                object_centers=timeline.get("objects"))
        if session.ffat is None or not session.use_transfer:
            # no transfer maps: the listener path only matters for Doppler
            if per_block.shape[0]:   # zero-duration: nothing to seed
                session.set_listener(per_block[0])
            per_block = None

    def render_range(b0: int, b1: int) -> np.ndarray | None:
        if b1 <= b0:
            return None
        if per_block is not None:
            return session.render_moving(
                per_block[b0:b1], blocks_per_dispatch=blocks_per_dispatch,
                smooth=smooth)
        return session.render_multi(
            b1 - b0, blocks_per_dispatch=blocks_per_dispatch)

    out, done = [], 0
    for b, apply in groups:
        seg = render_range(done, b)
        if seg is not None:
            out.append(seg)
        done = max(done, b)
        apply(session)
    seg = render_range(done, n_blocks)
    if seg is not None:
        out.append(seg)
    if not out:   # zero-duration timeline: empty audio, not a crash
        return np.zeros((0, int(session.gains.shape[-1])), np.float32)
    return np.concatenate(out, axis=0) if len(out) != 1 else out[0]


def main(argv=None) -> int:
    from .real_time_modal_sound import make_session
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--timeline", required=True, help="JSON timeline file")
    p.add_argument("--out", default="timeline.wav")
    p.add_argument("-d", dest="data_dir", default=FILE_NOT_EXIST)
    p.add_argument("-name", dest="obj_name", default=FILE_NOT_EXIST)
    p.add_argument("-m", dest="mesh", default=FILE_NOT_EXIST)
    p.add_argument("-s", dest="surf_mode", default=FILE_NOT_EXIST)
    p.add_argument("-t", dest="material", default=FILE_NOT_EXIST)
    p.add_argument("-p", dest="ffat_map", default=FILE_NOT_EXIST)
    p.add_argument("--block", type=int, default=DEFAULT_BLOCK)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "blocked", "scan", "pallas"])
    p.add_argument("--instances", type=int, default=1)
    p.add_argument("--no-transfer", action="store_true")
    p.add_argument("--listener", default="1.0,0.5,0.5")
    p.add_argument("--smooth-transfer", action="store_true")
    p.add_argument("--demo-synth", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--blocks-per-dispatch", type=int, default=64)
    args = p.parse_args(argv)
    with open(args.timeline) as f:
        timeline = json.load(f)
    model, session = make_session(args)
    audio = bake(session, timeline, model,
                 blocks_per_dispatch=args.blocks_per_dispatch)
    from ..runtime.audio import WavFileSink
    sink = WavFileSink(args.out, normalize=True)
    sink.write(audio)
    sink.close()
    print(json.dumps({
        "out": args.out,
        "samples": int(audio.shape[0]),
        "seconds": round(audio.shape[0] / SAMPLE_RATE, 3),
        "channels": int(audio.shape[1]),
        "events": len(timeline.get("events", [])),
        "peak": float(np.abs(audio).max()),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
