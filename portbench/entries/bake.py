"""The bake entry: render_timeline.bake, closed loop, one timeline after
another, each on a new session over the scene's bank and maps.

A sound designer bakes many timelines of one scene, each as the program
offers it: a new session (its state, slots and span tables built on first
use) with the timeline's listener, then ``bake``. A bake's time is from
the session's construction to the bake's return. The window holds every
bake until their summed time reaches the window's length; the timelines
are drawn between bakes, off the clock. Bakes are sampled for the check
by a reservoir drawn from the seed.

Parameters of the mix: ``duration_s`` of a timeline,
``blocks_per_dispatch``, the fixed ``listener``'s walk, and its event
families.
"""
from __future__ import annotations

import gc
import time
import traceback

import numpy as np

from .. import generator, scene
from ..recorder import Recorder

SAMPLED_BAKES = 2
WARM_INDEX = 1 << 30      # the set-up's bake, never a timed one


def _warm(cfg: dict, mix: dict, port: dict, inputs: dict, seed: int) -> None:
    """Set-up: the session's own warmup over every span length a bake
    takes (1-8 blocks and a whole dispatch, the drag's channel with a drag
    mix), then one whole bake of a timeline no timed bake draws, on a
    session of its own."""
    from openpbso_tpu_torch.apps.render_timeline import bake
    rows, timeline = generator.bake_timeline(mix, cfg, inputs, seed,
                                             WARM_INDEX)
    sess = scene.new_session(cfg, port, 0)
    sess.set_listener(rows)
    spans = tuple(range(1, 9)) + (mix["blocks_per_dispatch"],)
    sess.warmup(sustained=any(p["family"] == "drags" for p in mix["events"]),
                span_blocks=spans)
    sess = scene.new_session(cfg, port, 0)
    sess.set_listener(rows)
    bake(sess, timeline, blocks_per_dispatch=mix["blocks_per_dispatch"])


def _trace_renders(sess, windows: list, index: int, sync) -> None:
    """Time each of the session's renders (render_multi, the bake's
    dispatches) between two device synchronises: (start_ns, end_ns, bake
    index, sample clock, blocks, blocks a dispatch)."""
    render = sess.render_multi

    def traced(num_blocks, blocks_per_dispatch=16):
        sync()
        t0, clock = time.time_ns(), sess.sample_clock
        out = render(num_blocks, blocks_per_dispatch=blocks_per_dispatch)
        sync()
        windows.append((t0, time.time_ns(), index, clock, num_blocks,
                        blocks_per_dispatch))
        return out
    sess.render_multi = traced


def run(cell: dict, seed: int, seconds: float, tracer, t_proc: float,
        device) -> dict:
    import torch
    from openpbso_tpu_torch.apps.render_timeline import bake
    cfg, mix = cell["config"], cell["mix"]
    rate = cfg["sample_rate"]
    inputs = scene.make_inputs(cfg, seed)
    port = scene.port_scene(cfg, inputs, device)
    if tracer is not None:
        tracer.start()
    _warm(cfg, mix, port, inputs, seed)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    sync()
    pick = np.random.default_rng([int(seed), 0x5A3F])
    kept, renders, bakes = [], [], []
    audio_s = busy = 0.0
    started = failed = 0
    gc.collect()
    gc.freeze()       # the set-up's objects: no collection scans them again
    if tracer is not None:
        tracer.mark()
    setup_s = time.perf_counter() - t_proc
    while busy < seconds:
        rows, timeline = generator.bake_timeline(mix, cfg, inputs, seed,
                                                 started)
        t = time.perf_counter()
        t_ns = time.time_ns()
        started += 1
        sess = scene.new_session(cfg, port, 0)
        rec = Recorder(sess)
        rec.on = True
        if tracer is not None:
            _trace_renders(sess, renders, len(bakes), sync)
        try:
            sess.set_listener(rows)
            out = bake(sess, timeline,
                       blocks_per_dispatch=mix["blocks_per_dispatch"])
        except Exception:      # a bake that raised is a failed bake
            traceback.print_exc()
            failed += 1
            out = None
        dt = time.perf_counter() - t
        busy += dt
        rec.close()
        sess.__dict__.pop("render_multi", None)
        del sess
        bakes.append((t_ns, time.time_ns(), rec.events if tracer else None))
        if out is None:
            continue
        audio_s += out.shape[0] / rate
        item = dict(audio=out, events=rec.events, ar_seed=timeline["seed"])
        n = started - failed - 1
        if len(kept) < SAMPLED_BAKES:
            kept.append(item)
        else:
            j = int(pick.integers(0, n + 1))
            if j < SAMPLED_BAKES:
                kept[j] = item
    if tracer is not None:
        tracer.stop()
    return dict(setup_s=setup_s, attempted=started, failed=failed,
                values={"render_rt_factor": audio_s / busy}, items=kept,
                record=dict(renders=renders, bakes=bakes), keep=[port])


def host_spans(rec: dict) -> list:
    """What the host was doing, innermost first: inside a render, outside
    one in a bake (scheduling the timeline's events), between bakes (the
    next timeline drawn)."""
    return [[("render", a, b) for a, b, *_ in rec["renders"]],
            [("bake outside renders", a, b) for a, b, _ in rec["bakes"]],
            [("between bakes", rec["t0_ns"], rec["t1_ns"])]]
