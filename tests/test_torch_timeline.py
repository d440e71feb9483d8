"""The port's timeline baker (openpbso_tpu_torch.apps.render_timeline)
against openpbso_tpu/apps/render_timeline.py: listener keyframes and the
slot-budgeted hit waves bitwise, ``bake`` of the same timeline JSON at
<= -100 dB (hits, keyframes with and without ramps, Doppler, drags with a
retune, more hits than slots, zero duration), "bake what you played" from
the port's own engine, and the CLI. Nothing here asserts a wall-clock
rate.
"""
import contextlib
import json
import time
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.apps import render_timeline as jtl
from openpbso_tpu.ops.coeffs import bank_from_material as j_bank
from openpbso_tpu.ops.coeffs import lambda_from_modes
from openpbso_tpu.ops.ffat import build_ffat as j_build_ffat
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube, synth_mode_data
from openpbso_tpu_torch.apps import render_timeline as ttl
from openpbso_tpu_torch.config import SAMPLE_RATE
from openpbso_tpu_torch.ops.coeffs import bank_from_material
from openpbso_tpu_torch.ops.ffat import build_ffat
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from test_torch_batched_writes import assert_same_session

S = 128
MODES = 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MD = synth_mode_data(MODES, 8, seed=2)
MAPS = {i: synth_fatcube(i, float(f), n=8, seed=4)
        for i, f in enumerate(MD.frequencies_hz(CERAMIC.density))}


def sessions(ffat=False, lam=False, num_slots=16):
    """The same two-object session in both packages (port on the CPU)."""
    lam64 = (lambda_from_modes(CERAMIC.density, MD.omega_squared,
                               CERAMIC.alpha, CERAMIC.beta)[0]
             if lam else None)
    jb = j_bank(CERAMIC.density, MD.omega_squared, CERAMIC.alpha,
                CERAMIC.beta, num_objects=2, block_size=S, dtype=jnp.float32)
    js = JSession(jb, ffat=j_build_ffat(MAPS, jb.num_modes) if ffat
                  else None, lam64=lam64, num_slots=num_slots,
                  config=JConfig(block_size=S, backend="blocked"))
    tb = bank_from_material(CERAMIC.density, MD.omega_squared,
                            CERAMIC.alpha, CERAMIC.beta, num_objects=2,
                            block_size=S, device="cpu")
    ts = ModalSession(tb, ffat=build_ffat(MAPS, tb.num_modes, device="cpu")
                      if ffat else None, lam64=lam64, num_slots=num_slots,
                      config=SolverConfig(block_size=S, backend="blocked"))
    return js, ts


def space(k):
    return np.cos(0.7 * k + np.arange(MODES)).tolist()


@pytest.mark.parametrize("keys", [
    [{"t": 0.0, "pos": [0, 0, 0]}, {"t": 1.0, "pos": [2, 0, 0]}],
    [{"t": 0.5, "pos": [1, 2, 3]}, {"t": 0.1, "pos": [0, -1, 0.5]},
     {"t": 0.3, "pos": [4, 4, 4]}],
    [{"t": 0.2, "pos": [0.3, 0.2, 0.1]}],
])
def test_listener_blocks_bitwise(keys):
    for n in (1, 50, 400):
        assert np.array_equal(ttl.listener_blocks(keys, n, S),
                              jtl.listener_blocks(keys, n, S))
    with pytest.raises(ValueError):
        ttl.listener_blocks([], 4, S)


def test_hit_waves_bitwise():
    """More hits on one object than it has slots split into waves at the
    block of the first overflowing hit, as the JAX package splits them."""
    js, ts = sessions(num_slots=4)
    rng = np.random.default_rng(0)
    events = [{"t": float(rng.uniform(0, 0.5)), "obj": int(rng.integers(2)),
               "space": space(k)} for k in range(19)]
    tw = ttl._hit_waves(ts, events, 200)
    assert tw == jtl._hit_waves(js, events, 200)
    assert len(tw) >= 3 and sum(len(w) for _, w in tw) == 19


def tl_hits(duration=0.4, n=3, **extra):
    return dict({"duration_s": duration, "events": [
        {"t": 0.03 + 0.09 * k, "obj": k % 2, "space": space(k),
         "kind": ("point", "gaussian", "hertz")[k % 3],
         "width_us": 300.0 + 100 * k, "amp": 1.0 - 0.1 * k}
        for k in range(n)]}, **extra)


KEYS = [{"t": 0.0, "pos": [0.7, 0.3, 0.2]}, {"t": 0.2, "pos": [0.2, 0.5, 0.6]},
        {"t": 0.4, "pos": [1.1, 0.1, 0.3]}]
DRAG = [{"t": 0.05, "obj": 1, "action": "start", "space": space(9)},
        {"t": 0.12, "obj": 1, "action": "update", "space": space(10)},
        {"t": 0.18, "obj": 1, "action": "arparam", "a": [0.6, 0.2],
         "sigma": 0.003, "mu": 0.1},
        {"t": 0.3, "obj": 1, "action": "end"}]

TIMELINES = {
    "hits": (tl_hits(), {}),
    "hits, span": (tl_hits(), {"lam": True}),
    "keyframes": (tl_hits(listener=KEYS, smooth=False), {"ffat": True}),
    "keyframes, ramped": (tl_hits(listener=KEYS), {"ffat": True}),
    "doppler": (tl_hits(listener=KEYS, doppler=True), {"ffat": True}),
    "drag": (tl_hits(sustained=DRAG, seed=5), {"lam": True}),
    "drag, doppler": (tl_hits(listener=KEYS, doppler=True, sustained=DRAG,
                              seed=5), {"ffat": True, "lam": True}),
    "more hits than slots": (tl_hits(duration=0.6, n=7), {"num_slots": 2}),
    "zero duration": ({"duration_s": 0.0, "events": []}, {}),
}


@pytest.mark.parametrize("name", list(TIMELINES))
def test_bake_matches_jax(name, dberr):
    """One timeline JSON through both packages' bake: the same shape and
    <= -100 dB."""
    timeline, kw = TIMELINES[name]
    timeline = json.loads(json.dumps(timeline))     # as read from a file
    js, ts = sessions(**kw)
    if kw.get("ffat"):
        js.set_listener(np.array([0.7, 0.3, 0.2]))
        ts.set_listener(np.array([0.7, 0.3, 0.2]))
    j = np.asarray(jtl.bake(js, timeline, blocks_per_dispatch=8))
    t = ttl.bake(ts, timeline, blocks_per_dispatch=8)
    assert t.shape == j.shape and t.dtype == np.float32
    if name == "zero duration":
        assert t.shape == (0, 2)
        return
    assert float(np.abs(t).max()) > 0
    assert dberr(t, j) <= -100.0
    if name == "more hits than slots":
        # every hit sounded: the last one rings in the final blocks
        last = int(round(timeline["events"][-1]["t"] * SAMPLE_RATE / S)) * S
        assert float(np.abs(t[last:]).max()) > 0


@pytest.mark.parametrize("name", list(TIMELINES))
def test_bake_batched_is_bitwise_the_calls_one_by_one(name):
    """The bake's batched event writes against the same bake with every
    event written at once: the audio, each state leaf and each host
    mirror bitwise."""
    timeline, kw = TIMELINES[name]
    timeline = json.loads(json.dumps(timeline))
    (_, batched), (_, one) = sessions(**kw), sessions(**kw)
    one.batched_writes = contextlib.nullcontext
    out = []
    for sess in (one, batched):
        if kw.get("ffat"):
            sess.set_listener(np.array([0.7, 0.3, 0.2]))
        out.append(ttl.bake(sess, timeline, blocks_per_dispatch=8))
    assert out[0].dtype == out[1].dtype and np.array_equal(*out)
    assert_same_session(one, batched)
    if timeline["events"]:
        assert batched.event_writes < one.event_writes


def test_bake_schedules_events_quantized_and_validates_first():
    js, ts = sessions()
    events = [{"t": 0.25, "obj": 0, "space": space(0), "kind": "point"}]
    assert ttl.schedule_events(ts, events) == 1
    audio = ttl.bake(ts, {"duration_s": 0.4, "events": []})
    first = int(round(0.25 * SAMPLE_RATE / S)) * S
    assert np.abs(audio[:first]).max() == 0.0
    assert np.abs(audio[first:]).max() > 0.0
    with pytest.raises(ValueError, match="needs 'space'"):
        ttl.schedule_events(ts, [{"t": 0.0, "vertex": 1}])
    # doppler without a listener path fails before the session changes
    _, fresh = sessions()
    key = fresh.state.sustained.key.clone()
    with pytest.raises(ValueError, match="listener"):
        ttl.bake(fresh, {"duration_s": 0.1, "doppler": True,
                         "sustained": DRAG, "seed": 9})
    assert torch.equal(fresh.state.sustained.key, key)


def test_record_and_bake_reproduces_the_port_stream(dberr):
    """'Bake what you played': the port's engine records hits, listener
    moves and a drag as they apply; its exported timeline bakes on a fresh
    session to the blocks the stream produced (<= -90 dB, -60 dB once
    the drag runs)."""
    from openpbso_tpu_torch.runtime.audio import RawCollectorSink
    from openpbso_tpu_torch.runtime.engine import StreamingEngine
    _, live = sessions(ffat=True, lam=True)
    live.set_listener(np.array([0.7, 0.3, 0.2]))
    engine = StreamingEngine(live, RawCollectorSink(), record=True)
    produced = []
    inner = engine._synth_once

    def tapped():
        blocks = inner()
        produced.extend(np.array(b) for b in blocks)
        return blocks
    engine._synth_once = tapped

    def wait_blocks(n):
        deadline = time.time() + 120
        while len(produced) < n and time.time() < deadline:
            time.sleep(0.005)
        assert len(produced) >= n
    engine.hit(0, np.asarray(space(0)), kind="gaussian", width_us=400.0)
    engine.start()
    wait_blocks(4)
    engine.set_listener(np.array([0.3, 0.5, 0.4]))
    engine.hit(1, np.asarray(space(1)))
    wait_blocks(len(produced) + 4)
    n_before = len(produced)
    engine.sustained_start(1, np.asarray(space(2)))
    wait_blocks(len(produced) + 6)
    engine.sustained_end(1)
    wait_blocks(len(produced) + 3)
    engine.stop()
    assert engine.error is None
    timeline = json.loads(json.dumps(engine.export_timeline()))
    assert len(timeline["events"]) == 2 and timeline["sustained"]
    _, fresh = sessions(ffat=True, lam=True)
    fresh.set_listener(np.array([0.7, 0.3, 0.2]))
    baked = ttl.bake(fresh, timeline)
    live_audio = np.concatenate(produced)
    n = min(baked.shape[0], live_audio.shape[0])
    assert n >= (n_before + 6) * S
    assert dberr(baked[:n_before * S], live_audio[:n_before * S]) <= -90.0
    assert dberr(baked[:n], live_audio[:n]) <= -60.0


def test_cli_end_to_end(tmp_path):
    """render_timeline's main on a generated model, --device cpu, with a
    vertex-addressed hit and a Doppler listener path."""
    tl = {"duration_s": 0.3,
          "events": [{"t": 0.05, "obj": 0, "vertex": 3,
                      "kind": "gaussian", "width_us": 300.0}],
          "listener": [{"t": 0.0, "pos": [0.6, 0.4, 0.2]},
                       {"t": 0.3, "pos": [0.2, 0.4, 0.6]}],
          "doppler": True}
    tpath = tmp_path / "tl.json"
    tpath.write_text(json.dumps(tl))
    out = tmp_path / "baked.wav"
    assert ttl.main(["--timeline", str(tpath), "--out", str(out),
                     "--demo-synth", "--device", "cpu", "--block",
                     "128"]) == 0
    with wave.open(str(out)) as w:
        assert w.getframerate() == SAMPLE_RATE
        assert w.getnframes() >= int(0.3 * SAMPLE_RATE)
