"""The binaural ITD scene streamed by the port's engine against the
benchmark's plain reference (portbench/reference/binaural.py), on the CPU.

A tiny scene of the spatial-256x1024 configuration's kind (2 models x 2
instances x 16 modes, 64-sample blocks, arrays from a seed) is built only
through Scene's constructor, with binaural ears, interaural time
differences, smoothed moves and the compressed maps read from the start,
and streamed by StreamingEngine on the span path: hits, a drag and three
head moves put to the engine's public methods at fixed blocks. The
reference replays the events the session applied. The comparison sees
the mechanism: the reference without the interaural phase, or reading the
raw texture, misses its tolerance by at least ten times; at zero ear
spacing both ears are the accepted mono reference's mix.
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from openpbso_tpu_torch.runtime.audio import RawCollectorSink  # noqa: E402
from openpbso_tpu_torch.runtime.engine import StreamingEngine  # noqa: E402
from portbench import scene as pb_scene  # noqa: E402
from portbench.events.head import clear_world  # noqa: E402
from portbench.recorder import Recorder  # noqa: E402
from portbench.reference import binaural, replay  # noqa: E402
from portbench.scenes import spatial_scene  # noqa: E402

S = 64
SEED = 2 ** 31 + 2020
BLOCKS = 18
# the float32 program (its span's states and phases rounded to 2^-24)
# against the float64 reference reads ~4e-7 on this stream: 2e-5 leaves it
# 50x of room and stays 30x under the finest difference the comparison has
# to see (the compressed against the raw texture, ~6e-4)
TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw) -> dict:
    cfg = pb_scene.load_config("spatial-256x1024")
    return dict(cfg, models=2, objects=4, modes=16, block_size=S,
                contact_rows=8, **kw)


def _stream(cfg: dict, inputs: dict):
    """(the engine's blocks [N, 2], the session's applied events)."""
    port = spatial_scene.port_scene(cfg, inputs, "cpu")
    sess = spatial_scene.new_session(cfg, port, SEED % (1 << 31))
    heads = [clear_world(np.asarray(p), inputs["centers"],
                         spatial_scene.ear_offsets(cfg))
             for p in ((1.3, 0.4, 1.6), (0.7, -0.9, 1.5), (-0.8, 1.1, 1.6))]
    con = inputs["contacts"]
    due = {
        1: [("hit", (0, con[0]), dict(kind="gaussian", width_us=600.0)),
            ("hit", (3, con[1]), dict(kind="hertz", width_us=1500.0,
                                      amp=0.7))],
        2: [("sustained_start", (1, con[2]), {})],
        5: [("set_listener", (heads[1],), {})],
        7: [("hit", (2, con[3]), dict(kind="point"))],
        9: [("set_listener", (heads[2],), {}),
            ("sustained_update", (1, con[4]), {})],
        13: [("sustained_end", (1,), {})],
    }
    rec = Recorder(sess)
    rec.on = True
    sess.set_listener(heads[0])
    engine = StreamingEngine(sess, RawCollectorSink(), lookahead=1)
    produced = []
    apply, synth = engine._apply_events, engine._synth_once

    def fed_apply():
        for method, args, kw in due.get(len(produced), ()):
            getattr(engine, method)(*args, **kw)
        apply()

    def tapped():
        blocks = synth()
        produced.extend(np.array(b) for b in blocks)
        return blocks
    engine._apply_events, engine._synth_once = fed_apply, tapped
    engine.start()
    deadline = time.time() + 120.0
    while len(produced) < BLOCKS and time.time() < deadline:
        time.sleep(0.01)
    engine.stop()
    assert engine.error is None and len(produced) >= BLOCKS
    assert sess.span_eligible()
    return np.concatenate(produced), rec.events


def _reference(cfg, inputs, audio, events, **scene_kw):
    ref_scene = dict(spatial_scene.reference_scene(cfg, inputs), **scene_kw)
    return binaural.render(ref_scene, events, audio.shape[0] // S,
                           ar_seed=SEED % (1 << 31), smooth=True)


@pytest.fixture(scope="module")
def streamed():
    cfg = _cfg()
    inputs = spatial_scene.make_inputs(cfg, SEED)
    audio, events = _stream(cfg, inputs)
    return cfg, inputs, audio, events


def test_both_ears_match_the_reference(streamed):
    cfg, inputs, audio, events = streamed
    assert audio.shape[1] == 2
    assert [e[1] for e in events].count("listener") == 3
    assert {"hit", "drag"} <= {e[1] for e in events}
    ref = _reference(cfg, inputs, audio, events)
    # the ears differ: their rows, delays and so their channels
    assert np.abs(ref[:, 0] - ref[:, 1]).max() > 0.05 * np.abs(ref).max()
    assert binaural.rel_err(audio, ref) <= TOL


@pytest.mark.parametrize("without", ["itd", "compressed texture"])
def test_the_comparison_sees_the_mechanism(streamed, without):
    """The reference without the interaural phase, or reading the raw
    texture in place of the compressed one, misses the tolerance by at
    least ten times."""
    cfg, inputs, audio, events = streamed
    if without == "itd":
        kw = dict(itd=False)
    else:
        ref_scene = spatial_scene.reference_scene(cfg, inputs)
        kw = dict(maps=[dict(mp, psi=raw) for mp, raw in zip(
            ref_scene["maps"], ref_scene["raw_psi"])])
    wrong = _reference(cfg, inputs, audio, events, **kw)
    assert binaural.rel_err(audio, wrong) >= 10 * TOL


def test_zero_ear_spacing_gives_the_mono_mix_on_both_ears():
    """Both ears at the head, one map set for both models and unit gains:
    each of the program's channels and of the binaural reference's is the
    accepted mono reference's mix (replay.render, the rows each object's
    offset from the head)."""
    cfg = _cfg(ear_distance_m=0.0,
               instance_gain=dict(base=1.0, step=0.0, cycle=1))
    inputs = spatial_scene.make_inputs(cfg, SEED)
    inputs["maps"][1] = inputs["maps"][0]
    audio, events = _stream(cfg, inputs)
    ours = _reference(cfg, inputs, audio, events)
    ref_scene = spatial_scene.reference_scene(cfg, inputs)
    mono_scene = dict(ref_scene, maps=ref_scene["maps"][0],
                      omega_sq=ref_scene["omega_sq"][inputs["model_of"]])
    mono_events = [(c, op, dict(rows=np.asarray(kw["rows"])[None]
                                - inputs["centers"]) if op == "listener"
                    else kw) for c, op, kw in events]
    mono = replay.render(mono_scene, mono_events, audio.shape[0] // S,
                         ar_seed=SEED % (1 << 31), smooth=True)
    np.testing.assert_array_equal(audio[:, 0], audio[:, 1])
    for ch in range(2):
        assert binaural.rel_err(ours[:, ch:ch + 1], mono[:, None]) <= 1e-12
        assert binaural.rel_err(audio[:, ch:ch + 1], mono[:, None]) <= TOL
