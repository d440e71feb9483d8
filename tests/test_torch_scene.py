"""Port parity: Scene (openpbso_tpu_torch.models.scene) against the JAX
package, and the spatial slice as a whole.

The same model directories load into both packages. Scene's geometry (the
relative rows, the listener frame, the path rows) is bitwise the JAX
Scene's; its renders (shared and heterogeneous banks, pan and 1/r gains,
binaural and listener_offsets rows, the replicated layout, live object
moves, render_moving and render_doppler) agree to <= -100 dB; checkpoints
restore bitwise (tests/test_scene.py, tests/test_multilistener.py:134-309).
The last tests run a binaural ITD Scene per block, by span and through the
streaming engine with a DopplerPostMix, each against the JAX package.
"""
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.io.meta import resolve_model_dir as j_resolve
from openpbso_tpu.models.modal_model import load_model as j_load
from openpbso_tpu.models.scene import Scene as JScene
from openpbso_tpu.models.scene import SceneInstance as JInstance
from openpbso_tpu.ops.doppler import DopplerPostMix as JDoppler
from openpbso_tpu.runtime.audio import RawCollectorSink as JCollector
from openpbso_tpu.runtime.engine import StreamingEngine as JEngine
from openpbso_tpu_torch.io.meta import resolve_model_dir as t_resolve
from openpbso_tpu_torch.models import Scene as TScene
from openpbso_tpu_torch.models import SceneInstance as TInstance
from openpbso_tpu_torch.models.modal_model import load_model as t_load
from openpbso_tpu_torch.ops.doppler import DopplerPostMix as TDoppler
from openpbso_tpu_torch.runtime.audio import RawCollectorSink
from openpbso_tpu_torch.runtime.checkpoint import load_state, save_state
from openpbso_tpu_torch.runtime.engine import StreamingEngine
from openpbso_tpu_torch.utils.synth import synth_model_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 128


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two models (12 and 20 modes) loaded by both packages from the same
    directories: {"j": (a, b), "t": (a, b)}."""
    out = {"j": [], "t": []}
    for name, n_modes, seed in (("a", 12, 1), ("b", 20, 2)):
        root = str(tmp_path_factory.mktemp(f"model_{name}"))
        synth_model_dir(root, name, num_modes=n_modes, subdivisions=1,
                        ffat_n=8, seed=seed)
        out["j"].append(j_load(j_resolve(root, name)))
        out["t"].append(t_load(t_resolve(root, name)))
    return out


def _scenes(models, layout, **kw):
    """The same Scene in both packages: ``layout`` [(model index, position,
    gain, pan)]."""
    kw = dict(block_size=S, backend="blocked", **kw)
    j = JScene([JInstance(models["j"][m], np.asarray(p, np.float64), g, pan)
                for m, p, g, pan in layout], dtype=jnp.float32, **kw)
    t = TScene([TInstance(models["t"][m], np.asarray(p, np.float64), g, pan)
                for m, p, g, pan in layout], device="cpu", **kw)
    return j, t


TWO = [(0, (0.0, 0.0, 0.0), 1.0, 0.0), (1, (1.0, 0.0, 0.0), 0.8, 0.5)]
THREE = TWO + [(0, (-0.6, 0.4, 0.2), 1.2, -0.3)]
OFFSETS = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.5, 0.0]])


def _play(scene, listener=(0.5, 0.8, 0.2), blocks=6, **listen):
    scene.set_listener(np.asarray(listener), **listen)
    scene.hit(0, 1)
    scene.hit(1, 5, kind="hertz", width_us=1500.0)
    return scene.render(blocks)


def test_shared_scene_matches_jax(models, dberr):
    layout = [(0, (0.0, 0.0, 0.0), 1.0, 0.0), (0, (2.0, 0.0, 0.0), 0.5, 0.0)]
    js, ts = _scenes(models, layout)
    assert ts.bank.shared_tables and ts.session.ffat.geom.shared
    ref, got = _play(js), _play(ts)
    assert got.shape == (6 * S, 2) and np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100


@pytest.mark.parametrize("attenuate", [False, True])
def test_hetero_scene_matches_jax(models, attenuate, dberr):
    """Different models in one batch: masked modes, per-object maps, pan
    and 1/r gains (tests/test_scene.py:44-75)."""
    js, ts = _scenes(models, THREE)
    assert not ts.bank.shared_tables and ts.bank.num_modes >= 20
    assert float(ts.bank.mask[0, 12:].sum()) == 0.0
    ref = _play(js, distance_attenuation=attenuate)
    got = _play(ts, distance_attenuation=attenuate)
    np.testing.assert_array_equal(ts.session.gains.numpy(),
                                  np.asarray(js.session.gains))
    assert dberr(got, ref) <= -100
    t = ts.session.state.transfer
    assert (t[0, :12].abs() > 0).all() and (t[1, :20].abs() > 0).all()


@pytest.mark.parametrize("kind", ["single", "binaural", "offsets",
                                  "replicated"])
def test_geometry_is_bitwise(models, kind):
    """Relative rows, the listener frame ([3] world point, [L, 3] world
    rows, rows passed through) and path rows: the JAX Scene's, bitwise."""
    kw = {"single": {}, "binaural": dict(binaural=True, ear_distance=0.3),
          "offsets": dict(listener_offsets=OFFSETS),
          "replicated": dict(binaural=True, shared_state=False)}[kind]
    js, ts = _scenes(models, THREE, **kw)
    assert ts.num_objects == js.num_objects
    assert ts.num_listeners == js.num_listeners
    assert ts.shared_state == js.shared_state
    np.testing.assert_array_equal(ts.positions, js.positions)
    np.testing.assert_array_equal(ts.session.gains.numpy(),
                                  np.asarray(js.session.gains))
    world = np.asarray([0.7, -1.1, 0.4])
    np.testing.assert_array_equal(ts._relative_rows(world),
                                  js._relative_rows(world))
    rows = np.random.default_rng(2).uniform(-1, 1, (ts.num_listeners, 3))
    passthrough = np.ones((ts.num_objects, 3))
    for pos in (world, rows, passthrough):
        np.testing.assert_array_equal(ts._listener_frame(pos),
                                      js._listener_frame(pos))
        np.testing.assert_array_equal(ts._last_world_listener,
                                      js._last_world_listener)
    path = np.stack([np.linspace(0.5, 1.5, 5), np.zeros(5), np.ones(5)], 1)
    objects = ts.positions[None] + 0.1 * np.arange(5)[:, None, None]
    np.testing.assert_array_equal(ts._relative_path(path, objects),
                                  js._relative_path(path, objects))
    np.testing.assert_array_equal(ts._relative_path(path, None),
                                  js._relative_path(path, None))
    with pytest.raises(ValueError, match="object_paths"):
        ts._relative_path(path, objects[:, :1])
    with pytest.raises(ValueError, match="listener_path"):
        ts._relative_path(path[:, :2], None)


@pytest.mark.parametrize("kind", ["binaural", "offsets"])
def test_listener_rows_scene_matches_jax(models, kind, dberr):
    """Shared-state listener rows: one channel per listener, each from its
    own lookups (tests/test_scene.py:113-160)."""
    kw = (dict(binaural=True, ear_distance=0.4) if kind == "binaural"
          else dict(listener_offsets=OFFSETS))
    js, ts = _scenes(models, TWO, **kw)
    nl = 2 if kind == "binaural" else 3
    assert ts.session.num_listeners == nl and ts.num_objects == 2
    assert ts.session.gains.shape == (2, nl)
    ref, got = _play(js, (0.9, 0.1, 0.2)), _play(ts, (0.9, 0.1, 0.2))
    assert got.shape == (6 * S, nl)
    assert dberr(got, ref) <= -100
    assert not np.allclose(got[:, 0], got[:, 1])
    t = ts.session.state.transfer
    assert t.shape == (nl, 2, ts.bank.num_modes)
    assert not torch.allclose(t[0, 0, :12], t[1, 0, :12])


def test_shared_state_matches_replicated(models, dberr):
    """The shared-state layout renders what the replicated one does, and
    the replicated layout matches the JAX Scene's
    (tests/test_multilistener.py:134-166)."""
    _, shared = _scenes(models, TWO, binaural=True)
    jrep, rep = _scenes(models, TWO, binaural=True, shared_state=False)
    assert rep.num_objects == 4 and rep.session.num_listeners == 1
    outs = [_play(s, (0.9, 0.3, 0.2)) for s in (shared, rep, jrep)]
    assert dberr(outs[0], outs[1]) <= -100
    assert dberr(outs[1], outs[2]) <= -100


def test_set_listener_options_match_jax(models, dberr):
    """ear_axis turns the ears; 1/r gains per (object, channel) with
    listener rows, and the base gains back without attenuation."""
    js, ts = _scenes(models, TWO, binaural=True)
    for s in (js, ts):
        s.set_listener(np.asarray([0.2, 1.2, 0.3]), ear_axis=(0.0, 1.0, 0.0),
                       distance_attenuation=True)
    np.testing.assert_array_equal(ts._ear_offsets, js._ear_offsets)
    np.testing.assert_array_equal(ts.session.gains.numpy(),
                                  np.asarray(js.session.gains))
    assert dberr(ts.session.state.transfer.numpy(),
                 np.asarray(js.session.state.transfer)) <= -100
    for s in (js, ts):
        s.set_listener(np.asarray([0.2, 1.2, 0.3]))
    np.testing.assert_array_equal(ts.session.gains.numpy(),
                                  np.asarray(js.session.gains))
    np.testing.assert_array_equal(ts.session.gains.numpy(),
                                  ts._base_gains.astype(np.float32))


def test_move_object_matches_jax(models, dberr):
    """A live object move recomputes the rows from the last world listener
    at once (tests/test_scene.py:172-218); per-client [L, 3] world rows
    reapply through the frame."""
    out = []
    for s in _scenes(models, TWO):
        s.set_listener(np.asarray([1.5, 0.4, 0.2]))
        s.hit(1, 3, kind="gaussian", width_us=400.0)
        first = s.render(2)
        s.move_object(1, np.asarray([3.0, -1.0, 0.5]))
        out.append(np.concatenate([first, s.render(3)]))
    assert dberr(out[1], out[0]) <= -100
    js, ts = _scenes(models, TWO, listener_offsets=OFFSETS[:2])
    rows = np.asarray([[1.0, 0.0, 0.0], [-1.0, 0.5, 0.0]])
    for s in (js, ts):
        s.session.set_listener(rows)
        s.move_object(0, np.asarray([0.2, 0.2, 0.2]))
    np.testing.assert_array_equal(ts._last_world_listener, rows)
    assert dberr(ts.session.state.transfer.numpy(),
                 np.asarray(js.session.state.transfer)) <= -100


def test_object_positions_follow_the_layout(models):
    js, ts = _scenes(models, TWO, binaural=True, shared_state=False)
    for s in (js, ts):
        s.set_object_position(1, np.asarray([4.0, 4.0, 4.0]))
    np.testing.assert_array_equal(ts.positions, js.positions)
    np.testing.assert_array_equal(ts.object_position(1), [4.0, 4.0, 4.0])
    np.testing.assert_array_equal(ts.positions[2:], [[4.0, 4.0, 4.0]] * 2)
    for call in (lambda: ts.object_position(2),
                 lambda: ts.set_object_position(2, np.zeros(3)),
                 lambda: ts.move_object(-1, np.zeros(3))):
        with pytest.raises(IndexError):
            call()
    _, single = _scenes(models, TWO)
    with pytest.raises(IndexError):
        single.object_position(2)


@pytest.mark.parametrize("kind", ["single", "binaural"])
def test_render_moving_matches_jax(models, kind, dberr):
    kw = dict(binaural=True) if kind == "binaural" else {}
    t = 6
    path = np.stack([np.linspace(2.0, 0.6, t), np.full(t, 0.3),
                     np.linspace(0.2, 0.8, t)], axis=1)
    out = []
    for s in _scenes(models, TWO, smooth_transfer=True, **kw):
        s.set_listener(path[0])
        s.hit(0, 2, kind="gaussian", width_us=400.0)
        objects = s.positions[None] + 0.05 * np.arange(t)[:, None, None]
        out.append(s.render_moving(path, objects, blocks_per_dispatch=4))
    assert out[1].shape == (t * S, 2) and np.abs(out[0]).max() > 0
    assert dberr(out[1], out[0]) <= -100


def test_render_doppler_matches_jax(models, dberr):
    t = 8
    path = np.stack([np.linspace(5.0, 2.0, t), np.full(t, 0.3),
                     np.full(t, 0.2)], axis=1)
    out = []
    for s in _scenes(models, TWO, binaural=True, itd=True):
        s.set_listener(path[0])
        s.hit(0, 2, kind="gaussian", width_us=400.0)
        out.append(s.render_doppler(path))
    assert out[1].shape == (t * S, 2) and np.abs(out[0]).max() > 0
    assert dberr(out[1], out[0]) <= -100


def test_refusals(models):
    (ma, _) = models["t"]
    from openpbso_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="does not split into 2 shards"):
        TScene([TInstance(ma, np.zeros(3))],
               mesh=make_mesh(2, 1, devices=["cpu"] * 2), device="cpu")
    with pytest.raises(ValueError, match="binaural or listener_offsets"):
        TScene([TInstance(ma, np.zeros(3))], binaural=True,
               listener_offsets=np.zeros((2, 3)), device="cpu")
    with pytest.raises(ValueError, match="itd"):
        TScene([TInstance(ma, np.zeros(3))], itd=True, device="cpu")
    with pytest.raises(ValueError, match="itd"):
        TScene([TInstance(ma, np.zeros(3))], binaural=True, itd=True,
               shared_state=False, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        TScene([], device="cpu")


def _compressed(model):
    """A model's maps through the uint8 quantisation (no image codec)."""
    from openpbso_tpu_torch.ops.ffat_fit import compress_map
    return {k: compress_map(v, jpeg_quality=None)
            for k, v in model.ffat_maps.items()}


def test_compressed_maps_through_the_constructor(models):
    """A Scene given each model's compressed maps and use_compressed reads
    bitwise the rows of a session whose maps were built with the same
    compressed maps (no session attribute set from outside); the raw
    texture gives other rows, and a count of map dicts that is not the
    models' is refused."""
    from openpbso_tpu_torch.ops.ffat import build_ffat_hetero
    from openpbso_tpu_torch.runtime.session import ModalSession
    ma, mb = models["t"]
    comp = [_compressed(ma), _compressed(mb)]
    insts = [TInstance(models["t"][m], np.asarray(p, np.float64), g, pan)
             for m, p, g, pan in THREE]
    ts = TScene(insts, block_size=S, binaural=True, compressed_maps=comp,
                use_compressed=True, device="cpu")
    assert ts.models == [ma, mb] and ts.session.use_compressed
    world = np.asarray([1.2, 0.5, 0.3])
    ts.set_listener(world)
    ffat = build_ffat_hetero([i.model.ffat_maps for i in insts],
                             ts.bank.num_modes, device="cpu",
                             compressed_maps=[comp[0], comp[1], comp[0]])
    sess = ModalSession(ts.bank, ffat, num_listeners=2)
    sess.set_use_compressed(True)
    sess.set_listener_relative(ts._relative_rows(world))
    assert torch.equal(ts.session.state.transfer, sess.state.transfer)
    sess.set_use_compressed(False)
    assert not torch.equal(ts.session.state.transfer, sess.state.transfer)
    with pytest.raises(ValueError, match="2 models"):
        TScene(insts, compressed_maps=comp[:1], device="cpu")


def test_served_scene_json_builds_the_binaural_itd_compressed_scene(
        monkeypatch, tmp_path):
    """apps/serve.py's scene JSON with "binaural", "itd" and "compressed"
    builds the Scene that the constructor builds from the same model and
    its uint8-compressed maps: its rows, both parts, bitwise."""
    import json

    from openpbso_tpu_torch.apps import serve
    from openpbso_tpu_torch.io.meta import read_meta
    monkeypatch.chdir(ROOT)
    with open("assets/demo/scene.json") as fh:
        desc = json.load(fh)
    desc.update(binaural=True, itd=True, compressed=True)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(desc))
    srv = serve.build_server(serve.parse_args(
        ["--scene", str(path), "--port", "0", "--block", "256",
         "--device", "cpu"]))
    try:
        got = srv._scene.session
    finally:
        srv.close()
    assert got.auto_itd and got.use_compressed and got.num_listeners == 2
    model = t_load(read_meta(desc["instances"][0]["meta"]))
    want = TScene([TInstance(model, np.asarray(i["position"], np.float64),
                             i["gain"], i["pan"]) for i in desc["instances"]],
                  block_size=256, binaural=True, itd=True,
                  compressed_maps=[_compressed(model)], use_compressed=True,
                  device="cpu")
    want.set_listener(np.asarray([1.0, 0.5, 0.5]))
    assert got.state.transfer_im is not None
    assert torch.equal(got.state.transfer, want.session.state.transfer)
    assert torch.equal(got.state.transfer_im, want.session.state.transfer_im)


def test_checkpoint_roundtrip_and_shape_mismatch(models, tmp_path):
    """A restored state continues bitwise; another object axis is refused
    (tests/test_scene.py:78-110)."""
    _, ts = _scenes(models, TWO, binaural=True, itd=True)
    ts.set_listener(np.asarray([1.0, 0.5, 0.2]))
    ts.hit(0, 2)
    ts.render(2)
    path = str(tmp_path / "scene.npz")
    save_state(path, ts.session.state)
    want = ts.render(3)
    _, again = _scenes(models, TWO, binaural=True, itd=True)
    again.set_listener(np.asarray([1.0, 0.5, 0.2]))   # complex rows too
    again.session.state = load_state(path, again.session.state)
    np.testing.assert_array_equal(again.render(3), want)
    _, bigger = _scenes(models, THREE, binaural=True, itd=True)
    bigger.set_listener(np.asarray([1.0, 0.5, 0.2]))
    with pytest.raises(ValueError, match="shape"):
        load_state(path, bigger.session.state)


def _spatial(models):
    return _scenes(models, THREE, binaural=True, itd=True,
                   smooth_transfer=True)


def _script(scene, render):
    scene.set_listener(np.asarray([2.0, 0.5, 0.3]))
    scene.hit(0, 1, kind="gaussian", width_us=600.0)
    scene.hit(2, 4, kind="point")
    first = render(scene, 8)
    scene.set_listener(np.asarray([1.5, -0.8, 0.3]))
    return np.concatenate([first, render(scene, 8)])


def test_slice_per_block_and_by_span(models, dberr):
    """The binaural ITD Scene per block and by span (16 blocks in spans of
    4, complex listener rows on the span's kernels' twins): each against
    the JAX Scene, and span against per block."""
    js, ts = _spatial(models)
    ref = _script(js, lambda s, n: s.render(n))
    got = _script(ts, lambda s, n: s.render(n))
    assert got.shape == (16 * S, 2) and np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100
    js, ts = _spatial(models)
    assert ts.session.span_eligible()
    span_ref = _script(js, lambda s, n: s.render_multi(
        n, blocks_per_dispatch=4))
    span = _script(ts, lambda s, n: s.render_multi(n, blocks_per_dispatch=4))
    assert dberr(span, span_ref) <= -100
    assert dberr(span, got) <= -90


def _stream(engine, scene, n_blocks):
    produced = []
    inner = engine._synth_once

    def tapped():
        blocks = inner()
        produced.extend(np.array(b) for b in blocks)
        return blocks
    engine._synth_once = tapped
    engine.set_listener(np.asarray([2.0, 0.5, 0.3]))
    engine.hit(0, scene.instances[0].model.modal_force_vertex(1),
               kind="gaussian", width_us=600.0)
    engine.hit(2, scene.instances[2].model.modal_force_vertex(4))
    engine.start()
    deadline = time.time() + 120.0
    while len(produced) < n_blocks and time.time() < deadline:
        time.sleep(0.01)
    engine.stop()
    assert engine.error is None
    return np.concatenate(produced[:n_blocks])


@pytest.mark.parametrize("lookahead", [1, 4])
def test_slice_through_the_engine_with_doppler(models, lookahead, dberr):
    """The binaural ITD Scene streamed by each package's engine through
    its DopplerPostMix (two delay lines per object, the scene's gains): the
    first blocks agree to <= -100 dB. The engine's listener events reach
    the scene through its listener frame."""
    js, ts = _spatial(models)
    j = _stream(JEngine(js.session, JCollector(), lookahead=lookahead,
                        post_mix=JDoppler(js.positions, num_listeners=2,
                                          gains=js.session.gains)), js, 12)
    t = _stream(StreamingEngine(ts.session, RawCollectorSink(),
                                lookahead=lookahead,
                                post_mix=TDoppler(ts.positions,
                                                  num_listeners=2,
                                                  gains=ts.session.gains,
                                                  device="cpu")), ts, 12)
    assert t.shape == (12 * S, 2) and np.abs(j).max() > 0
    assert dberr(t, j) <= -100
    assert ts._last_world_listener is not None
    assert ts.session._last_listener.shape == (2, 3, 3)
