"""Port parity: ShardedSession (openpbso_tpu_torch.parallel) against the
JAX package's on the 8-device CPU mesh.

Every case of tests/test_sharded_session.py runs here too, the port's
sharded session held against the JAX package's sharded session where the
JAX test compares one, at <= -100 dB (the span with drags included). The
port's mesh names "cpu" for each of its cells. The checks this file adds
hold the port's sharded session against its unsharded one: exactly one
reduction per span dispatch, a hit routed to the last shard, a batch of
event writes routed row by row, a checkpoint round trip, and a complex row
fading to a real one. Long spans through the port's flat tables are held
against the JAX package's unsharded session, whose default tables take its
two-level superchunk scan on a shared bank (its sharded session raises on
those tables).
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.parallel import ShardedSession as JSharded
from openpbso_tpu.parallel import make_mesh as j_make_mesh
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy, ffat_from_numpy
from openpbso_tpu_torch.parallel import ShardedSession, make_mesh, sharding
from openpbso_tpu_torch.runtime.audio import RawCollectorSink
from openpbso_tpu_torch.runtime.engine import StreamingEngine
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from test_torch_batched_writes import assert_same_session

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

S = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(shape):
    return make_mesh(*shape, devices=["cpu"] * 8)


def _bank(o=8, m=12, hetero=False):
    """(JAX bank, lam64) of test_sharded_session._pair."""
    if hetero:
        parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
            m, 6, seed=70 + i, f_low=90.0 + 5 * i,
            f_high=8000.0 + 40 * i).omega_squared, CERAMIC.alpha,
            CERAMIC.beta) for i in range(o)]
        lam64, b, v = (np.stack(x) for x in zip(*parts))
        bank = build_modal_bank(lam64, b, v, block_size=S, shared=False,
                                dtype=jnp.float32)
        return bank, lam64
    md = synth_mode_data(m, 6, seed=70)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                              block_size=S, dtype=jnp.float32)
    return bank, lam64


def _tbank(jbank):
    return bank_from_numpy(jax.tree.map(np.asarray, jbank), device="cpu")


def _pair(mesh_shape, o=8, m=12, hetero=False, smooth=False,
          reference="jax", num_listeners=1):
    """(the port's sharded session, its reference, m): the reference is
    the JAX package's sharded session on the same mesh shape, or with
    ``reference="port"`` the port's unsharded session."""
    jbank, lam64 = _bank(o, m, hetero)
    if num_listeners > 1:
        lam64 = np.broadcast_to(lam64, (o, lam64.shape[-1]))
    kw = dict(num_slots=4, lam64=lam64, num_listeners=num_listeners)
    sh = ShardedSession(_tbank(jbank), _cpu_mesh(mesh_shape),
                        config=SolverConfig(block_size=S, backend="blocked",
                                            smooth_transfer=smooth), **kw)
    if reference == "port":
        ref = ModalSession(_tbank(jbank), config=SolverConfig(
            block_size=S, backend="blocked", smooth_transfer=smooth), **kw)
    else:
        ref = JSharded(jbank, j_make_mesh(*mesh_shape),
                       config=JConfig(block_size=S, backend="blocked",
                                      smooth_transfer=smooth),
                       dtype=jnp.float32, **kw)
    return sh, ref, m


def _blocks(sess, n):
    return np.concatenate([np.asarray(sess.step()[1]) for _ in range(n)])


@pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4)])
def test_sharded_session_stream_parity(mesh_shape, dberr):
    """Hits, the per-block prefix, spans, and the ring-down's decay span."""
    sh, ref, m = _pair(mesh_shape)
    space = np.linspace(0.2, 1.0, m)
    for s in (sh, ref):
        s.hit(2, space, kind="gaussian", width_us=300.0)
        s.hit(5, -space)
    assert dberr(_blocks(sh, 3), _blocks(ref, 3)) <= -100
    a = sh.render_multi(8, blocks_per_dispatch=4)
    b = ref.render_multi(8, blocks_per_dispatch=4)
    assert dberr(a, b) <= -100
    a = sh.render_multi(6, blocks_per_dispatch=3)
    b = ref.render_multi(6, blocks_per_dispatch=3)
    assert sh._idle() and ref._idle()
    assert dberr(a, b) <= -100
    assert sh.state.block_start == sh.sample_clock == 17 * S


def test_sharded_session_hetero_span(dberr):
    sh, ref, m = _pair((4, 2), hetero=True)
    space = np.linspace(0.5, 1.5, m)
    for s in (sh, ref):
        s.hit(1, space, kind="gaussian", width_us=250.0)
    a = sh.render_multi(8, blocks_per_dispatch=8)
    b = ref.render_multi(8, blocks_per_dispatch=8)
    assert np.abs(b).max() > 0
    assert dberr(a, b) <= -100


@pytest.fixture(scope="module")
def model_ffat(synth_model_root):
    """The synthetic model's bank (8 objects), lam64, FFAT maps in both
    packages and a modal force vector."""
    from openpbso_tpu.io.meta import resolve_model_dir
    from openpbso_tpu.models.modal_model import load_model
    from openpbso_tpu.ops.ffat import build_ffat
    model = load_model(resolve_model_dir(synth_model_root, "synth"))
    n = model.num_modes_audible
    lam64, _, _ = lambda_from_modes(
        model.material.density, model.modes.omega_squared[:n],
        model.material.alpha, model.material.beta)
    jbank = bank_from_material(
        model.material.density, model.modes.omega_squared[:n],
        model.material.alpha, model.material.beta, num_objects=8,
        block_size=S, dtype=jnp.float32)
    jffat = build_ffat(model.ffat_maps, num_modes=jbank.num_modes,
                       dtype=jnp.float32)
    tffat = ffat_from_numpy(jax.tree.map(np.asarray, jffat), device="cpu")
    return jbank, lam64, (jffat, tffat), model.modal_force_vertex(3)


def test_sharded_session_xfade_and_sustained(model_ffat, dberr):
    """A listener move's transfer ramp and the sustained channel, per
    block on the (4, 2) mesh."""
    jbank, lam64, ffat, space = model_ffat
    cfg = dict(block_size=S, backend="blocked", smooth_transfer=True)
    sh = ShardedSession(_tbank(jbank), _cpu_mesh((4, 2)), ffat=ffat[1],
                        config=SolverConfig(**cfg), num_slots=4,
                        lam64=lam64)
    ref = JSharded(jbank, j_make_mesh(4, 2), ffat=ffat[0],
                   config=JConfig(**cfg), num_slots=4, lam64=lam64,
                   dtype=jnp.float32)
    out = []
    for s in (sh, ref):
        s.set_listener(np.array([1.4, 0.1, 0.2]))
        s.hit(0, space)
        blocks = [np.asarray(s.step()[1])]
        s.set_listener(np.array([0.2, 1.3, -0.4]))   # pends an xfade block
        assert s._xfade_from is not None
        blocks += [np.asarray(s.step()[1]) for _ in range(2)]
        s.sustained_start(3, space)
        blocks += [np.asarray(s.step()[1])]
        s.sustained_end(3)
        out.append(np.concatenate(blocks))
    assert np.abs(out[1]).max() > 0
    assert dberr(out[0], out[1]) <= -100


def test_sharded_engine_soak(dberr):
    """StreamingEngine over the port's ShardedSession at lookahead=2 (the
    JAX soak's setting): hits before start() apply at block 0, live hits
    follow, and the stream's first blocks equal an offline render of the
    start() hits on the unsharded session."""
    sh, ref, m = _pair((4, 2), reference="port")
    space = np.linspace(0.2, 1.0, m)
    eng = StreamingEngine(sh, RawCollectorSink(), lookahead=2)
    produced = []
    inner = eng._synth_once

    def tapped():
        blocks = inner()
        produced.extend(np.array(b) for b in blocks)
        return blocks
    eng._synth_once = tapped
    eng.hit(0, space, kind="gaussian", width_us=400.0)
    eng.start()
    try:
        # the live hits follow the first dispatch (the two blocks held
        # against the offline render), whenever the synthesis thread runs
        deadline = time.time() + 120
        while len(produced) < 2 and time.time() < deadline:
            time.sleep(0.01)
        for i in (1, 2):
            eng.hit(i, space, kind="gaussian", width_us=400.0)
        while len(produced) < 24 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert eng.error is None and len(produced) >= 24
    audio = np.concatenate(produced)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    ref.hit(0, space, kind="gaussian", width_us=400.0)
    want = ref.render_multi(2, blocks_per_dispatch=2)
    assert dberr(np.concatenate(produced[:2]), want) <= -100


def test_sharded_multi_listener_parity(dberr):
    """[L, O, M] listener rows (the listener axis replicated over the
    mesh) through the step, decay and span paths."""
    sh, ref, m = _pair((4, 2), num_listeners=3)
    rng = np.random.default_rng(8)
    rows = rng.uniform(0.5, 2.0, (3, 8, sh.bank.num_modes)).astype(
        np.float32)
    sh.state = dataclasses.replace(sh.state,
                                   transfer=torch.as_tensor(rows))
    ref.state = dataclasses.replace(ref.state, transfer=jnp.asarray(rows))
    from jax.sharding import NamedSharding, PartitionSpec as P
    ref.state = dataclasses.replace(ref.state, transfer=jax.device_put(
        ref.state.transfer, NamedSharding(ref.mesh, P(None, "obj", "mode"))))
    space = rng.standard_normal(m)
    for s in (sh, ref):
        s.hit(0, space, kind="gaussian", width_us=600.0)
        s.hit(5, -space)
    got, want = _blocks(sh, 3), _blocks(ref, 3)
    assert got.shape == want.shape == (3 * S, 3)
    assert dberr(got, want) <= -100
    got = sh.render_multi(40, blocks_per_dispatch=8)
    want = ref.render_multi(40, blocks_per_dispatch=8)
    assert dberr(got, want) <= -100


def test_scene_on_mesh(tmp_path, dberr):
    """Scene(mesh=...) builds a ShardedSession with the same construction
    surface; per block and by render_multi it matches the JAX package's
    Scene on its mesh."""
    from openpbso_tpu.io.meta import resolve_model_dir as j_resolve
    from openpbso_tpu.models.modal_model import load_model as j_load
    from openpbso_tpu.models.scene import Scene as JScene
    from openpbso_tpu.models.scene import SceneInstance as JInstance
    from openpbso_tpu.utils.synth import synth_model_dir
    from openpbso_tpu_torch.io.meta import resolve_model_dir as t_resolve
    from openpbso_tpu_torch.models import Scene, SceneInstance
    from openpbso_tpu_torch.models.modal_model import load_model as t_load

    root = str(tmp_path)
    synth_model_dir(root, "m", num_modes=12, subdivisions=1, ffat_n=8,
                    seed=41)
    jm, tm = j_load(j_resolve(root, "m")), t_load(t_resolve(root, "m"))
    pos = [np.asarray([0.3 * i, 0.0, 0.0]) for i in range(4)]

    def script(sc):
        sc.set_listener(np.asarray([0.7, 0.5, 0.3]))
        sc.hit(0, 3, kind="gaussian", width_us=600.0)
        sc.hit(2, 5)
        return np.concatenate([_blocks(sc.session, 2),
                               sc.render_multi(10, blocks_per_dispatch=5)])

    meshed = Scene([SceneInstance(tm, p) for p in pos], block_size=S,
                   backend="blocked", mesh=_cpu_mesh((4, 2)), device="cpu")
    assert isinstance(meshed.session, ShardedSession)
    assert meshed.bank.lam_re.device.type == "meta"   # only the shards
    got = script(meshed)
    jsc = JScene([JInstance(jm, p) for p in pos], block_size=S,
                 backend="blocked", mesh=j_make_mesh(4, 2),
                 dtype=jnp.float32)
    assert np.abs(got).max() > 0
    assert dberr(got, script(jsc)) <= -100


def _complex_rows(sess, seed):
    rng = np.random.default_rng(seed)
    o, mm = sess.bank.num_objects, sess.bank.num_modes
    return (rng.uniform(0.5, 2.0, (o, mm))
            * np.exp(1j * rng.uniform(-np.pi, np.pi, (o, mm))))


def test_sharded_complex_rows(dberr):
    """Complex transfer rows: install, step, span and decay."""
    sh, ref, m = _pair((2, 4))
    t = _complex_rows(sh, 21)
    for s in (sh, ref):
        s.set_complex_transfer(t)
        s.hit(1, np.linspace(0.3, 1.0, m), kind="gaussian", width_us=300.0)
    assert sh.state.transfer_im is not None
    assert dberr(_blocks(sh, 3), _blocks(ref, 3)) <= -100
    a = sh.render_multi(8, blocks_per_dispatch=4)
    b = ref.render_multi(8, blocks_per_dispatch=4)
    assert dberr(a, b) <= -100


def test_sharded_complex_xfade(dberr):
    """smooth_transfer with complex rows: a mid-stream
    set_complex_transfer ramps both channels."""
    sh, ref, m = _pair((4, 2), smooth=True)
    t0 = _complex_rows(sh, 22)
    t1 = t0 * np.exp(1j * np.random.default_rng(23).uniform(
        -1.0, 1.0, t0.shape))
    for s in (sh, ref):
        s.set_complex_transfer(t0)
        s.hit(0, np.linspace(0.2, 1.0, m), kind="gaussian", width_us=200.0)
        s.step()
        s.set_complex_transfer(t1)
        assert s._xfade_from is not None
    assert dberr(_blocks(sh, 2), _blocks(ref, 2)) <= -100


def test_sharded_complex_to_real_fade(dberr):
    """A complex row fading to a real one (a set_use_transfer(False) after
    complex rows, smooth_transfer on): the ramp reaches zero phase and the
    state drops its imaginary rows, as the unsharded session does."""
    sh, ref, m = _pair((2, 4), smooth=True, reference="port")
    t = _complex_rows(sh, 24)
    for s in (sh, ref):
        s.set_complex_transfer(t)
        s.hit(3, np.linspace(0.2, 1.0, m), kind="gaussian", width_us=200.0)
        s.step()
        s._xfade_from = s._current_transfer()
        s._install_transfer(torch.full_like(s._current_transfer()[0], 1e7),
                            None)
    got, want = _blocks(sh, 3), _blocks(ref, 3)
    assert sh.state.transfer_im is None
    assert dberr(got, want) <= -100


def test_sharded_sustained_span(dberr):
    """The AR(2) channel rides the mesh span: the same noise per object
    shard, and the per-block path continues alike afterwards."""
    sh, ref, m = _pair((8, 1))
    rng = np.random.default_rng(23)
    sus_space = rng.standard_normal(m)
    for s in (sh, ref):
        s.sustained_start(2, sus_space)
        s.sustained_start(5, np.linspace(-1, 1, m))
        s.hit(0, np.linspace(0.2, 1.0, m), kind="gaussian", width_us=300.0)
    assert sh.span_eligible() and ref.span_eligible()
    a = sh.render_multi(8, blocks_per_dispatch=4)
    b = ref.render_multi(8, blocks_per_dispatch=4)
    assert dberr(a, b) <= -100
    np.testing.assert_array_equal(
        sh.state.sustained.key.numpy(),
        np.asarray(ref.state.sustained.key).astype(np.int64))
    for s in (sh, ref):
        s.sustained_end(2)
    assert dberr(_blocks(sh, 2), _blocks(ref, 2)) <= -100


def test_sharded_session_hrtf_span_engine(dberr):
    """A span-capable post-mix (HRTF) on a mesh session: the engine takes
    the sharded sound span and process_span, and streams binaural audio
    equal to an offline render through a fresh post-mix."""
    from openpbso_tpu_torch.ops.hrtf import HRTFPostMix
    sh, ref, m = _pair((4, 2), reference="port")
    pos = np.random.default_rng(0).standard_normal((sh.bank.num_objects, 3))

    def post_mix():
        return HRTFPostMix(pos, block_size=S, n_taps=96, device="cpu")
    eng = StreamingEngine(sh, RawCollectorSink(), post_mix=post_mix(),
                          lookahead=4)
    produced = []
    inner = eng._synth_once

    def tapped():
        blocks = inner()
        produced.extend(np.array(b) for b in blocks)
        return blocks
    eng._synth_once = tapped
    eng.hit(0, np.ones(m), kind="gaussian", width_us=400.0)
    eng.start()
    try:
        deadline = time.time() + 120
        while len(produced) < 8 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert eng.error is None and len(produced) >= 8
    audio = np.concatenate(produced[:8])
    assert audio.shape[1] == 2 and np.abs(audio).max() > 0
    pm = post_mix()
    ref.hit(0, np.ones(m), kind="gaussian", width_us=400.0)
    want = np.concatenate([np.asarray(pm.process_span(
        ref._step_span_sound(4)).cpu()) for _ in range(2)])
    assert dberr(audio, want) <= -100


def test_sharded_span_sound_parity(dberr):
    """The sound span (the post-mix feed): excitation, sustained, decay."""
    sh, ref, m = _pair((4, 2))
    space = np.linspace(0.2, 1.0, m)
    for s in (sh, ref):
        s.hit(1, space, kind="gaussian", width_us=300.0)
        s.sustained_start(3, -space)
    a = np.asarray(sh._step_span_sound(4))
    b = np.asarray(ref._step_span_sound(4))
    assert a.shape == b.shape and np.abs(b).max() > 0
    assert dberr(a, b) <= -100
    for s in (sh, ref):
        s.sustained_end(3)
    assert dberr(np.asarray(sh._step_span_sound(4)),
                 np.asarray(ref._step_span_sound(4))) <= -100
    sh._expiry[...] = 0
    ref._expiry[...] = 0
    a = np.asarray(sh._step_span_sound(4))
    b = np.asarray(ref._step_span_sound(4))
    assert sh._idle() and ref._idle()
    assert dberr(a, b) <= -100


def test_sharded_retuned_sustained_span(dberr):
    """Retuned drags (per-object AR tables, split over 'obj') ride the
    mesh span too."""
    sh, ref, m = _pair((8, 1))
    sus_space = np.random.default_rng(29).standard_normal(m)
    for s in (sh, ref):
        s.set_ar_params(3, a=(0.9, 0.05), sigma=0.002, mu=0.1)
        s.sustained_start(3, sus_space)
    assert sh.span_eligible() and ref.span_eligible()
    assert sh._span_bucket(True) == 0
    a = sh.render_multi(8, blocks_per_dispatch=4)
    b = ref.render_multi(8, blocks_per_dispatch=4)
    assert np.abs(b).max() > 0
    assert dberr(a, b) <= -100


@pytest.mark.parametrize("layout", ["shared", "hetero"])
def test_sharded_long_span_matches_unsharded_jax(layout, dberr):
    """A (2, 2) sharded session's busy span and ring-down span against the
    JAX package's unsharded session: 256 blocks of 512-sample chunks (X =
    64) through the sharded session's own flat tables, split on the mode
    axis, where the JAX session's default tables carry superchunk powers
    (G = 32) on the shared bank."""
    hetero = layout == "hetero"
    jbank, lam64 = _bank(hetero=hetero)
    kw = dict(num_slots=4, lam64=lam64)
    sh = ShardedSession(_tbank(jbank), _cpu_mesh((2, 2)),
                        config=SolverConfig(block_size=S,
                                            backend="blocked"), **kw)
    ref = JSession(jbank, config=JConfig(block_size=S, backend="blocked"),
                   **kw)
    nb = 256
    space = np.linspace(0.2, 1.0, 12)
    for s in (sh, ref):
        s.hit(2, space, kind="gaussian", width_us=300.0)
        s.hit(7, -space, when=3 * S)
    busy = [s.render_multi(nb, blocks_per_dispatch=nb) for s in (sh, ref)]
    idle = [s.render_multi(nb, blocks_per_dispatch=nb) for s in (sh, ref)]
    assert ref.span_tables_for(nb).superchunk == (1 if hetero else 32)
    (key, grid), = sh._sharded_tables.items()
    assert key == 512 and not sh._span_cache
    assert grid[1][1].b_re.shape == ((4 if hetero else 1), 513, 64)
    assert grid[1][1].n_chunks == 64 and grid[1][1].planes is not None
    assert np.abs(busy[1]).max() > 0
    assert dberr(*busy) <= -100
    assert dberr(*idle) <= -100
    assert sh.sample_clock == ref.sample_clock == 2 * nb * S


@pytest.mark.parametrize("case", ["impact", "sustained", "complex"])
def test_span_dispatch_exactly_one_reduction(case, dberr):
    """The counterpart of the JAX test that finds one all-reduce in a span
    dispatch's HLO: the port's span makes exactly one psum, of the [N, C]
    mix, for impact, sustained and complex rows, and the mix is the
    unsharded session's."""
    sh, ref, m = _pair((4, 2), m=48, reference="port")
    if case == "complex":
        t = _complex_rows(sh, 3)
        for s in (sh, ref):
            s.set_complex_transfer(t)
    for s in (sh, ref):
        s.hit(4, np.linspace(0.2, 1.0, m), kind="gaussian", width_us=300.0)
        if case == "sustained":
            s.sustained_start(6, np.linspace(-1.0, 1.0, m))
    sharding.REDUCTIONS = 0
    mix = sh._step_span(8)
    assert sharding.REDUCTIONS == 1
    assert tuple(mix.shape) == (8 * S, 2)
    assert dberr(mix.numpy(), ref._step_span(8).numpy()) <= -100


def test_hit_on_the_last_shard_is_routed(dberr):
    """A hit on the last object of the last object shard, its modes only
    in the last mode slice, lands in that shard's rows and is heard like
    the unsharded session's; drags and clears route the same way."""
    sh, ref, m = _pair((2, 4), m=128, reference="port")
    mm = sh.bank.num_modes
    assert float(ref.bank.mask[7, -1]) == 1.0    # the last slice sounds
    space = np.zeros(mm)
    space[-mm // 4:] = np.linspace(0.5, 1.5, mm // 4)
    for s in (sh, ref):
        s.hit(7, space, kind="gaussian", width_us=300.0)
    last = sh._shards[1][3]
    assert int(last.slots.ftype[3, 0]) != 0
    assert torch.count_nonzero(last.slots.space[3, 0]) > 0
    for i, j in np.ndindex(2, 4):
        if (i, j) != (1, 3):
            assert torch.count_nonzero(sh._shards[i][j].slots.space) == 0
    assert int(sh._shards[1][0].slots.ftype[3, 0]) != 0   # records replicate
    a, b = _blocks(sh, 2), _blocks(ref, 2)
    assert np.abs(b).max() > 0 and dberr(a, b) <= -100
    for s in (sh, ref):
        s.sustained_start(7, space)
    assert bool(sh._shards[1][2].sustained.active[3])
    assert dberr(_blocks(sh, 2), _blocks(ref, 2)) <= -100
    for s in (sh, ref):
        s.clear_forces()
    assert not any(bool(sh._shards[i][j].sustained.active.any())
                   or bool(sh._shards[i][j].slots.ftype.any())
                   for i, j in np.ndindex(2, 4))
    assert dberr(sh.render_multi(6, 3), ref.render_multi(6, 3)) <= -100


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1)])
def test_sharded_batched_writes_match_unsharded(mesh_shape, dberr):
    """A batch of hits over every object (slots overwritten), drags,
    retunes and a clear: each row's value travels with its object to the
    shards that own it, so the gathered state is bitwise the unsharded
    session's after the same batch, and the two sound alike."""
    sh, ref, m = _pair(mesh_shape, reference="port")
    rng = np.random.default_rng(11)
    calls = [(int(rng.integers(8)), rng.normal(size=m), k % 3,
              S * int(rng.integers(0, 6))) for k in range(40)]
    for s in (sh, ref):
        with s.batched_writes():
            for obj, row, kind, when in calls:
                s.hit(obj, row, kind=("point", "gaussian", "hertz")[kind],
                      width_us=300.0, when=when)
            s.sustained_start(7, -calls[0][1])
            s.set_ar_params(7, a=(0.6, 0.2), sigma=0.003, mu=0.1)
            s.sustained_start(2, calls[1][1])
            s.clear_forces(5)
            s.hit(5, calls[2][1])
            s.sustained_update(2, calls[3][1])
    assert sh.event_writes == ref.event_writes
    assert_same_session(sh, ref)
    assert dberr(_blocks(sh, 3), _blocks(ref, 3)) <= -100
    a = sh.render_multi(8, blocks_per_dispatch=8)
    b = ref.render_multi(8, blocks_per_dispatch=8)
    assert np.abs(b).max() > 0 and dberr(a, b) <= -100


def test_sharded_checkpoint_roundtrip(tmp_path):
    """save_session of a ShardedSession and load_session into a fresh one:
    the next blocks bitwise, drags and a retune included."""
    from openpbso_tpu_torch.runtime.checkpoint import (load_session,
                                                       save_session)
    sh, _, m = _pair((2, 4), reference="port")
    space = np.linspace(0.2, 1.0, m)
    sh.hit(1, space, kind="gaussian", width_us=300.0)
    sh.set_ar_params(6, a=(0.8, 0.1), sigma=0.002, mu=0.1)
    sh.sustained_start(6, -space)
    _blocks(sh, 3)
    path = os.path.join(str(tmp_path), "s.npz")
    save_session(path, sh)
    fresh, _, _ = _pair((2, 4), reference="port")
    load_session(path, fresh)
    assert fresh.sample_clock == sh.sample_clock
    assert np.array_equal(_blocks(fresh, 4), _blocks(sh, 4))
    assert np.array_equal(fresh.render_multi(8, 4), sh.render_multi(8, 4))


def test_sharded_warmup_and_probe_leave_the_stream(dberr):
    """warmup runs every variant on the shards and puts the state back;
    qnorm_probe joins [O, M] over both axes and advances nothing."""
    sh, ref, m = _pair((2, 4), smooth=True, reference="port")
    space = np.linspace(0.2, 1.0, m)
    for s in (sh, ref):
        s.hit(2, space, kind="gaussian", width_us=300.0)
        s.step()
    before = sh.state
    sh.warmup(qnorm=True, span_blocks=(1, 4))
    after = sh.state
    assert sh.sample_clock == ref.sample_clock
    assert all(torch.equal(x, y) for x, y in zip(
        [before.z_re, before.slots.space, before.sustained.key],
        [after.z_re, after.slots.space, after.sustained.key]))
    q = sh.qnorm_probe()
    assert tuple(q.shape) == (8, sh.bank.num_modes)
    assert dberr(q.numpy(), ref.qnorm_probe().numpy()) <= -100
    assert dberr(_blocks(sh, 2), _blocks(ref, 2)) <= -100


def test_sharded_render_moving_and_doppler(model_ffat, dberr):
    """A listener path through render_moving and render_doppler, each
    shard rendering its rows, against the unsharded session."""
    jbank, lam64, ffat, space = model_ffat
    cfg = SolverConfig(block_size=S, backend="blocked",
                       smooth_transfer=True)
    sh = ShardedSession(_tbank(jbank), _cpu_mesh((4, 2)), ffat=ffat[1],
                        config=cfg, num_slots=4, lam64=lam64)
    ref = ModalSession(_tbank(jbank), ffat=ffat[1], config=cfg,
                       num_slots=4, lam64=lam64)
    path = np.stack([np.array([1.2, 0.1 * t, 0.3]) for t in range(6)])
    out = []
    for s in (sh, ref):
        s.set_listener(path[0])
        s.hit(0, space)
        out.append((s.render_moving(path, blocks_per_dispatch=4),
                    s.render_doppler(path, blocks_per_dispatch=4)))
    assert np.abs(out[1][0]).max() > 0
    assert dberr(out[0][0], out[1][0]) <= -100
    assert dberr(out[0][1], out[1][1]) <= -100


@pytest.mark.parametrize("hetero", [False, True])
def test_sharded_session_keeps_only_the_shards(hetero):
    """The whole bank is not kept: ``bank`` is shape-only (meta tensors)
    and answers the base session's questions as the unsharded one does;
    each shard holds its slice of the bank's data, bitwise; the session's
    own tensors live on the mesh's first device."""
    jbank, lam64 = _bank(hetero=hetero)
    whole = _tbank(jbank)
    sh = ShardedSession(whole, _cpu_mesh((2, 2)), lam64=lam64,
                        config=SolverConfig(block_size=S))
    ref = ModalSession(whole, lam64=lam64, config=SolverConfig(
        block_size=S, backend="blocked"))
    assert sh.bank.lam_re.device.type == "meta"
    assert sh.bank.pow_re.device.type == "meta"
    assert sh.bank.pow_re.shape == whole.pow_re.shape
    assert (sh.bank.num_objects, sh.bank.num_modes, sh.bank.block_size,
            sh.bank.shared_tables) == (whole.num_objects, whole.num_modes,
                                       whole.block_size,
                                       whole.shared_tables)
    assert sh.decay_eligible() == ref.decay_eligible()
    assert sh.qnorm_probe_eligible() == ref.qnorm_probe_eligible()
    assert sh.device == sh.mesh.first and sh.gains.device == sh.mesh.first
    o, m = whole.num_objects // 2, whole.num_modes // 2
    for i, j in np.ndindex(2, 2):
        part = sh._banks[i][j]
        rows = slice(0 if whole.shared_tables else i * o,
                     1 if whole.shared_tables else (i + 1) * o)
        assert torch.equal(part.lam_re,
                           whole.lam_re[i * o:(i + 1) * o, j * m:(j + 1) * m])
        assert torch.equal(part.pow_im,
                           whole.pow_im[rows, j * m:(j + 1) * m])


def test_sharded_session_refusals():
    jbank, lam64 = _bank()
    with pytest.raises(ValueError, match="blocked/span"):
        ShardedSession(_tbank(jbank), _cpu_mesh((2, 1)),
                       config=SolverConfig(block_size=S, backend="scan"))
    with pytest.raises(ValueError, match="does not split into 3 shards"):
        ShardedSession(_tbank(jbank), make_mesh(3, 1, devices=["cpu"] * 3),
                       config=SolverConfig(block_size=S))


def test_sharded_rebase_matches_unsharded(dberr):
    """Crossing REBASE_PERIOD re-zeroes every shard's clock and slot t0
    as the unsharded session re-zeroes its own."""
    from openpbso_tpu_torch.config import REBASE_PERIOD
    sh, ref, m = _pair((2, 4), reference="port")
    start = REBASE_PERIOD - 2 * S
    for s in (sh, ref):
        s._clock = start
        s.state = dataclasses.replace(s.state, block_start=start)
        s.hit(6, np.linspace(0.2, 1.0, m), kind="gaussian", width_us=600.0)
    a, b = _blocks(sh, 4), _blocks(ref, 4)
    assert sh._clock_base == ref._clock_base == REBASE_PERIOD
    assert all(c.block_start == ref.state.block_start
               for row in sh._shards for c in row)
    assert torch.equal(sh.state.slots.t0, ref.state.slots.t0)
    assert np.abs(b).max() > 0 and dberr(a, b) <= -100
