"""Port parity: complex transfer rows and geometry-derived interaural time
differences (set_complex_transfer, ``auto_itd``) against the JAX package.

A complex row t = re + i im rotates each mode's phase, which for a
narrowband mode is a time shift at its frequency. The port holds the JAX
package's renders to <= -100 dB per block (blocked and scan), with
listener rows, by span, across a ramped move, and in a binaural ITD Scene;
the ITD delays are bitwise the JAX session's host arithmetic; checkpoints
of complex rows restore bitwise and refuse a template of the other
structure (tests/test_complex_transfer.py, tests/test_scene.py:78-110).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.config import SAMPLE_RATE, SOUND_SPEED
from openpbso_tpu.io.meta import resolve_model_dir as j_resolve
from openpbso_tpu.models.modal_model import load_model as j_load
from openpbso_tpu.models.scene import Scene as JScene
from openpbso_tpu.models.scene import SceneInstance as JInstance
from openpbso_tpu.ops.coeffs import bank_from_material, lambda_from_modes
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy
from openpbso_tpu_torch.io.meta import resolve_model_dir as t_resolve
from openpbso_tpu_torch.models.modal_model import load_model as t_load
from openpbso_tpu_torch.models.scene import Scene as TScene
from openpbso_tpu_torch.models.scene import SceneInstance as TInstance
from openpbso_tpu_torch.runtime.checkpoint import (load_session, load_state,
                                                   save_session, save_state)
from openpbso_tpu_torch.runtime.session import ModalSession as TSession
from openpbso_tpu_torch.runtime.solver import SolverConfig as TConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S, O, N = 64, 2, 10


@pytest.fixture(scope="module")
def bank():
    md = synth_mode_data(N, 8, seed=3)
    lam64 = lambda_from_modes(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta)[0]
    jbank = bank_from_material(CERAMIC.density, md.omega_squared,
                               CERAMIC.alpha, CERAMIC.beta, num_objects=O,
                               block_size=S, dtype=jnp.float32)
    tbank = bank_from_numpy(jax.tree.map(np.asarray, jbank), device="cpu")
    return jbank, tbank, np.broadcast_to(lam64, (O, lam64.shape[-1]))


@pytest.fixture(scope="module")
def models(synth_model_root):
    return (j_load(j_resolve(synth_model_root, "synth")),
            t_load(t_resolve(synth_model_root, "synth")))


def _pair(bank, backend="blocked", nl=1, lam64=False, **cfg):
    jbank, tbank, lam = bank
    js = JSession(jbank, config=JConfig(block_size=S, backend=backend,
                                        **cfg),
                  num_listeners=nl, lam64=lam if lam64 else None)
    ts = TSession(tbank, config=TConfig(block_size=S, backend=backend,
                                        **cfg),
                  num_listeners=nl, lam64=lam if lam64 else None)
    return js, ts


def _complex_rows(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, shape)
            * np.exp(1j * rng.uniform(-np.pi, np.pi, shape)))


def _hits(sess):
    sess.hit(0, np.linspace(0.2, 1.0, N), kind="gaussian", width_us=700.0)
    sess.hit(1, np.linspace(-1.0, 0.4, N), when=2 * S)


@pytest.mark.parametrize("nl", [1, 2])
@pytest.mark.parametrize("backend", ["scan", "blocked"])
def test_complex_rows_match_jax(bank, backend, nl, dberr):
    js, ts = _pair(bank, backend=backend, nl=nl)
    shape = (O, ts.bank.num_modes) if nl == 1 else (nl, O, ts.bank.num_modes)
    t = _complex_rows(shape, 5)
    for s in (js, ts):
        s.set_complex_transfer(t)
        _hits(s)
    torch.testing.assert_close(ts.state.transfer_im, torch.as_tensor(
        t.imag, dtype=torch.float32), rtol=0, atol=0)
    ref, got = js.render(6), ts.render(6)
    assert got.shape == (6 * S, 2) and np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100


def test_complex_span_matches_jax(bank, dberr):
    """The chunked span takes the imaginary rows too (busy and ring-down
    dispatches), as the JAX package's does and as the port's own per-block
    render does."""
    js, ts = _pair(bank, lam64=True)
    _, blk = _pair(bank)
    t = _complex_rows((O, ts.bank.num_modes), 7)
    for s in (js, ts, blk):
        s.set_complex_transfer(t)
        _hits(s)
    assert ts.span_eligible()
    ref = js.render_multi(12, blocks_per_dispatch=6)
    got = ts.render_multi(12, blocks_per_dispatch=6)
    assert dberr(got, ref) <= -100
    assert dberr(got, blk.render(12)) <= -100


def test_complex_xfade_matches_jax(bank, dberr):
    """With smooth_transfer a complex install mid-stream ramps both
    channels across the next block (ops/integrator._xfade_rows)."""
    js, ts = _pair(bank, smooth_transfer=True)
    t0 = _complex_rows((O, ts.bank.num_modes), 11)
    t1 = _complex_rows((O, ts.bank.num_modes), 12)
    out = []
    for s in (js, ts):
        s.set_complex_transfer(t0)
        _hits(s)
        first = s.render(3)
        s.set_complex_transfer(t1)
        assert s._xfade_from is not None
        out.append(np.concatenate([first, s.render(3)]))
    assert dberr(out[1], out[0]) <= -100


def test_set_listener_clears_phase(models):
    _, tmodel = models
    sc = TScene([TInstance(tmodel, np.zeros(3))], block_size=S,
                backend="blocked", device="cpu")
    sess = sc.session
    t = np.full((1, sess.bank.num_modes), 1e7) * np.exp(
        1j * np.linspace(0, 1, sess.bank.num_modes))
    sess.set_complex_transfer(t)
    assert sess.state.transfer_im is not None
    sess.set_listener_relative(np.asarray([0.9, 0.4, 0.2]))
    assert sess.state.transfer_im is None
    sess.set_complex_transfer(t)
    sess.set_use_transfer(False)       # the unit transfer is real
    assert sess.state.transfer_im is None


def _itd_scenes(models, **kw):
    jmodel, tmodel = models
    kw = dict(block_size=S, backend="blocked", binaural=True,
              ear_distance=0.4, itd=True, **kw)
    pos = [np.zeros(3), np.asarray([0.7, -0.2, 0.1])]
    return (JScene([JInstance(jmodel, p) for p in pos], dtype=jnp.float32,
                   **kw),
            TScene([TInstance(tmodel, p) for p in pos], device="cpu", **kw))


def test_itd_rows_match_jax(models, dberr):
    """The ITD delays are the JAX session's host float64 arithmetic on the
    device's float32 rows, bitwise; the complex rows agree to <= -100
    dB."""
    js, ts = _itd_scenes(models)
    world = np.asarray([3.0, 0.4, -0.3])
    for s in (js, ts):
        s.set_listener(world)
    rel = ts._relative_rows(world)
    r = np.linalg.norm(np.asarray(jnp.asarray(rel, jnp.float32),
                                  np.float64), axis=-1)
    want = (r - r.min(axis=0, keepdims=True)) * (SAMPLE_RATE / SOUND_SPEED)
    np.testing.assert_array_equal(ts.session.itd_delays(rel), want)
    assert (want.max(axis=0) > 10).all()       # a lag of tens of samples
    for name in ("transfer", "transfer_im"):
        got = getattr(ts.session.state, name)
        ref = np.asarray(getattr(js.session.state, name))
        assert got.shape == ref.shape == (2, 2, ts.bank.num_modes)
        assert dberr(got.numpy(), ref) <= -100


def test_itd_needs_lam64(bank):
    """auto_itd derives phases from the float64 eigenvalues; a session
    without them installs magnitude rows, as the JAX session does."""
    _, ts = _pair(bank, nl=2)
    ts.ffat = None
    ts.auto_itd = True
    ts.set_listener(np.ones(3))
    assert ts.state.transfer_im is None


def test_itd_scene_render_matches_jax(models, dberr):
    """A binaural ITD Scene with smooth moves, per block: the JAX scene's
    output to <= -100 dB, and the geometry's interaural lag."""
    js, ts = _itd_scenes(models, smooth_transfer=True)
    out = []
    for s in (js, ts):
        s.set_listener(np.asarray([3.0, 0.0, 0.0]))
        s.hit(0, 3, kind="gaussian", width_us=400.0)
        first = s.render(6)
        s.set_listener(np.asarray([2.5, 1.0, 0.0]))
        out.append((first, s.render(10)))
    for (j, t) in zip(out[0], out[1]):
        assert dberr(t, j) <= -100
    a, b = out[1][0][S:, 0], out[1][0][S:, 1]   # left, right
    lag = int(np.argmax(np.correlate(b, a, mode="full"))) - (len(a) - 1)
    assert abs(lag - 0.4 / SOUND_SPEED * SAMPLE_RATE) < 4, lag


def test_complex_checkpoint_is_bitwise_and_refuses_other_structures(
        bank, tmp_path):
    js, ts = _pair(bank, nl=2)
    t = _complex_rows((2, O, ts.bank.num_modes), 21)
    ts.set_complex_transfer(t)
    _hits(ts)
    ts.render(2)
    path = str(tmp_path / "complex.npz")
    save_session(path, ts)
    want = ts.render(4)
    _, fresh = _pair(bank, nl=2)
    fresh.set_complex_transfer(np.ones_like(t))    # the same structure
    load_session(path, fresh)
    np.testing.assert_array_equal(fresh.render(4), want)
    # a template without transfer_im refuses the complex snapshot, and a
    # complex template a real one, exactly as the JAX package does
    _, real = _pair(bank, nl=2)
    with pytest.raises(ValueError, match="STRUCTURES"):
        load_session(path, real)
    state_path = str(tmp_path / "real.npz")
    save_state(state_path, real.state)
    with pytest.raises(ValueError, match="STRUCTURES"):
        load_state(state_path, fresh.state)
    js.set_complex_transfer(t)
    assert len(jax.tree.leaves(js.state)) == len(
        [k for k in np.load(path).files if k.startswith("leaf_")])
