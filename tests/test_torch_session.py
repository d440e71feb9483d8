"""Port parity: ModalSession over the per-block path (openpbso_tpu_torch.runtime).

One script of events runs through the JAX session and the port's, with the
bank and FFAT maps built once in the JAX package and carried across by
convert.py. The JAX side runs its Pallas kernel in interpret mode by
swapping the backend table entry for the test, which changes nothing in the
package.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.config import REBASE_PERIOD
from openpbso_tpu.ops import integrator as j_integrator
from openpbso_tpu.ops.coeffs import build_modal_bank, lambda_from_modes
from openpbso_tpu.ops.ffat import build_ffat
from openpbso_tpu.ops.pallas_integrator import step_block_pallas
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.runtime.solver import step_block as j_step_block
from openpbso_tpu.runtime.state import make_solver_state as j_make_state
from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube, synth_mode_data
from openpbso_tpu_torch.convert import (bank_from_numpy, ffat_from_numpy,
                                        state_from_numpy)
from openpbso_tpu_torch.ops import fused_integrator
from openpbso_tpu_torch.runtime.session import ModalSession as TSession
from openpbso_tpu_torch.runtime.solver import SolverConfig as TConfig
from openpbso_tpu_torch.runtime.solver import step_block as t_step_block

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


O, N, S = 3, 40, 128


@pytest.fixture(scope="module")
def assets():
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        N, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(O)]
    lam, b, v = (np.stack(x) for x in zip(*parts))
    jbank = build_modal_bank(lam, b, v, block_size=S, shared=False,
                             dtype=jnp.float32)
    maps = {i: synth_fatcube(i, 200.0 * (i + 1), n=6) for i in range(N)}
    jffat = build_ffat(maps, jbank.num_modes, dtype=jnp.float32)
    tbank = bank_from_numpy(jax.tree.map(np.asarray, jbank), device="cpu")
    tffat = ffat_from_numpy(jax.tree.map(np.asarray, jffat), device="cpu")
    return jbank, jffat, tbank, tffat


def _script(sess, rng_seed=0):
    """~12 blocks: hits of every kind, one future-dated, a listener move,
    and a ring-down long enough to take the idle decay step."""
    rng = np.random.default_rng(rng_seed)
    space = [rng.standard_normal(N) for _ in range(4)]
    out = []
    sess.set_listener(np.array([[0.8, 0.1, 0.4], [-0.5, 0.9, 0.2],
                                [0.3, -0.7, 1.1]]))
    sess.hit(0, space[0], kind="point")
    sess.hit(1, space[1], kind="gaussian", width_us=500.0, amp=0.7)
    sess.hit(2, space[2], kind="hertz", width_us=2000.0,
             when=sess.sample_clock + 2 * S)
    out.append(sess.render(3))
    sess.set_listener(np.array([0.2, 0.6, 0.9]))
    sess.hit(1, space[3], kind="gaussian", width_us=300.0)
    out.append(sess.render(9))
    return np.concatenate(out)


def _jax_session(jbank, jffat, backend, monkeypatch):
    monkeypatch.setitem(j_integrator.BACKENDS, "pallas",
                        partial(step_block_pallas, interpret=True))
    return JSession(jbank, jffat, JConfig(block_size=S, backend=backend))


@pytest.mark.parametrize("backend", ["pallas", "blocked"])
def test_session_script_matches_jax(assets, backend, monkeypatch, dberr):
    jbank, jffat, tbank, tffat = assets
    jsess = _jax_session(jbank, jffat, backend, monkeypatch)
    tsess = TSession(tbank, tffat, TConfig(block_size=S, backend=backend))
    ref = _script(jsess)
    got = _script(tsess)
    assert got.shape == ref.shape == (12 * S, 2) and got.dtype == np.float32
    assert np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100
    assert tsess.sample_clock == jsess.sample_clock == 12 * S
    assert tsess.state.block_start == int(np.asarray(jsess.state.block_start))
    assert tsess._idle() and tsess.decay_eligible()
    # the fused step on CPU tensors is the plain twin: no kernel launched
    assert fused_integrator.LAUNCHES == 0


def test_session_fused_matches_jax_blocked(assets, monkeypatch, dberr):
    jbank, jffat, tbank, tffat = assets
    ref = _script(_jax_session(jbank, jffat, "blocked", monkeypatch))
    got = _script(TSession(tbank, tffat, TConfig(block_size=S,
                                                 backend="pallas")))
    assert dberr(got, ref) <= -100


def test_decay_steps_equal_full_steps(assets):
    """Idle blocks take the homogeneous-only step with the same output."""
    _, _, tbank, tffat = assets
    fast = TSession(tbank, tffat, TConfig(block_size=S, backend="blocked"))
    full = TSession(tbank, tffat, TConfig(block_size=S, backend="blocked",
                                          decay_fast_path=False))
    assert fast.decay_eligible() and not full.decay_eligible()
    np.testing.assert_array_equal(_script(fast), _script(full))


def test_rebase_matches_jax(assets, monkeypatch, dberr):
    """Crossing REBASE_PERIOD re-zeroes the device clock identically."""
    jbank, jffat, tbank, tffat = assets
    jsess = _jax_session(jbank, jffat, "blocked", monkeypatch)
    tsess = TSession(tbank, tffat, TConfig(block_size=S, backend="blocked"))
    start = REBASE_PERIOD - S
    for sess in (jsess, tsess):
        sess._clock = start
        sess.state = dataclasses.replace(
            sess.state, block_start=(jnp.asarray(start, jnp.int32)
                                     if sess is jsess else start))
    ref = _script(jsess)
    got = _script(tsess)
    assert tsess._clock_base == jsess._clock_base == REBASE_PERIOD
    assert tsess.state.block_start == int(np.asarray(jsess.state.block_start))
    np.testing.assert_array_equal(tsess.state.slots.t0.numpy(),
                                  np.asarray(jsess.state.slots.t0))
    assert dberr(got, ref) <= -100


def test_slot_bucket_and_idle_follow_jax(assets, monkeypatch):
    jbank, jffat, tbank, tffat = assets
    jsess = _jax_session(jbank, jffat, "blocked", monkeypatch)
    tsess = TSession(tbank, tffat, TConfig(block_size=S, backend="blocked"))
    for sess in (jsess, tsess):
        sess.hit(0, np.ones(N), kind="gaussian", width_us=4000.0)
        sess.hit(0, np.ones(N), kind="point")
    assert tsess._slot_bucket() == jsess._slot_bucket() is None
    assert tsess._idle() == jsess._idle() is False
    for _ in range(2):
        jsess.step()
        tsess.step()
        assert tsess._slot_bucket() == jsess._slot_bucket()
        assert tsess._alloc_slot(0) == jsess._alloc_slot(0)
    for sess in (jsess, tsess):
        sess.clear_forces(0)
    assert tsess._idle() and jsess._idle()


def test_set_use_transfer_toggles_unit_transfer(assets):
    _, _, tbank, tffat = assets
    sess = TSession(tbank, tffat, TConfig(block_size=S, backend="blocked"))
    assert (sess.state.transfer == 1e7).all()
    sess.set_listener(np.array([0.3, 0.2, 0.9]))
    ffat_rows = sess.state.transfer.clone()
    assert not torch.equal(ffat_rows, torch.full_like(ffat_rows, 1e7))
    sess.set_use_transfer(False)
    assert (sess.state.transfer == 1e7).all()
    sess.set_use_transfer(True)
    torch.testing.assert_close(sess.state.transfer, ffat_rows, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="listener"):
        sess.set_listener(np.zeros((2, 3)))
    # [L, O, 3] rows are for a session with listeners: each listener's row
    # is the single-listener lookup of its positions, bitwise
    with pytest.raises(ValueError, match="listener"):
        sess.set_listener(np.zeros((2, O, 3)))
    two = TSession(tbank, tffat, TConfig(block_size=S, backend="blocked"),
                   num_listeners=2)
    rows = np.stack([np.full((O, 3), 0.8), np.full((O, 3), -0.6)])
    two.set_listener(rows)
    assert two.state.transfer.shape == (2, O, tbank.num_modes)
    for li in range(2):
        sess.set_listener(rows[li])
        torch.testing.assert_close(two.state.transfer[li],
                                   sess.state.transfer, rtol=0, atol=0)


def test_hit_validation(assets):
    _, _, tbank, _ = assets
    sess = TSession(tbank, config=TConfig(block_size=S, backend="blocked"))
    with pytest.raises(ValueError, match="kind"):
        sess.hit(0, np.ones(N), kind="scrape")
    with pytest.raises(ValueError, match="block-aligned"):
        sess.hit(0, np.ones(N), when=S + 1)
    sess.render(2)
    with pytest.raises(ValueError, match="block-aligned"):
        sess.hit(0, np.ones(N), when=0)      # in the past


@pytest.mark.parametrize("call", [
    lambda s: s._moving_path(np.zeros((4, 2, O, 3))).shape == (4, 2, O, 3),
    lambda s: (s.set_complex_transfer(np.full((2, O, 128), 1.0 + 2.0j))
               or (torch.equal(s.state.transfer, torch.ones(2, O, 128))
                   and torch.equal(s.state.transfer_im,
                                   torch.full((2, O, 128), 2.0)))),
])
def test_unported_methods_name_their_roadmap_item(assets, call):
    """What the first slices refused now runs: a listener-stacked path and
    complex listener rows (tests/test_torch_multilistener.py and
    tests/test_torch_complex.py hold them against the JAX package)."""
    _, _, tbank, _ = assets
    sess = TSession(tbank, config=TConfig(block_size=S), num_listeners=2)
    assert call(sess)


@pytest.mark.parametrize("kwargs,item", [
    (dict(num_listeners=2), 2),
    (dict(num_listeners=4, config=TConfig(block_size=S,
                                          smooth_transfer=True)), 4),
    (dict(num_listeners=0), 1),
])
def test_unported_session_arguments_raise(assets, kwargs, item):
    """Multi-listener sessions build ([L, O, M] rows, [O, L] gains, one
    channel per listener); 0 reads as one listener, as in the JAX
    package."""
    _, _, tbank, _ = assets
    sess = TSession(tbank, **{"config": TConfig(block_size=S), **kwargs})
    o, m = tbank.num_objects, tbank.num_modes
    want = (o, m) if item == 1 else (item, o, m)
    assert sess.state.transfer.shape == want
    assert sess.gains.shape == (o, 2 if item == 1 else item)
    sess.hit(0, np.ones(N))
    assert sess.step()[1].shape == (S, 2 if item == 1 else item)
    # the session's own options of this slice build
    for cfg in (TConfig(block_size=S, smooth_transfer=True),
                TConfig(block_size=S, compute_qnorm=True)):
        assert TSession(tbank, config=cfg).config is cfg


@pytest.mark.parametrize("rows", ["listeners", "complex"])
def test_solver_routes_listener_and_complex_rows_to_blocked(assets, rows,
                                                            monkeypatch,
                                                            dberr):
    """The fused kernel takes real [O, M] rows only: a JAX state with
    [L, O, M] listener rows or an imaginary row, carried across, steps
    through the blocked form under backend 'pallas' in both packages."""
    jbank, _, tbank, _ = assets
    monkeypatch.setitem(j_integrator.BACKENDS, "pallas",
                        partial(step_block_pallas, interpret=True))
    rng = np.random.default_rng(3)
    m = jbank.num_modes
    st = j_make_state(O, m, num_slots=4, dtype=jnp.float32,
                      num_listeners=2 if rows == "listeners" else 1)
    slots = dataclasses.replace(
        st.slots, ftype=st.slots.ftype.at[:, 0].set(2),
        width=st.slots.width.at[:, 0].set(30.0),
        space=st.slots.space.at[:, 0].set(jnp.asarray(
            rng.standard_normal((O, m)), jnp.float32)))
    tr = jnp.asarray(rng.uniform(0.5, 2.0, st.transfer.shape), jnp.float32)
    st = dataclasses.replace(st, slots=slots, transfer=tr)
    if rows == "complex":
        st = dataclasses.replace(st, transfer_im=jnp.asarray(
            rng.uniform(-1.0, 1.0, (O, m)), jnp.float32))
    gains = np.ones((O, 2), np.float32)
    j_state, _, j_mix, _ = j_step_block(st, jbank, jnp.asarray(gains),
                                        block_size=S, backend="pallas")
    t_state, _, t_mix, _ = t_step_block(
        state_from_numpy(jax.tree.map(np.asarray, st), device="cpu"), tbank,
        torch.from_numpy(gains), block_size=S, backend="pallas")
    assert fused_integrator.LAUNCHES == 0
    # the session's bar: a mix sums O objects' rows after the mode reduce
    assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100
    assert dberr(t_state.z_im.numpy(), np.asarray(j_state.z_im)) <= -100
    assert t_state.block_start == int(np.asarray(j_state.block_start)) == S
