"""Port parity: the moving listener (solver.step_multi_transfers(_sound),
ModalSession.render_moving) against the JAX package on one script, <= -100
dB, smooth and held; and the relations tests/test_moving.py holds, on the
port: a path render equals the per-move flow, chunking changes nothing, and
a hit dated inside the render fires at its block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops.coeffs import build_modal_bank, lambda_from_modes
from openpbso_tpu.ops.ffat import build_ffat
from openpbso_tpu.runtime import solver as j_solver
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube, synth_mode_data
from openpbso_tpu_torch.convert import (bank_from_numpy, ffat_from_numpy,
                                        state_from_numpy)
from openpbso_tpu_torch.runtime import solver as t_solver
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


def _path(t):
    ang = 0.3 * (1 + np.arange(t))
    return np.stack([1.3 * np.cos(ang), np.full(t, 0.4),
                     1.3 * np.sin(ang)], axis=1)


def _port(assets, smooth=False, backend="blocked"):
    _, _, tbank, tffat = assets
    return TSession(tbank, tffat, TConfig(block_size=S, backend=backend,
                                          smooth_transfer=smooth))


def _jax(assets, smooth=False):
    jbank, jffat, _, _ = assets
    return JSession(jbank, jffat, JConfig(block_size=S, backend="blocked",
                                          smooth_transfer=smooth))


def _strike(sess):
    rng = np.random.default_rng(2)
    sess.set_listener(_path(1)[0] * 1.05)      # settle an initial row
    sess.hit(0, rng.standard_normal(N), kind="gaussian", width_us=400.0)
    sess.hit(2, rng.standard_normal(N), kind="point",
             when=sess.sample_clock + 3 * S)   # fires inside the render


@pytest.mark.parametrize("smooth", [False, True])
def test_render_moving_matches_jax(assets, smooth, dberr):
    t = 10
    js, ts = _jax(assets, smooth), _port(assets, smooth)
    for sess in (js, ts):
        _strike(sess)
    ref = js.render_moving(_path(t), blocks_per_dispatch=4)
    got = ts.render_moving(_path(t), blocks_per_dispatch=4)
    assert got.shape == ref.shape == (t * S, 2) and got.dtype == np.float32
    assert np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100
    assert ts.sample_clock == js.sample_clock == t * S
    np.testing.assert_array_equal(ts._last_listener, js._last_listener)
    # per-object paths [T, O, 3]
    per_obj = np.stack([_path(t) * (1 + 0.1 * i) for i in range(O)], axis=1)
    ref = js.render_moving(per_obj)
    got = ts.render_moving(per_obj)
    assert dberr(got, ref) <= -100


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("sound", [False, True])
def test_step_multi_transfers_matches_jax(assets, smooth, sound, dberr):
    jbank, _, tbank, _ = assets
    js, ts = _jax(assets), _port(assets)
    for sess in (js, ts):
        _strike(sess)
        sess.step()
    n = 5
    rows = np.array(js._transfer_rows(js._moving_path(_path(n))))
    tstate = state_from_numpy(jax.tree.map(np.asarray, js.state),
                              device="cpu")
    kw = dict(n_blocks=n, block_size=S, backend="blocked", smooth=smooth,
              with_sustained=False, num_slots=None)
    if sound:
        jst, ref = j_solver.step_multi_transfers_sound(
            js.state, jbank, jnp.asarray(rows), **kw)
        tst, got = t_solver.step_multi_transfers_sound(
            tstate, tbank, torch.from_numpy(rows), **kw)
        assert got.shape == (O, n * S)
    else:
        jst, ref = j_solver.step_multi_transfers(
            js.state, jbank, js.gains, jnp.asarray(rows), **kw)
        tst, got = t_solver.step_multi_transfers(
            tstate, tbank, ts.gains, torch.from_numpy(rows), **kw)
        assert got.shape == (n * S, 2)
    assert dberr(got.numpy(), np.asarray(ref)) <= -100
    assert dberr(tst.z_im.numpy(), np.asarray(jst.z_im)) <= -100
    assert tst.block_start == int(np.asarray(jst.block_start))
    np.testing.assert_array_equal(tst.transfer.numpy(), rows[-1])


def test_transfer_rows_equal_set_listener_rows(assets, dberr):
    """Each row of a path is the row a listener move to that position
    installs, bitwise, and the JAX package's to <= -100 dB."""
    js, ts = _jax(assets), _port(assets)
    path = ts._moving_path(_path(4))
    assert path.shape == (4, O, 3)
    rows = ts._transfer_rows(path)
    assert rows.shape == (4, O, ts.bank.num_modes)
    for p, row in zip(_path(4), rows):
        ts.set_listener(p)
        assert torch.equal(ts.state.transfer, row)
    assert dberr(rows.numpy(), np.asarray(js._transfer_rows(path))) <= -100
    with pytest.raises(ValueError, match="listener path"):
        ts._moving_path(np.zeros((4, O + 1, 3)))


def test_render_moving_matches_per_move_steps(assets, dberr):
    """One path render == the reference flow of one set_listener and its
    blocks per move (block-constant transfer)."""
    pos = _path(6)
    ref = _port(assets)
    _strike(ref)
    chunks = []
    for p in pos:
        ref.set_listener(p)
        chunks.append(ref.render(2))
    want = np.concatenate(chunks, axis=0)
    got_sess = _port(assets)
    _strike(got_sess)
    got = got_sess.render_moving(np.repeat(pos, 2, axis=0),
                                 blocks_per_dispatch=12)
    assert np.abs(want).max() > 0
    assert dberr(got, want) <= -100
    assert got_sess.sample_clock == ref.sample_clock


def test_render_moving_smooth_ramps_every_move(assets, dberr):
    """smooth=True == one xfade block per move of a smooth_transfer
    session: a moved block ramps from the carried row, a held block ramps
    from the row to itself."""
    pos = _path(4)
    ref = _port(assets, smooth=True)
    _strike(ref)
    ref.step()                        # consume the settling move
    chunks = []
    for p in pos:
        ref.set_listener(p)           # pends one xfade block
        chunks += [ref.step()[1].numpy(), ref.step()[1].numpy()]
    want = np.concatenate(chunks, axis=0)
    got_sess = _port(assets, smooth=True)
    _strike(got_sess)
    got_sess.step()
    got = got_sess.render_moving(np.repeat(pos, 2, axis=0),
                                 blocks_per_dispatch=8)
    assert dberr(got, want) <= -100


def test_pending_move_becomes_the_first_ramp(assets, dberr):
    """A move still pending when render_moving starts is the first block's
    ramp start; with smooth off it is dropped."""
    pos = _path(3)
    a = _port(assets, smooth=True)
    _strike(a)                         # the settling move is pending
    start = a._xfade_from[0]
    got = a.render_moving(pos)
    assert a._xfade_from is None
    b = _port(assets, smooth=True)
    _strike(b)
    b._xfade_from = None
    import dataclasses
    b.state = dataclasses.replace(b.state, transfer=start)
    np.testing.assert_array_equal(b.render_moving(pos), got)


@pytest.mark.parametrize("smooth", [False, True])
def test_render_moving_chunking_invariant(assets, smooth):
    """Bitwise the same however the path is chunked: each row's lookup is
    independent and the loop's state carries across chunk boundaries."""
    outs = []
    for bpd in (3, 12):
        sess = _port(assets, smooth)
        _strike(sess)
        outs.append(sess.render_moving(_path(12), blocks_per_dispatch=bpd))
    assert np.abs(outs[0]).max() > 0
    np.testing.assert_array_equal(outs[0], outs[1])


def test_hit_dated_inside_the_render_fires_at_its_block(assets, dberr):
    """A future-dated hit inside a path render equals the same hit made
    live at that block boundary."""
    rng = np.random.default_rng(5)
    space = rng.standard_normal(N)
    pos = _path(8)
    live = _port(assets)
    live.set_listener(pos[0])
    first = live.render_moving(pos[:5])
    live.hit(1, space, kind="gaussian", width_us=300.0)
    want = np.concatenate([first, live.render_moving(pos[5:])])
    dated = _port(assets)
    dated.set_listener(pos[0])
    dated.hit(1, space, kind="gaussian", width_us=300.0, when=5 * S)
    got = dated.render_moving(pos)
    assert np.abs(want[5 * S:]).max() > 0 and not want[:5 * S].any()
    assert dberr(got, want) <= -100


def test_render_moving_needs_an_ffat(assets):
    _, _, tbank, _ = assets
    sess = TSession(tbank, config=TConfig(block_size=S))
    with pytest.raises(ValueError, match="FFAT"):
        sess.render_moving(_path(2))


def test_render_multi_flushes_a_pending_move(assets, dberr):
    """render_multi steps the pending xfade block alone, then dispatches
    the rest from the settled row (JAX session.py:955-960)."""
    js, ts = _jax(assets, True), _port(assets, True)
    for sess in (js, ts):
        _strike(sess)
    ref = js.render_multi(5, blocks_per_dispatch=4)
    got = ts.render_multi(5, blocks_per_dispatch=4)
    assert ts._xfade_from is None and got.shape == (5 * S, 2)
    assert dberr(got, ref) <= -100
