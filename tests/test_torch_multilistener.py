"""Port parity: shared-state multi-listener sessions (ModalSession with
``num_listeners``) against the JAX package, <= -100 dB on one script.

One [O, M] oscillator state with [L, O, M] transfer rows and one output
channel per listener, per block (blocked, scan, the decay step), by span
(render_multi), along a path (render_moving), with qnorm and warmup, and
through a checkpoint (bitwise); listener positions [3], [L, 3] and
[L, O, 3] give the JAX session's rows, each listener's row bitwise the
single-listener lookup (tests/test_multilistener.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops.coeffs import bank_from_material, lambda_from_modes
from openpbso_tpu.ops.ffat import build_ffat
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy, ffat_from_numpy
from openpbso_tpu_torch.ops.ffat import compute_transfer
from openpbso_tpu_torch.runtime.checkpoint import load_session, save_session
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


S, O, N, L = 64, 3, 10, 3


@pytest.fixture(scope="module")
def assets():
    md = synth_mode_data(N, 8, seed=7)
    lam64 = lambda_from_modes(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta)[0]
    jbank = bank_from_material(CERAMIC.density, md.omega_squared,
                               CERAMIC.alpha, CERAMIC.beta, num_objects=O,
                               block_size=S, dtype=jnp.float32)
    maps = {i: synth_fatcube(i, 250.0 * (i + 1), n=6, seed=2)
            for i in range(N)}
    jffat = build_ffat(maps, jbank.num_modes, dtype=jnp.float32)
    tbank = bank_from_numpy(jax.tree.map(np.asarray, jbank), device="cpu")
    tffat = ffat_from_numpy(jax.tree.map(np.asarray, jffat), device="cpu")
    return dict(jbank=jbank, jffat=jffat, tbank=tbank, tffat=tffat,
                lam64=np.broadcast_to(lam64, (O, lam64.shape[-1])))


def _pair(a, nl=L, backend="blocked", ffat=False, lam64=False, **cfg):
    js = JSession(a["jbank"], a["jffat"] if ffat else None,
                  JConfig(block_size=S, backend=backend, **cfg),
                  num_listeners=nl, lam64=a["lam64"] if lam64 else None)
    ts = TSession(a["tbank"], a["tffat"] if ffat else None,
                  TConfig(block_size=S, backend=backend, **cfg),
                  num_listeners=nl, lam64=a["lam64"] if lam64 else None)
    return js, ts


def _rows(sess, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 2.0, (sess.num_listeners, O,
                                  sess.bank.num_modes)).astype(np.float32)


def _set_rows(js, ts, rows):
    js.state = dataclasses.replace(js.state, transfer=jnp.asarray(rows))
    ts.state = dataclasses.replace(ts.state, transfer=torch.from_numpy(rows))


def _hits(sess, when=None):
    rng = np.random.default_rng(11)
    space = rng.standard_normal(N)
    sess.hit(0, space, kind="gaussian", width_us=900.0)
    sess.hit(2, -space, kind="point")
    sess.hit(1, 0.5 * space, kind="hertz", width_us=600.0, when=when)


def _listeners(shape, seed=5):
    p = np.random.default_rng(seed).uniform(-1.2, 1.2, shape)
    p[..., 2] += 0.6
    return p


@pytest.mark.parametrize("backend", ["blocked", "scan"])
def test_steps_match_jax(assets, backend, dberr):
    js, ts = _pair(assets, backend=backend)
    _set_rows(js, ts, _rows(ts))
    for s in (js, ts):
        _hits(s, when=2 * S)
    ref = np.concatenate([np.asarray(js.step()[1]) for _ in range(5)])
    got = np.concatenate([ts.step()[1].numpy() for _ in range(5)])
    assert got.shape == ref.shape == (5 * S, L)
    assert np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100


def test_channel_is_the_single_listener_render(assets, dberr):
    """Channel l of the L-listener session equals a single-listener session
    rendered with listener l's row alone (the shared-state contract)."""
    _, multi = _pair(assets)
    rows = _rows(multi)
    multi.state = dataclasses.replace(multi.state,
                                      transfer=torch.from_numpy(rows))
    _hits(multi)
    got = multi.render(4)
    for li in range(L):
        _, single = _pair(assets, nl=1)
        single.state = dataclasses.replace(
            single.state, transfer=torch.from_numpy(rows[li]))
        _hits(single)
        ref = single.render(4)[:, 0]
        assert dberr(got[:, li], ref) <= -100


def test_decay_fast_path_matches_jax(assets, dberr):
    js, ts = _pair(assets, nl=2)
    _set_rows(js, ts, _rows(ts))
    for s in (js, ts):
        s.hit(1, np.linspace(0.2, 1.0, N))
        s.render(40)
        assert s._idle() and s.decay_eligible()
    before = ts.state
    ref, got = np.asarray(js.step()[1]), ts.step()[1].numpy()
    assert dberr(got, ref) <= -100
    # the decay step equals the ungated full step from the same state
    ts.state, ts._clock = before, ts._clock - S
    full = ts._step_full(with_sustained=True, num_slots=None)[1].numpy()
    assert dberr(got, full) <= -120


def test_span_matches_jax(assets, dberr):
    js, ts = _pair(assets, nl=2, lam64=True)
    _set_rows(js, ts, _rows(ts, seed=9))
    for s in (js, ts):
        _hits(s, when=3 * S)
        assert s.span_eligible()
    ref = js.render_multi(8, blocks_per_dispatch=4)
    got = ts.render_multi(8, blocks_per_dispatch=4)
    assert got.shape == (8 * S, 2)
    assert dberr(got, ref) <= -100
    # and the span equals the port's own per-block render
    _, blk = _pair(assets, nl=2)
    blk.state = dataclasses.replace(blk.state, transfer=torch.from_numpy(
        _rows(ts, seed=9)))
    _hits(blk, when=3 * S)
    assert dberr(got, blk.render(8)) <= -100


@pytest.mark.parametrize("shape", [(3,), (L, 3), (L, O, 3)])
def test_set_listener_matches_jax(assets, shape, dberr):
    js, ts = _pair(assets, ffat=True)
    pos = _listeners(shape)
    for s in (js, ts):
        s.set_listener(pos)
    got, ref = ts.state.transfer, np.asarray(js.state.transfer)
    assert got.shape == ref.shape == (L, O, ts.bank.num_modes)
    assert dberr(got.numpy(), ref) <= -100
    assert ts.state.transfer_im is None
    np.testing.assert_array_equal(ts._last_listener, pos)
    # each listener's row is the single-listener lookup, bitwise
    full = (pos if len(shape) == 3
            else np.broadcast_to(np.broadcast_to(pos, (L, 3))[:, None, :],
                                 (L, O, 3)))
    for li in range(L):
        one = compute_transfer(ts.ffat, torch.as_tensor(
            np.array(full[li]), dtype=torch.float32))
        torch.testing.assert_close(got[li], one, rtol=0, atol=0)


@pytest.mark.parametrize("compressed", [False, True])
def test_hetero_listener_rows_one_lookup(assets, compressed, dberr):
    """Per-object maps: set_listener looks all L listeners up in one
    compute_transfer call, each object's maps repeated for its L rows;
    every listener's row is the single-listener call bitwise, and the rows
    match the JAX session's (which vmaps over listeners)."""
    from openpbso_tpu.ops.ffat import build_ffat_hetero
    from openpbso_tpu.ops.ffat_fit import compress_map
    per_obj = [{i: synth_fatcube(i, 250.0 * (i + 1), n=6, seed=3 + k)
                for i in range(N)} for k in range(O)]
    comp = [{i: compress_map(m, jpeg_quality=None) for i, m in d.items()}
            for d in per_obj]
    jffat = build_ffat_hetero(per_obj, assets["jbank"].num_modes,
                              dtype=jnp.float32, compressed_maps=comp)
    tffat = ffat_from_numpy(jax.tree.map(np.asarray, jffat), device="cpu")
    js = JSession(assets["jbank"], jffat, JConfig(block_size=S),
                  num_listeners=L)
    ts = TSession(assets["tbank"], tffat, TConfig(block_size=S),
                  num_listeners=L)
    pos = _listeners((L, O, 3), seed=8)
    for s in (js, ts):
        s.set_use_compressed(compressed)
        s.set_listener(pos)
    got = ts.state.transfer
    assert dberr(got.numpy(), np.asarray(js.state.transfer)) <= -100
    for li in range(L):
        one = compute_transfer(tffat, torch.as_tensor(
            pos[li], dtype=torch.float32), compressed=compressed)
        assert not torch.equal(one, compute_transfer(tffat, torch.as_tensor(
            pos[(li + 1) % L], dtype=torch.float32), compressed=compressed))
        torch.testing.assert_close(got[li], one, rtol=0, atol=0)


@pytest.mark.parametrize("pos", [np.zeros((2, 3)), np.zeros((L, 2, 3)),
                                 np.zeros((L, O, 2)), np.zeros((1, L, O, 3))])
def test_listener_shapes_refused(assets, pos):
    _, ts = _pair(assets, ffat=True)
    with pytest.raises(ValueError, match="listener"):
        ts.set_listener(pos)


def test_qnorm_and_warmup(assets, dberr):
    """qnorm and the probe over listener rows, and a warmup that leaves no
    trace (tests/test_multilistener.py:191-205)."""
    js, ts = _pair(assets, ffat=True, lam64=True, smooth_transfer=True,
                   compute_qnorm=True)
    pos = _listeners((L, 3))
    for s in (js, ts):
        s.set_listener(pos)
        _hits(s)
    before = {k: v.clone() for k, v in (("t", ts.state.transfer),
                                        ("z", ts.state.z_re))}
    ts.warmup(qnorm=True, span_blocks=(1, 2))
    assert torch.equal(ts.state.transfer, before["t"])
    assert torch.equal(ts.state.z_re, before["z"])
    assert ts.sample_clock == 0 and ts._xfade_from is not None
    _, jmix, jq = js.step()
    _, tmix, tq = ts.step()
    assert tq.shape == (O, ts.bank.num_modes)
    assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100
    assert dberr(tq.numpy(), np.asarray(jq)) <= -100
    assert dberr(ts.qnorm_probe().numpy(),
                 np.asarray(js.qnorm_probe())) <= -100


@pytest.mark.parametrize("path", ["shared", "per_listener", "full"])
def test_render_moving_matches_jax(assets, path, dberr):
    t = 6
    base = np.stack([np.linspace(1.4, 0.6, t), np.full(t, 0.3),
                     np.linspace(0.2, 0.9, t)], axis=1)
    offsets = np.asarray([[0.0, 0.0, 0.0], [0.2, -0.1, 0.0],
                          [-0.3, 0.2, 0.1]])
    positions = {"shared": base,
                 "per_listener": base[:, None, :] + offsets[None],
                 "full": (base[:, None, None, :] + offsets[None, :, None]
                          + 0.05 * np.arange(O)[None, None, :, None])}[path]
    js, ts = _pair(assets, ffat=True, smooth_transfer=True)
    for s in (js, ts):
        s.set_listener(base[0])
        _hits(s)
    ref = js.render_moving(positions, blocks_per_dispatch=4)
    got = ts.render_moving(positions, blocks_per_dispatch=4)
    assert got.shape == ref.shape == (t * S, L)
    assert dberr(got, ref) <= -100
    assert ts.sample_clock == t * S
    with pytest.raises(ValueError, match="listener path"):
        ts.render_moving(np.ones((2, L + 1, 3)))


def test_checkpoint_is_bitwise(assets, tmp_path):
    """save_session / load_session carry [L, O, M] rows: the restored
    session renders the next blocks bitwise equal."""
    _, ts = _pair(assets, ffat=True)
    ts.set_listener(_listeners((L, 3)))
    _hits(ts, when=4 * S)
    ts.render(2)
    path = str(tmp_path / "multi.npz")
    save_session(path, ts)
    want = ts.render(4)
    _, fresh = _pair(assets, ffat=True)
    load_session(path, fresh)
    assert fresh.sample_clock == 2 * S
    np.testing.assert_array_equal(fresh.render(4), want)
    _, single = _pair(assets, nl=1, ffat=True)
    with pytest.raises(ValueError, match="shape"):
        load_session(path, single)
