"""Port parity: the transfer-ramp (xfade) block steps and the session's
smooth listener moves (openpbso_tpu_torch ops/integrator.py, runtime/solver.py,
runtime/session.py) against the JAX package on the same numpy inputs, and the
relations tests/test_xfade.py holds, on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import integrator as ji
from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.runtime.solver import step_block_xfade as j_step_xfade
from openpbso_tpu.runtime.state import make_solver_state as j_make_state
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy, state_from_numpy
from openpbso_tpu_torch.ops import fused_integrator
from openpbso_tpu_torch.ops import integrator as ti
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import (SolverConfig, step_block,
                                               step_block_xfade)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 128


def _jax_bank(o, n, s, hetero):
    if not hetero:
        md = synth_mode_data(n, 8, seed=5)
        return bank_from_material(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                                  block_size=s, dtype=jnp.float32)
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(o)]
    lam, b, v = (np.stack(x) for x in zip(*parts))
    return build_modal_bank(lam, b, v, block_size=s, shared=False,
                            dtype=jnp.float32)


def _case(o=3, n=40, s=S, hetero=True, seed=1):
    jb = _jax_bank(o, n, s, hetero)
    tb = bank_from_numpy(jax.tree.map(np.asarray, jb), device="cpu")
    m = jb.num_modes
    mask = np.asarray(jb.mask)
    rng = np.random.default_rng(seed)
    x = dict(z_re=rng.standard_normal((o, m)) * mask,
             z_im=rng.standard_normal((o, m)) * mask,
             space=rng.standard_normal((o, m)) * mask,
             tp=rng.standard_normal((o, s)),
             tr_prev=rng.uniform(0.5, 2.0, (o, m)),
             tr=rng.uniform(0.5, 2.0, (o, m)),
             ti_prev=rng.uniform(-1.0, 1.0, (o, m)),
             ti=rng.uniform(-1.0, 1.0, (o, m)))
    return jb, tb, {k: v.astype(np.float32) for k, v in x.items()}


def _args(bank, x, conv):
    return (conv(x["z_re"]), conv(x["z_im"]), bank, conv(x["space"]),
            conv(x["tp"]), conv(x["tr_prev"]), conv(x["tr"]))


@pytest.mark.parametrize("complex_rows", [None, "both", "fade_in"])
def test_xfade_rows_match_jax(complex_rows):
    jb, tb, x = _case()
    pim = x["ti_prev"] if complex_rows == "both" else None
    nim = x["ti"] if complex_rows else None
    ref = ji._xfade_rows(jnp.asarray(x["tr_prev"]), jnp.asarray(x["tr"]),
                         None if pim is None else jnp.asarray(pim),
                         None if nim is None else jnp.asarray(nim), jb.mask)
    got = ti._xfade_rows(torch.from_numpy(x["tr_prev"]),
                         torch.from_numpy(x["tr"]),
                         None if pim is None else torch.from_numpy(pim),
                         None if nim is None else torch.from_numpy(nim),
                         tb.mask)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:   # products and differences of the same floats
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("complex_rows", [False, True])
@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("backend", ["scan", "blocked"])
def test_xfade_step_matches_jax(backend, hetero, complex_rows, dberr):
    """<= -100 dB on state and sound, qnorm included."""
    jb, tb, x = _case(hetero=hetero)
    jfn = getattr(ji, f"step_block_{backend}_xfade")
    tfn = getattr(ti, f"step_block_{backend}_xfade")
    kw_j = kw_t = {}
    if complex_rows:
        kw_j = dict(transfer_prev_im=jnp.asarray(x["ti_prev"]),
                    transfer_im=jnp.asarray(x["ti"]))
        kw_t = dict(transfer_prev_im=torch.from_numpy(x["ti_prev"]),
                    transfer_im=torch.from_numpy(x["ti"]))
    ref = jfn(*_args(jb, x, jnp.asarray), True, **kw_j)
    got = tfn(*_args(tb, x, torch.from_numpy), True, **kw_t)
    for name, a, b in zip(("z_re", "z_im", "sound", "qnorm"), got, ref):
        assert a.dtype == torch.float32, name
        assert dberr(a.numpy(), np.asarray(b)) <= -100, name


def _states(jb, x, num_slots=4):
    """One JAX state with a live gaussian slot per object, and its port
    copy."""
    o, m = x["z_re"].shape
    st = j_make_state(o, m, num_slots=num_slots, dtype=jnp.float32)
    slots = dataclasses.replace(
        st.slots, ftype=st.slots.ftype.at[:, 0].set(2),
        width=st.slots.width.at[:, 0].set(30.0),
        space=st.slots.space.at[:, 0].set(jnp.asarray(x["space"])))
    st = dataclasses.replace(st, slots=slots, z_re=jnp.asarray(x["z_re"]),
                             z_im=jnp.asarray(x["z_im"]),
                             transfer=jnp.asarray(x["tr"]))
    return st, state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")


@pytest.mark.parametrize("backend,hetero", [("blocked", False),
                                            ("blocked", True),
                                            ("scan", True),
                                            ("pallas", True)])
def test_solver_step_block_xfade_matches_jax(backend, hetero, dberr):
    """step_block_xfade; 'pallas'/'fused' ramps through the blocked form in
    both packages, so no kernel twin runs."""
    jb, tb, x = _case(hetero=hetero)
    jst, tst = _states(jb, x)
    gains = np.ones((x["z_re"].shape[0], 2), np.float32)
    jnew, jsnd, jmix, _ = j_step_xfade(
        jst, jb, jnp.asarray(gains), jnp.asarray(x["tr_prev"]),
        block_size=S, backend=backend)
    tnew, tsnd, tmix, q = step_block_xfade(
        tst, tb, torch.from_numpy(gains), torch.from_numpy(x["tr_prev"]),
        block_size=S, backend=backend)
    assert q is None and fused_integrator.LAUNCHES == 0
    assert dberr(tsnd.numpy(), np.asarray(jsnd)) <= -100
    assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100
    assert dberr(tnew.z_im.numpy(), np.asarray(jnew.z_im)) <= -100
    assert tnew.block_start == int(np.asarray(jnew.block_start)) == S


# ------------------------------------------------ tests/test_xfade.py's five

BLOCK = 256
M = 16


def _session(smooth, backend="blocked"):
    from openpbso_tpu_torch.ops.coeffs import bank_from_material as t_bank
    md = synth_mode_data(M, 8, seed=9)
    bank = t_bank(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                  CERAMIC.beta, block_size=BLOCK, device="cpu")
    return ModalSession(bank, config=SolverConfig(
        block_size=BLOCK, backend=backend, smooth_transfer=smooth))


def _ring(sess):
    rng = np.random.default_rng(1)
    sess.hit(0, rng.standard_normal(M), kind="gaussian", width_us=400.0)
    for _ in range(3):
        sess.step()


def test_xfade_is_linear_blend_of_constant_transfers():
    s = _session(False)
    _ring(s)
    t_prev = s.state.transfer
    t_new = t_prev * torch.linspace(0.2, 3.0, t_prev.shape[-1])[None, :]
    kw = dict(block_size=BLOCK, backend="blocked")
    st_new = dataclasses.replace(s.state, transfer=t_new)
    _, snd_a, _, _ = step_block(s.state, s.bank, s.gains, **kw)     # t_prev
    st_ref, snd_b, _, _ = step_block(st_new, s.bank, s.gains, **kw)  # t_new
    st2, snd_x, _, _ = step_block_xfade(st_new, s.bank, s.gains, t_prev, **kw)
    ramp = (np.arange(1, BLOCK + 1) / BLOCK)[None, :]
    blend = (1 - ramp) * snd_a.numpy() + ramp * snd_b.numpy()
    scale = np.abs(blend).max()
    np.testing.assert_allclose(snd_x.numpy() / scale, blend / scale,
                               rtol=0, atol=1e-5)
    # endpoint: the last sample sits on the t_new side (ramp weight 1)
    np.testing.assert_allclose(snd_x.numpy()[:, -1], snd_b.numpy()[:, -1],
                               rtol=1e-5)
    # the state update does not depend on the transfer
    np.testing.assert_array_equal(st2.z_re.numpy(), st_ref.z_re.numpy())


def test_xfade_backends_agree(dberr):
    s = _session(False)
    _ring(s)
    t_prev = s.state.transfer
    st = dataclasses.replace(s.state, transfer=t_prev * 2.5)
    snds = [step_block_xfade(st, s.bank, s.gains, t_prev, block_size=BLOCK,
                             backend=b)[1].numpy()
            for b in ("blocked", "scan", "fused")]
    assert dberr(snds[0], snds[1]) < -100
    # every table-form backend ramps through the blocked form
    np.testing.assert_array_equal(snds[2], snds[0])


def test_xfade_noop_matches_plain_step():
    s = _session(False)
    _ring(s)
    kw = dict(block_size=BLOCK, backend="blocked")
    _, snd_p, _, _ = step_block(s.state, s.bank, s.gains, **kw)
    _, snd_x, _, _ = step_block_xfade(s.state, s.bank, s.gains,
                                      s.state.transfer, **kw)
    np.testing.assert_array_equal(snd_x.numpy(), snd_p.numpy())


def test_session_smooth_listener_reduces_discontinuity():
    outs = {}
    for smooth in (False, True):
        s = _session(smooth)
        _ring(s)
        # fake a listener-driven transfer jump (no FFAT in this bank):
        # smooth sessions remember the outgoing rows like set_listener does
        pre = s.step()[1].numpy()              # block before the jump
        t_new = s.state.transfer * 4.0
        if smooth:
            s._xfade_from = (s.state.transfer, None)
        s.state = dataclasses.replace(s.state, transfer=t_new)
        outs[smooth] = np.concatenate(
            [pre] + [s.step()[1].numpy() for _ in range(2)])
        assert s._xfade_from is None
    # the discontinuity at the seam where the 4x transfer jump lands,
    # against the stream's own sample-to-sample slope
    for smooth, a in outs.items():
        seam = abs(a[BLOCK, 0] - a[BLOCK - 1, 0])
        slope = np.abs(np.diff(a[BLOCK - 32:BLOCK - 1, 0])).max()
        if smooth:
            assert seam < 2.0 * slope, (seam, slope)   # no audible step
        else:
            assert seam > 3.0 * slope, (seam, slope)   # the level step
    # after the ramp block both agree (the transfer settled at t_new)
    np.testing.assert_array_equal(outs[True][2 * BLOCK:],
                                  outs[False][2 * BLOCK:])


def test_smooth_plus_decay_interaction():
    s = _session(True)
    s.hit(0, np.ones(M), kind="point")
    while not s._idle():
        s.step()
    s.step()  # decay path
    s._xfade_from = (s.state.transfer, None)
    s.state = dataclasses.replace(s.state, transfer=s.state.transfer * 2.0)
    s.step()  # xfade goes ahead of decay and consumes the pending move
    assert s._xfade_from is None
    assert np.isfinite(s.step()[1].numpy()).all()  # back on the decay path
