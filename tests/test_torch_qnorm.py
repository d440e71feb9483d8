"""Port parity: the per-mode energy telemetry (qnorm) of every per-block
backend, the decay step and the session's probe against the JAX package on
the same numpy inputs, <= -100 dB. The JAX Pallas kernel runs in interpret
mode; the port's fused backend runs its plain twin and takes qnorm from the
blocked form, as the reference does.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import integrator as ji
from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.ops.pallas_integrator import step_block_pallas
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy
from openpbso_tpu_torch.ops import integrator as ti
from openpbso_tpu_torch.ops.fused_integrator import step_block_fused
from openpbso_tpu_torch.runtime.session import ModalSession as TSession
from openpbso_tpu_torch.runtime.solver import SolverConfig as TConfig
from openpbso_tpu_torch.runtime.state import state_leaves


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
             tr=rng.uniform(0.5, 2.0, (o, m)))
    return jb, tb, {k: v.astype(np.float32) for k, v in x.items()}


def _args(bank, x, conv):
    return (conv(x["z_re"]), conv(x["z_im"]), bank, conv(x["space"]),
            conv(x["tp"]), conv(x["tr"]))


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("backend", ["scan", "blocked", "fused"])
def test_step_qnorm_matches_jax(backend, hetero, dberr):
    jb, tb, x = _case(hetero=hetero)
    jfn = (partial(step_block_pallas, interpret=True) if backend == "fused"
           else ji.BACKENDS[backend])
    tfn = step_block_fused if backend == "fused" else ti.BACKENDS[backend]
    ref = jfn(*_args(jb, x, jnp.asarray), True)
    got = tfn(*_args(tb, x, torch.from_numpy), True)
    assert got[3].shape == x["z_re"].shape and got[3].dtype == torch.float32
    for name, a, b in zip(("z_re", "z_im", "sound", "qnorm"), got, ref):
        assert dberr(a.numpy(), np.asarray(b)) <= -100, name
    # the telemetry changes neither the step nor the sound
    plain = tfn(*_args(tb, x, torch.from_numpy), False)
    assert plain[3] is None
    for a, b in zip(got[:3], plain[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_qnorm_is_the_blocked_forms():
    _, tb, x = _case()
    args = _args(tb, x, torch.from_numpy)
    np.testing.assert_array_equal(
        step_block_fused(*args, True)[3].numpy(),
        ti.step_block_blocked(*args, True)[3].numpy())


def test_scan_and_blocked_qnorm_agree(dberr):
    """The bar tests/test_integrator.py holds between the two forms
    (< -100 dB), here in float32 at S = 512."""
    _, tb, x = _case(o=4, n=60, s=512)
    args = _args(tb, x, torch.from_numpy)
    a = ti.step_block_scan(*args, True)[3].numpy()
    b = ti.step_block_blocked(*args, True)[3].numpy()
    assert dberr(b, a) < -100


@pytest.mark.parametrize("hetero", [False, True])
def test_decay_qnorm_matches_jax(hetero, dberr):
    jb, tb, x = _case(hetero=hetero)
    ref = ji.decay_block_blocked(jnp.asarray(x["z_re"]),
                                 jnp.asarray(x["z_im"]), jb,
                                 jnp.asarray(x["tr"]), True)
    got = ti.decay_block_blocked(torch.from_numpy(x["z_re"]),
                                 torch.from_numpy(x["z_im"]), tb,
                                 torch.from_numpy(x["tr"]), True)
    for name, a, b in zip(("z_re", "z_im", "sound", "qnorm"), got, ref):
        assert dberr(a.numpy(), np.asarray(b)) <= -100, name
    # a decay block is the full step with zero excitation, qnorm included
    zero = torch.zeros(x["tp"].shape)
    full = ti.step_block_blocked(torch.from_numpy(x["z_re"]),
                                 torch.from_numpy(x["z_im"]), tb,
                                 torch.zeros_like(got[0]), zero,
                                 torch.from_numpy(x["tr"]), True)
    assert dberr(got[3].numpy(), full[3].numpy()) <= -120


def _sessions(backend="blocked", qnorm=True):
    jb, tb, x = _case()
    js = JSession(jb, config=JConfig(block_size=S, backend=backend,
                                     compute_qnorm=qnorm))
    ts = TSession(tb, config=TConfig(block_size=S, backend=backend,
                                     compute_qnorm=qnorm))
    return js, ts, x


def test_session_qnorm_matches_jax(dberr):
    """Full steps, then decay steps, each with its qnorm."""
    js, ts, x = _sessions()
    for sess in (js, ts):
        sess.hit(0, x["space"][0], kind="gaussian", width_us=300.0)
        sess.hit(2, x["space"][2], kind="point")
    kinds = set()
    for _ in range(6):
        kinds.add(ts._idle())
        _, jmix, jq = js.step()
        _, tmix, tq = ts.step()
        assert dberr(tq.numpy(), np.asarray(jq)) <= -100
        assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100
    assert kinds == {False, True}      # both the full and the decay step


def test_session_reads_its_config_at_each_step():
    """The engine turns qnorm on for single blocks by swapping the frozen
    config; the session must not cache it."""
    import dataclasses
    _, ts, x = _sessions(qnorm=False)
    ts.hit(0, x["space"][0])
    assert ts.step()[2] is None
    ts.config = dataclasses.replace(ts.config, compute_qnorm=True)
    assert ts.step()[2] is not None
    ts.config = dataclasses.replace(ts.config, compute_qnorm=False)
    assert ts.step()[2] is None


def test_qnorm_probe_matches_jax_and_advances_nothing(dberr):
    js, ts, x = _sessions(qnorm=False)
    for sess in (js, ts):
        sess.hit(1, x["space"][1], kind="gaussian", width_us=300.0)
        sess.step()
        sess.step()
    assert ts.qnorm_probe_eligible() and js.qnorm_probe_eligible()
    before = [v.clone() if isinstance(v, torch.Tensor) else v
              for v in state_leaves(ts.state)]
    clock = ts.sample_clock
    got = ts.qnorm_probe()
    assert got.shape == (3, ts.bank.num_modes) and float(got.max()) > 0
    assert dberr(got.numpy(), np.asarray(js.qnorm_probe())) <= -100
    assert ts.sample_clock == clock
    for a, b in zip(before, state_leaves(ts.state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    # the probe is the decay block's qnorm of the state as it stands
    _, _, nxt = ts.step()          # still forced: no qnorm asked, None
    assert nxt is None


def test_probe_needs_the_power_tables():
    from openpbso_tpu_torch.ops.coeffs import bank_from_material as t_bank
    md = synth_mode_data(8, 4)
    bank = t_bank(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                  CERAMIC.beta, device="cpu")          # no block_size
    assert not TSession(bank).qnorm_probe_eligible()
