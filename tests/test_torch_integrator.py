"""Port parity: per-block integrator backends (openpbso_tpu_torch.ops.integrator).

The JAX bank is built once in float32 and carried across with convert.py,
so both packages step from identical tables; the numpy inputs are shared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import integrator as ji
from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy
from openpbso_tpu_torch.ops import integrator as ti

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 128


def _jax_bank(o, n, s, hetero, tables=True):
    if not hetero:
        md = synth_mode_data(n, 8, seed=5)
        return bank_from_material(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                                  block_size=s if tables else None,
                                  dtype=jnp.float32)
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(o)]
    lam, b, v = (np.stack(x) for x in zip(*parts))
    return build_modal_bank(lam, b, v, block_size=s if tables else None,
                            shared=False, dtype=jnp.float32)


def _case(o=3, n=40, s=S, hetero=True, seed=1, tables=True):
    jb = _jax_bank(o, n, s, hetero, tables)
    tb = bank_from_numpy(jax.tree.map(np.asarray, jb), device="cpu")
    m = jb.num_modes
    mask = np.asarray(jb.mask)
    rng = np.random.default_rng(seed)
    x = dict(z_re=rng.standard_normal((o, m)) * mask,
             z_im=rng.standard_normal((o, m)) * mask,
             space=rng.standard_normal((o, m)) * mask,
             tp=rng.standard_normal((o, s)),
             tr=rng.uniform(0.5, 2.0, (o, m)))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    return jb, tb, x


def _args(bank, x, conv):
    return (conv(x["z_re"]), conv(x["z_im"]), bank, conv(x["space"]),
            conv(x["tp"]), conv(x["tr"]))


def _close(got, ref, dberr, bar):
    for name, a, b in zip(("z_re", "z_im", "sound"), got[:3], ref[:3]):
        assert a.dtype == torch.float32, name
        assert dberr(a.numpy(), np.asarray(b)) <= bar, name


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("backend", ["scan", "blocked"])
def test_step_block_matches_jax(backend, hetero, dberr):
    jb, tb, x = _case(hetero=hetero)
    ref = ji.BACKENDS[backend](*_args(jb, x, jnp.asarray), False)
    got = ti.BACKENDS[backend](*_args(tb, x, torch.from_numpy), False)
    _close(got, ref, dberr, -110)
    assert got[3] is None


@pytest.mark.parametrize("hetero", [False, True])
def test_decay_block_matches_jax(hetero, dberr):
    jb, tb, x = _case(hetero=hetero)
    ref = ji.decay_block_blocked(jnp.asarray(x["z_re"]),
                                 jnp.asarray(x["z_im"]), jb,
                                 jnp.asarray(x["tr"]), False)
    got = ti.decay_block_blocked(torch.from_numpy(x["z_re"]),
                                 torch.from_numpy(x["z_im"]), tb,
                                 torch.from_numpy(x["tr"]), False)
    _close(got, ref, dberr, -110)


def test_decay_equals_blocked_with_zero_excitation():
    _, tb, x = _case()
    zr, zi, tr = (torch.from_numpy(x[k]) for k in ("z_re", "z_im", "tr"))
    zero = torch.zeros(tr.shape[0], S)
    full = ti.step_block_blocked(zr, zi, tb, torch.zeros_like(tr), zero, tr)
    decay = ti.decay_block_blocked(zr, zi, tb, tr)
    for a, b in zip(full[:3], decay[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_scan_runs_table_less_banks(dberr):
    jb, tb, x = _case(hetero=False, tables=False)
    assert tb.pow_re is None
    ref = ji.step_block_scan(*_args(jb, x, jnp.asarray), False)
    got = ti.step_block_scan(*_args(tb, x, torch.from_numpy), False)
    _close(got, ref, dberr, -110)


@pytest.mark.parametrize("rows", ["complex", "listeners"])
def test_blocked_complex_and_listener_rows(rows, dberr):
    jb, tb, x = _case()
    rng = np.random.default_rng(9)
    extra = rng.uniform(-1.0, 1.0, x["tr"].shape).astype(np.float32)
    if rows == "complex":
        kw_j = dict(transfer_im=jnp.asarray(extra))
        kw_t = dict(transfer_im=torch.from_numpy(extra))
        jargs, targs = _args(jb, x, jnp.asarray), _args(tb, x,
                                                        torch.from_numpy)
    else:
        rows2 = np.stack([x["tr"], extra])          # [L=2, O, M]
        jargs = _args(jb, x, jnp.asarray)[:5] + (jnp.asarray(rows2),)
        targs = _args(tb, x, torch.from_numpy)[:5] + (
            torch.from_numpy(rows2),)
        kw_j = kw_t = {}
    ref = ji.step_block_blocked(*jargs, False, **kw_j)
    got = ti.step_block_blocked(*targs, False, **kw_t)
    _close(got, ref, dberr, -110)


def test_qnorm_is_not_ported():
    """No backend refuses qnorm any more: each returns the [O, M] per-mode
    energies (held against the JAX package in test_torch_qnorm.py)."""
    _, tb, x = _case()
    args = _args(tb, x, torch.from_numpy)
    assert not hasattr(ti, "_QNORM_NOT_PORTED")
    for fn in (ti.step_block_scan, ti.step_block_blocked):
        qnorm = fn(*args, True)[3]
        assert qnorm.shape == x["z_re"].shape and (qnorm >= 0).all()
        assert float(qnorm.max()) > 0


def test_blocked_rejects_tables_of_another_block_size():
    _, tb, x = _case(s=64)
    args = list(_args(tb, x, torch.from_numpy))
    args[4] = torch.zeros(3, 128)
    with pytest.raises(ValueError):
        ti.step_block_blocked(*args)


@pytest.mark.parametrize("has_tables,shared,device,expect", [
    (False, False, "cuda", "scan"),
    (False, True, "cpu", "scan"),
    (True, False, "cuda", "fused"),
    (True, True, "cuda", "blocked"),
    (True, False, "cpu", "blocked"),
    (True, True, "cpu", "blocked"),
])
def test_auto_backend_decision(has_tables, shared, device, expect):
    assert ti.auto_backend(has_tables, shared, device) == expect


def test_resolve_backend_name():
    _, hetero, _ = _case()
    _, shared, _ = _case(hetero=False)
    _, table_less, _ = _case(tables=False)
    assert ti.resolve_backend_name("auto", hetero) == "blocked"   # on CPU
    assert ti.resolve_backend_name("auto", shared) == "blocked"
    assert ti.resolve_backend_name("auto", table_less) == "scan"
    assert ti.resolve_backend_name("auto") == "blocked"
    assert ti.resolve_backend_name("pallas", hetero) == "fused"
    assert ti.resolve_backend_name("scan", hetero) == "scan"
    from openpbso_tpu_torch.ops.fused_integrator import step_block_fused
    assert ti.get_backend("pallas") is step_block_fused
    assert ti.get_backend("fused") is step_block_fused
    with pytest.raises(KeyError):
        ti.get_backend("nope")
