"""Port parity: the span in all three forms (openpbso_tpu_torch.ops.span:
chunked with and without superchunk powers, factored, full), its kernels'
plain twins, and the span entries of the solver and the session.

The same numpy inputs, made from a seed, go through the JAX package and the
port; banks and span tables are built in the JAX package and carried across
by convert.py, or built by the port from the same float64 eigenvalues
(bitwise equal). The bar is the JAX package's own for its span
(tests/test_span.py): <= -100 dB. On the CPU the kernel wrappers
(chunk_scan, toeplitz_conv) run their plain twins; tests/test_torch_gpu.py
and chip_smoke.py hold the CUDA kernels against those twins on a GPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import forces as jf
from openpbso_tpu.ops import span as js
from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.runtime import solver as jsolver
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.runtime.state import make_solver_state as j_make_state
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import (bank_from_numpy,
                                        span_tables_from_numpy,
                                        state_from_numpy)
from openpbso_tpu_torch.ops import chunk_scan as k1
from openpbso_tpu_torch.ops import forces as tf
from openpbso_tpu_torch.ops import span as ts
from openpbso_tpu_torch.ops import toeplitz_conv as k2
from openpbso_tpu_torch.runtime import session as t_session_mod
from openpbso_tpu_torch.runtime import solver as tsolver
from openpbso_tpu_torch.runtime.session import ModalSession as TSession
from openpbso_tpu_torch.runtime.solver import SolverConfig as TConfig

O, M, S = 3, 10, 64
LAYOUTS = ("shared", "hetero")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def banks():
    """layout -> (JAX bank, port bank, lam64), as tests/test_span.py
    builds them."""
    out = {}
    md = synth_mode_data(M, 8, seed=11)
    lam, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta)
    jb = bank_from_material(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                            CERAMIC.beta, num_objects=O, block_size=S,
                            dtype=jnp.float32)
    out["shared"] = (jb, bank_from_numpy(_np(jb), device="cpu"), lam)
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        M, 8, seed=50 + i, f_low=80.0 + 7 * i,
        f_high=9000.0 + 100 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(O)]
    lam, b, v = (np.stack(x) for x in zip(*parts))
    jb = build_modal_bank(lam, b, v, block_size=S, shared=False,
                          dtype=jnp.float32)
    out["hetero"] = (jb, bank_from_numpy(_np(jb), device="cpu"), lam)
    return out


def _radix(n_blocks):
    """nb=64 uses one-block chunks (X = 64), which puts the JAX package's
    shared tables on its superchunk path; the others take choose_radix."""
    return S if n_blocks == 64 else None


def _tables(lam64, bank, n_blocks):
    kw = dict(num_modes=bank.num_modes, radix=_radix(n_blocks))
    return (js.build_span_tables(lam64, n_blocks * S, **kw),
            ts.build_span_tables(lam64, n_blocks * S, device="cpu", **kw))


def _seeded_state(bank, n_blocks, rows="plain", seed=0):
    """A JAX state and its port copy: a ringing start state, a gaussian at
    the span start, a point hit at block n_blocks // 2 and a hertz contact
    at block n_blocks // 4; transfer rows [O, M], [L=3, O, M], or complex."""
    o, m = bank.num_objects, bank.num_modes
    rng = np.random.default_rng(seed)
    mask = np.asarray(bank.mask)
    st = j_make_state(o, m, num_slots=4, dtype=jnp.float32,
                      num_listeners=3 if rows == "listeners" else 1)
    slots = st.slots
    slots = dataclasses.replace(
        slots,
        ftype=slots.ftype.at[:, 0].set(2).at[:, 1].set(1).at[:, 2].set(3),
        width=slots.width.at[:, 0].set(9.0).at[:, 2].set(150.0),
        t0=slots.t0.at[:, 1].set(S * (n_blocks // 2))
        .at[:, 2].set(S * (n_blocks // 4)),
        space=jnp.asarray(rng.standard_normal((o, 4, m)), jnp.float32))

    def f32(a):
        return jnp.asarray(a, jnp.float32)
    st = dataclasses.replace(
        st, slots=slots,
        z_re=f32(rng.standard_normal((o, m)) * mask * 1e-3),
        z_im=f32(rng.standard_normal((o, m)) * mask * 1e-3),
        transfer=f32(rng.uniform(0.5, 2.0, st.transfer.shape)))
    if rows == "complex":
        st = dataclasses.replace(st, transfer_im=f32(
            rng.uniform(-1.0, 1.0, (o, m))))
    return st, state_from_numpy(_np(st), device="cpu")


def _gains(st):
    n = st.transfer.shape[0] if st.transfer.ndim == 3 else 2
    g = np.random.default_rng(5).uniform(0.5, 1.5, (O, n)).astype(np.float32)
    return jnp.asarray(g), torch.from_numpy(g)


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("span,target", [
    (512, None), (512 * 8, None), (512 * 512, None), (256, None),
    (512 * 3, None), (7, None), (13 * 13, 16)])
def test_choose_radix_matches_jax(span, target):
    assert ts.choose_radix(span, target) == js.choose_radix(span, target)


@pytest.mark.parametrize("n_blocks", [1, 8, 64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_span_tables_bitwise_equal_jax(banks, layout, n_blocks):
    jbank, tbank, lam64 = banks[layout]
    jt, tt = _tables(lam64, jbank, n_blocks)
    assert tt.shared == jt.shared == (layout == "shared")
    assert (tt.chunk, tt.n_chunks, tt.span) == (jt.chunk, jt.n_chunks,
                                                n_blocks * S)
    assert tt.superchunk == jt.superchunk
    _assert_tables_bitwise(tt, jt)


def _assert_tables_bitwise(tt, jt):
    """Every table of the port's tables bitwise the JAX tables' (None
    where JAX's is None), and convert.py carries JAX's across unchanged.
    The port's chunk tables also have ``planes`` (the kernels' layout,
    made where the tables are used), which neither builder attaches."""
    assert type(tt).__name__ == type(jt).__name__
    conv = span_tables_from_numpy(_np(jt), device="cpu")
    assert type(conv) is type(tt)
    for f in dataclasses.fields(tt):
        if f.name == "planes":
            assert tt.planes is None and conv.planes is None
            assert not hasattr(jt, "planes")
            continue
        got, ref = getattr(tt, f.name), getattr(jt, f.name)
        if not isinstance(got, torch.Tensor):
            assert got == ref == getattr(conv, f.name), f.name
            continue
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert torch.equal(getattr(conv, f.name), got)


FORM_CASES = [("hetero", "chunked"), ("hetero", "factored"),
              ("shared", "chunked"), ("shared", "factored"),
              ("shared", "full")]


@pytest.mark.parametrize("form", ["factored", "full"])
def test_other_span_forms_are_refused(banks, form, dberr):
    """Once refused by the port, the factored and full forms now build:
    bitwise JAX's tables, and one span through them at <= -100 dB."""
    jbank, tbank, lam64 = banks["shared"]
    kw = dict(num_modes=tbank.num_modes, form=form)
    jt = js.build_span_tables(lam64, 8 * S, **kw)
    tt = ts.build_span_tables(lam64, 8 * S, device="cpu", **kw)
    assert isinstance(tt, {"factored": ts.SpanTables,
                           "full": ts.FullSpanTables}[form])
    assert tt.span == jt.span == 8 * S and tt.shared
    _assert_tables_bitwise(tt, jt)
    j_st, t_st = _seeded_state(jbank, 8)
    jg, tg = _gains(j_st)
    _, j_mix = jsolver.step_span(j_st, jbank, jt, jg, n_blocks=8,
                                 block_size=S, with_sustained=False)
    _, t_mix = tsolver.step_span(t_st, tbank, tt, tg, n_blocks=8,
                                 block_size=S)
    assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100


@pytest.mark.parametrize("layout,form", FORM_CASES)
def test_form_tables_bitwise_equal_jax(banks, layout, form):
    jbank, _, lam64 = banks[layout]
    kw = dict(num_modes=jbank.num_modes, form=form)
    _assert_tables_bitwise(
        ts.build_span_tables(lam64, 8 * S, device="cpu", **kw),
        js.build_span_tables(lam64, 8 * S, **kw))


def test_full_table_built_in_pieces_is_bitwise_one_piece(banks,
                                                         monkeypatch):
    """The full table's host build in pieces of powers gives the values of
    the JAX package's one-call build, bitwise, across piece edges."""
    jbank, _, lam64 = banks["shared"]
    monkeypatch.setattr(ts, "FULL_TABLE_PIECE", 7)
    tt = ts.build_span_tables(lam64, 4 * S, num_modes=jbank.num_modes,
                              form="full", device="cpu")
    _assert_tables_bitwise(tt, js.build_span_tables(
        lam64, 4 * S, num_modes=jbank.num_modes, form="full"))


def test_full_form_refuses_a_per_object_bank(banks):
    _, tbank, lam64 = banks["hetero"]
    with pytest.raises(ValueError, match="need a shared bank"):
        ts.build_span_tables(lam64, 2 * S, num_modes=tbank.num_modes,
                             form="full", device="cpu")
    with pytest.raises(ValueError, match="unknown span form"):
        ts.build_span_tables(lam64, 2 * S, num_modes=tbank.num_modes,
                             form="blocked", device="cpu")


@pytest.mark.parametrize("n_chunks,shared,opt_in,want", [
    (63, True, False, 1), (64, True, False, 32), (512, True, False, 32),
    (96, True, False, 32), (80, True, False, 20), (67, True, False, 1),
    (64, False, False, 1), (64, False, True, 32), (8, True, True, 1)])
def test_superchunk_group_is_jax_rule(banks, n_chunks, shared, opt_in, want):
    """The default group G: the largest divisor of X up to 32 once
    X >= 64, for shared banks and per-object banks that opt in; the
    tables bitwise JAX's."""
    _, tbank, lam64 = banks["shared" if shared else "hetero"]
    kw = dict(radix=8, hetero_superchunk=opt_in)
    tt = ts.build_span_tables(lam64, n_chunks * 8, device="cpu", **kw)
    jt = js.build_span_tables(lam64, n_chunks * 8, **kw)
    assert tt.superchunk == jt.superchunk == want
    _assert_tables_bitwise(tt, jt)


def test_integrate_span_refuses_tables_of_another_length(banks):
    _, tbank, lam64 = banks["shared"]
    tt = ts.build_span_tables(lam64, 2 * S, num_modes=tbank.num_modes,
                              device="cpu")
    z = torch.zeros((O, tbank.num_modes))
    with pytest.raises(ValueError, match="built for 128 samples, got 192"):
        ts.integrate_span(z, z, tbank, tt, z[:, None],
                          torch.zeros((O, 1, 3 * S)), torch.ones_like(z))


# ------------------------------------------------------------------ forces


def _force_slots(ftype, width, t0):
    """Slot 1 of object 0 holds the force under test; slot 0 of object 1 a
    long gaussian (cross-slot sums); slot 2 of object 0 a point hit."""
    rng = np.random.default_rng(1)
    ft = np.zeros((2, 3), np.int32)
    t0s = np.zeros((2, 3), np.int32)
    wd = np.ones((2, 3), np.float32)
    ft[0, 1], t0s[0, 1], wd[0, 1] = ftype, t0, width
    ft[1, 0], wd[1, 0] = jf.FORCE_GAUSSIAN, 400.0
    ft[0, 2], t0s[0, 2] = jf.FORCE_POINT, 3 * S
    arrays = dict(ftype=ft, t0=t0s, width=wd,
                  amp=rng.uniform(0.5, 1.5, (2, 3)).astype(np.float32),
                  space=rng.standard_normal((2, 3, 5)).astype(np.float32))
    return (jf.ForceSlots(**{n: jnp.asarray(a) for n, a in arrays.items()}),
            tf.ForceSlots(**{n: torch.from_numpy(a)
                             for n, a in arrays.items()}))


@pytest.mark.parametrize("start", [0, 4 * S])
@pytest.mark.parametrize("kind", ["point", "gaussian", "hertz"])
def test_force_span_matches_jax_and_force_block(kind, start, dberr):
    ftype, width = {"point": (jf.FORCE_POINT, 1.0),
                    "gaussian": (jf.FORCE_GAUSSIAN, 9.0),
                    "hertz": (jf.FORCE_HERTZ, 150.0)}[kind]
    n_blocks = 8
    js_, ts_ = _force_slots(ftype, width, 2 * S)
    j_fk, j_sp = jf.force_span(js_, jnp.asarray(start, jnp.int32),
                               n_blocks * S, S)
    t_fk, t_sp = tf.force_span(ts_, start, n_blocks * S, S)
    assert t_fk.shape == (2, 3, n_blocks * S) and t_fk.dtype == torch.float32
    # membership (integer math) exactly; profiles to ulps of exp and sin
    np.testing.assert_array_equal(t_fk.numpy() != 0, np.asarray(j_fk) != 0)
    np.testing.assert_array_equal(t_sp.numpy(), np.asarray(j_sp))
    assert dberr(t_fk.numpy(), np.asarray(j_fk)) <= -120
    # every block of the span is force_block's excitation, bit for bit
    for b in range(n_blocks):
        tp, sp = tf.force_block(ts_, start + b * S, S)
        blk = t_fk[..., b * S:(b + 1) * S]
        member = (blk != 0).any(dim=-1)
        assert torch.equal(blk, tp[:, None, :] * member[..., None])
        assert torch.equal((t_sp * member[..., None]).sum(dim=1), sp)


# ------------------------------------------------------- kernel twins


def _scan_inputs(tables, decay, seed=2):
    rng = np.random.default_rng(seed)
    o, m = O, tables.b_re.shape[-1]
    z = rng.standard_normal((2, o, m)).astype(np.float32)
    inj = rng.standard_normal((2, o, tables.n_chunks, m)).astype(np.float32)
    return z, (None if decay else inj)


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_chunk_scan_twin_matches_jax_scan(banks, layout, decay, dberr):
    """K1's twin against the lax.scan of JAX's _chunk_start_states
    (single-level: X = 16 < 64 carries no superchunk powers)."""
    jbank, tbank, lam64 = banks[layout]
    jt = js.build_span_tables(lam64, 8 * S, num_modes=jbank.num_modes,
                              radix=S // 2)
    assert jt.superchunk == 1 and jt.n_chunks == 16
    tt = span_tables_from_numpy(_np(jt), device="cpu")
    z, inj = _scan_inputs(tt, decay)
    ref = js._chunk_start_states(
        jnp.asarray(z[0]), jnp.asarray(z[1]),
        None if decay else jnp.asarray(inj[0]),
        None if decay else jnp.asarray(inj[1]), jt)
    before = k1.LAUNCHES
    got = ts._chunk_start_states(
        torch.from_numpy(z[0]), torch.from_numpy(z[1]),
        None if decay else torch.from_numpy(inj[0]),
        None if decay else torch.from_numpy(inj[1]), tt)
    assert k1.LAUNCHES == before                  # the twin, no kernel
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert dberr(g.numpy(), np.asarray(r)) <= -120


def _jax_toeplitz(g, fc, nl):
    """span.py:575-585 verbatim: the Toeplitz gather and einsum."""
    o, k, x, c = fc.shape
    delta = np.arange(c)[:, None] - np.arange(c)[None, :]
    t_g = jnp.take(g, jnp.asarray(delta.clip(0)), axis=-1) \
        * jnp.asarray(delta >= 0, g.dtype)
    if nl > 1:
        return jnp.einsum("olkcj,okxj->olxc", t_g.reshape(o, nl, k, c, c),
                          fc, precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("okcj,okxj->oxc", t_g, fc,
                      precision=jax.lax.Precision.HIGHEST)[:, None]


@pytest.mark.parametrize("nl,k,x,c", [
    (1, 1, 4, 64), (3, 2, 5, 16), (1, 4, 3, 7), (3, 1, 1, 1)])
def test_toeplitz_twin_matches_jax_formula(nl, k, x, c, dberr):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((O, nl * k, c)).astype(np.float32)
    f = rng.standard_normal((O, k, x, c)).astype(np.float32)
    ref = np.asarray(_jax_toeplitz(jnp.asarray(g), jnp.asarray(f), nl))
    before = k2.LAUNCHES
    got = k2.toeplitz_conv(torch.from_numpy(g).reshape(O, nl, k, c),
                           torch.from_numpy(f))
    assert k2.LAUNCHES == before
    assert got.shape == (O, nl, x, c)
    assert dberr(got.numpy(), ref) <= -120


def test_kernel_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device gets no kernel and no
    fallback."""
    z = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no chunk_scan kernel"):
        k1.chunk_scan(z, z, z[:1], z[:1], 4)
    with pytest.raises(ValueError, match="no toeplitz_conv kernel"):
        k2.toeplitz_conv(torch.zeros((2, 1, 1, 8), device="meta"),
                         torch.zeros((2, 1, 3, 8), device="meta"))
    with pytest.raises(ValueError, match="shape mismatch"):
        k2.toeplitz_conv(torch.zeros((2, 1, 1, 8)), torch.zeros((2, 2, 3, 8)))


# -------------------------------------------------------- span vs JAX


@pytest.mark.parametrize("n_blocks", [1, 8, 64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_span_and_decay_match_jax(banks, layout, n_blocks, dberr):
    jbank, tbank, lam64 = banks[layout]
    jt, tt = _tables(lam64, jbank, n_blocks)
    # shared nb=64 takes both packages' two-level scan
    assert tt.superchunk == jt.superchunk == (
        32 if layout == "shared" and n_blocks == 64 else 1)
    j_st, t_st = _seeded_state(jbank, n_blocks)
    jg, tg = _gains(j_st)
    j_st, j_mix = jsolver.step_span(j_st, jbank, jt, jg, n_blocks=n_blocks,
                                    block_size=S, with_sustained=False)
    t_st, t_mix = tsolver.step_span(t_st, tbank, tt, tg, n_blocks=n_blocks,
                                    block_size=S)
    assert t_mix.shape == (n_blocks * S, 2) and t_mix.dtype == torch.float32
    assert np.abs(np.asarray(j_mix)).max() > 0
    assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100
    for name in ("z_re", "z_im"):
        assert dberr(getattr(t_st, name).numpy(),
                     np.asarray(getattr(j_st, name))) <= -100
    assert t_st.block_start == int(np.asarray(j_st.block_start))
    # then a ring-down span from the state the span left
    j_st, j_mix = jsolver.decay_span_step(j_st, jbank, jt, jg,
                                          n_blocks=n_blocks, block_size=S)
    t_st, t_mix = tsolver.decay_span_step(t_st, tbank, tt, tg,
                                          n_blocks=n_blocks, block_size=S)
    assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100
    assert dberr(t_st.z_im.numpy(), np.asarray(j_st.z_im)) <= -100
    assert t_st.block_start == int(np.asarray(j_st.block_start))


@pytest.mark.parametrize("rows", ["listeners", "complex"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_integrate_span_rows_match_jax(banks, layout, rows, dberr):
    """[L=3, O, M] listener rows (sound [O, L, N]) and complex rows, through
    integrate_span and decay_span."""
    jbank, tbank, lam64 = banks[layout]
    n_blocks = 4
    jt, tt = _tables(lam64, jbank, n_blocks)
    j_st, t_st = _seeded_state(jbank, n_blocks, rows=rows)
    j_fk, j_sp = jf.force_span(j_st.slots, j_st.block_start, n_blocks * S, S)
    t_fk, t_sp = tf.force_span(t_st.slots, t_st.block_start, n_blocks * S, S)
    ref = js.integrate_span(j_st.z_re, j_st.z_im, jbank, jt, j_sp, j_fk,
                            j_st.transfer, transfer_im=j_st.transfer_im)
    got = ts.integrate_span(t_st.z_re, t_st.z_im, tbank, tt, t_sp, t_fk,
                            t_st.transfer, transfer_im=t_st.transfer_im)
    shape = (O, 3, n_blocks * S) if rows == "listeners" else (O, n_blocks * S)
    assert got[2].shape == shape
    for g, r in zip(got, ref):
        assert dberr(g.numpy(), np.asarray(r)) <= -100
    ref = js.decay_span(j_st.z_re, j_st.z_im, jbank, jt, j_st.transfer,
                        transfer_im=j_st.transfer_im)
    got = ts.decay_span(t_st.z_re, t_st.z_im, tbank, tt, t_st.transfer,
                        transfer_im=t_st.transfer_im)
    assert got[2].shape == shape
    for g, r in zip(got, ref):
        assert dberr(g.numpy(), np.asarray(r)) <= -100
    # the span mixdown gives one channel per listener row
    jg, tg = _gains(j_st)
    assert dberr(tsolver._mixdown_span(got[2], tg).numpy(),
                 np.asarray(jsolver._mixdown_span(ref[2], jg))) <= -100


@pytest.mark.parametrize("layout,form", FORM_CASES)
def test_span_forms_match_jax(banks, layout, form, dberr):
    """tests/test_span.py's (layout, form) cases through both packages'
    step_span and decay_span_step: mix and state <= -100 dB."""
    jbank, tbank, lam64 = banks[layout]
    n_blocks = 8
    kw = dict(num_modes=jbank.num_modes, form=form)
    jt = js.build_span_tables(lam64, n_blocks * S, **kw)
    tt = ts.build_span_tables(lam64, n_blocks * S, device="cpu", **kw)
    assert tt.shared == jt.shared == (layout == "shared")
    j_st, t_st = _seeded_state(jbank, n_blocks)
    jg, tg = _gains(j_st)
    j_st, j_mix = jsolver.step_span(j_st, jbank, jt, jg, n_blocks=n_blocks,
                                    block_size=S, with_sustained=False)
    t_st, t_mix = tsolver.step_span(t_st, tbank, tt, tg, n_blocks=n_blocks,
                                    block_size=S)
    assert np.abs(np.asarray(j_mix)).max() > 0
    assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100
    for name in ("z_re", "z_im"):
        assert dberr(getattr(t_st, name).numpy(),
                     np.asarray(getattr(j_st, name))) <= -100
    j_st, j_mix = jsolver.decay_span_step(j_st, jbank, jt, jg,
                                          n_blocks=n_blocks, block_size=S)
    t_st, t_mix = tsolver.decay_span_step(t_st, tbank, tt, tg,
                                          n_blocks=n_blocks, block_size=S)
    assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100
    for name in ("z_re", "z_im"):
        assert dberr(getattr(t_st, name).numpy(),
                     np.asarray(getattr(j_st, name))) <= -100


@pytest.mark.parametrize("layout,form,n_blocks", [
    *((layout, form, 4) for layout, form in FORM_CASES),
    ("shared", "chunked", 64)])
def test_decay_span_equals_zero_excitation(banks, layout, form, n_blocks):
    """Zero excitation: decay_span is integrate_span, bitwise, in every
    form (as tests/test_span.py holds the JAX package's); shared nb=64
    takes the two-level scan."""
    _, tbank, lam64 = banks[layout]
    n = n_blocks * S
    tt = ts.build_span_tables(lam64, n, num_modes=tbank.num_modes,
                              form=form, radix=S if n_blocks == 64 else None,
                              device="cpu")
    assert getattr(tt, "superchunk", 1) == (32 if n_blocks == 64 else 1)
    o, m = tbank.num_objects, tbank.num_modes
    rng = np.random.default_rng(5)
    mask = tbank.mask.numpy()
    z_re, z_im = (torch.from_numpy(
        (rng.standard_normal((o, m)) * mask).astype(np.float32))
        for _ in range(2))
    transfer = torch.from_numpy(rng.uniform(0.5, 2.0, (o, m)).astype(
        np.float32))
    full = ts.integrate_span(z_re, z_im, tbank, tt, torch.zeros((o, 1, m)),
                             torch.zeros((o, 1, n)), transfer)
    dec = ts.decay_span(z_re, z_im, tbank, tt, transfer)
    for a, b in zip(full, dec):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["factored", "full"])
@pytest.mark.parametrize("rows", ["listeners", "complex"])
def test_factored_and_full_refuse_listener_and_complex_rows(banks, form,
                                                           rows):
    jbank, tbank, lam64 = banks["shared"]
    tt = ts.build_span_tables(lam64, 2 * S, num_modes=tbank.num_modes,
                              form=form, device="cpu")
    _, st = _seeded_state(jbank, 2, rows=rows)
    fk, sp = tf.force_span(st.slots, st.block_start, 2 * S, S)
    match = ("multi-listener" if rows == "listeners" else "complex") + \
        " transfer rows need the chunked"
    with pytest.raises(ValueError, match=match):
        ts.integrate_span(st.z_re, st.z_im, tbank, tt, sp, fk, st.transfer,
                          transfer_im=st.transfer_im)
    with pytest.raises(ValueError, match=match):
        ts.decay_span(st.z_re, st.z_im, tbank, tt, st.transfer,
                      transfer_im=st.transfer_im)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_superchunk_hierarchy_matches_jax(banks, layout, dberr):
    """tests/test_span.py's superchunk case through both packages: 64
    one-block chunks (G = 32; per-object banks opt in), with excitation
    and the sustained channel, then a ring-down, <= -100 dB against the
    JAX package; the superchunk powers bitwise JAX's; and the port's
    two-level scan against its own flat one."""
    from openpbso_tpu.ops.forces import ar_impulse_g
    jbank, tbank, lam64 = banks[layout]
    n_blocks = 64
    kw = dict(num_modes=jbank.num_modes, radix=S)
    if layout == "hetero":
        assert ts.build_span_tables(lam64, n_blocks * S, device="cpu",
                                    **kw).superchunk == 1
        kw["hetero_superchunk"] = True
    jt = js.build_span_tables(lam64, n_blocks * S, **kw)
    tt = ts.build_span_tables(lam64, n_blocks * S, device="cpu", **kw)
    assert tt.superchunk == jt.superchunk == 32
    _assert_tables_bitwise(tt, jt)
    flat = dataclasses.replace(tt, s_re=None, s_im=None)

    j_st, _ = _seeded_state(jbank, n_blocks)
    sus = j_st.sustained
    j_st = dataclasses.replace(j_st, sustained=dataclasses.replace(
        sus, active=sus.active.at[2].set(True),
        space=sus.space.at[2, :4].set(1.0)))
    t_st = state_from_numpy(_np(j_st), device="cpu")
    jg, tg = _gains(j_st)
    g = ar_impulse_g((0.783, 0.116), S)
    j_out, j_mix = jsolver.step_span(
        j_st, jbank, jt, jg, n_blocks=n_blocks, block_size=S,
        with_sustained=True, ar_g=jnp.asarray(g, jnp.float32))
    outs = [tsolver.step_span(t_st, tbank, tables, tg, n_blocks=n_blocks,
                              block_size=S, with_sustained=True,
                              ar_g=torch.as_tensor(g).float())
            for tables in (tt, flat)]
    for t_out, t_mix in outs:
        assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100
        assert dberr(t_out.z_re.numpy(), np.asarray(j_out.z_re)) <= -100
        assert dberr(t_out.sustained.ar_hist.numpy(),
                     np.asarray(j_out.sustained.ar_hist)) <= -100
    assert dberr(outs[0][1].numpy(), outs[1][1].numpy()) <= -100

    # ring-down from a random state
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2,) + tuple(j_st.z_re.shape)).astype(np.float32)
    ref = js.decay_span(jnp.asarray(z[0]), jnp.asarray(z[1]), jbank, jt,
                        j_st.transfer)
    for tables in (tt, flat):
        got = ts.decay_span(torch.from_numpy(z[0]), torch.from_numpy(z[1]),
                            tbank, tables, t_st.transfer)
        for a, b in zip(got, ref):
            assert dberr(a.numpy(), np.asarray(b)) <= -100


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_superchunk_passes_run_through_chunk_scan(banks, layout, decay,
                                                  monkeypatch, dberr):
    """Every serial pass of the two-level scan is a chunk_scan call: the
    group scan (rotation lam^(GC)), and for per-object banks passes A and
    C (rotation lam^C over [O * X/G, M] rows); each call's result is the
    JAX package's two-level scan's."""
    jbank, tbank, lam64 = banks[layout]
    kw = dict(num_modes=jbank.num_modes, radix=S // 2,
              hetero_superchunk=True)
    jt = js.build_span_tables(lam64, 64 * S // 2, **kw)
    tt = ts.build_span_tables(lam64, 64 * S // 2, device="cpu", **kw)
    assert tt.superchunk == 32 and tt.n_chunks == 64
    calls = []
    real = ts.chunk_scan

    def counted(z_re, z_im, pc_re, pc_im, n_chunks, inj_re=None,
                inj_im=None):
        calls.append((tuple(z_re.shape), n_chunks))
        return real(z_re, z_im, pc_re, pc_im, n_chunks, inj_re, inj_im)
    monkeypatch.setattr(ts, "chunk_scan", counted)
    z, inj = _scan_inputs(tt, decay)
    ref = js._chunk_start_states(
        jnp.asarray(z[0]), jnp.asarray(z[1]),
        None if decay else jnp.asarray(inj[0]),
        None if decay else jnp.asarray(inj[1]), jt)
    got = ts._chunk_start_states(
        torch.from_numpy(z[0]), torch.from_numpy(z[1]),
        None if decay else torch.from_numpy(inj[0]),
        None if decay else torch.from_numpy(inj[1]), tt)
    m = tbank.num_modes
    group = ((O, m), 2)
    passes = [((O * 2, m), 32)]
    want = ([group] if decay or layout == "shared"
            else passes + [group] + passes)
    assert calls == want
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert dberr(g.numpy(), np.asarray(r)) <= -120


# ------------------------------------------------ span vs the port itself


@pytest.mark.parametrize("backend", ["blocked", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_span_matches_port_block_steps(banks, layout, backend, dberr):
    _, tbank, lam64 = banks[layout]
    n_blocks = 8
    tt = ts.build_span_tables(lam64, n_blocks * S,
                              num_modes=tbank.num_modes, device="cpu")
    _, state = _seeded_state(banks[layout][0], n_blocks)
    _, gains = _gains(state)
    ref_state, ref_mix = tsolver.step_multi(state, tbank, gains,
                                            n_blocks=n_blocks, block_size=S,
                                            backend=backend)
    manual, mixes = state, []
    for _ in range(n_blocks):
        manual, _, mix, _ = tsolver.step_block(manual, tbank, gains,
                                               block_size=S, backend=backend)
        mixes.append(mix)
    assert torch.equal(ref_mix, torch.cat(mixes))
    assert torch.equal(ref_state.z_re, manual.z_re)
    st, mix = tsolver.step_span(state, tbank, tt, gains, n_blocks=n_blocks,
                                block_size=S)
    assert dberr(mix.numpy(), ref_mix.numpy()) <= -100
    assert dberr(st.z_re.numpy(), ref_state.z_re.numpy()) <= -100
    assert st.block_start == ref_state.block_start == n_blocks * S


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_spans_match_step_multi(banks, layout, dberr):
    """The state carried across a span boundary keeps the stream seamless."""
    _, tbank, lam64 = banks[layout]
    tt = ts.build_span_tables(lam64, 4 * S, num_modes=tbank.num_modes,
                              device="cpu")
    _, state = _seeded_state(banks[layout][0], 8)
    _, gains = _gains(state)
    st, first = tsolver.step_span(state, tbank, tt, gains, n_blocks=4,
                                  block_size=S)
    st, second = tsolver.step_span(st, tbank, tt, gains, n_blocks=4,
                                   block_size=S)
    ref_state, ref = tsolver.step_multi(state, tbank, gains, n_blocks=8,
                                        block_size=S, backend="blocked")
    assert dberr(torch.cat([first, second]).numpy(), ref.numpy()) <= -100
    assert dberr(st.z_im.numpy(), ref_state.z_im.numpy()) <= -100


# ----------------------------------------------------------------- session


def _script(sess):
    """Point, gaussian and hertz hits, two of them future-dated, then a
    ring-down: 10 blocks rendered 4 per dispatch (4 + 4 + 2)."""
    rng = np.random.default_rng(4)
    sess.set_listener(np.array([[0.8, 0.1, 0.4], [-0.5, 0.9, 0.2],
                                [0.3, -0.7, 1.1]]))
    sess.hit(0, rng.standard_normal(M), kind="point")
    sess.hit(1, rng.standard_normal(M), kind="gaussian", width_us=500.0,
             amp=0.7, when=S)
    sess.hit(2, rng.standard_normal(M), kind="hertz", width_us=2000.0,
             when=2 * S)
    sess.hit(0, rng.standard_normal(M), kind="gaussian", width_us=300.0,
             when=5 * S)


@pytest.fixture(scope="module")
def session_assets(banks):
    from openpbso_tpu.ops.ffat import build_ffat
    from openpbso_tpu.utils.synth import synth_fatcube
    from openpbso_tpu_torch.convert import ffat_from_numpy
    jbank, tbank, lam64 = banks["hetero"]
    maps = {i: synth_fatcube(i, 200.0 * (i + 1), n=6) for i in range(M)}
    jffat = build_ffat(maps, jbank.num_modes, dtype=jnp.float32)
    return (jbank, tbank, lam64, jffat,
            ffat_from_numpy(_np(jffat), device="cpu"))


def _t_session(session_assets, lam64=True, **cfg):
    _, tbank, lam, _, tffat = session_assets
    sess = TSession(tbank, tffat, TConfig(block_size=S, **cfg),
                    lam64=lam if lam64 else None)
    _script(sess)
    return sess


def test_render_multi_matches_jax_session_and_render(session_assets, dberr):
    jbank, _, lam64, jffat, _ = session_assets
    jsess = JSession(jbank, jffat, JConfig(block_size=S, backend="blocked"),
                     lam64=lam64)
    _script(jsess)
    ref = jsess.render_multi(10, blocks_per_dispatch=4)
    tsess = _t_session(session_assets, backend="blocked")
    got = tsess.render_multi(10, blocks_per_dispatch=4)
    assert got.shape == ref.shape == (10 * S, 2) and got.dtype == np.float32
    assert np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100
    assert tsess.sample_clock == jsess.sample_clock == 10 * S
    assert tsess._idle()
    per_block = _t_session(session_assets, backend="blocked").render(10)
    assert dberr(got, per_block) <= -100


def _count_calls(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(t_session_mod, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(t_session_mod, name, counted)
    return calls


@pytest.mark.parametrize("lam64", [True, False])
def test_render_multi_takes_the_span_with_lam64(session_assets, lam64,
                                                monkeypatch, dberr):
    """With lam64 every dispatch is a span (the last one idle, a ring-down
    span); without it render_multi steps block by block."""
    calls = _count_calls(monkeypatch,
                         ("step_span", "decay_span_step", "step_multi"))
    sess = _t_session(session_assets, lam64=lam64)
    assert sess.span_eligible() == lam64
    mix = sess.render_multi(10, blocks_per_dispatch=4)
    want = ({"step_span": 2, "decay_span_step": 1, "step_multi": 0} if lam64
            else {"step_span": 0, "decay_span_step": 0, "step_multi": 3})
    assert calls == want
    assert dberr(mix, _t_session(session_assets).render(10)) <= -100


def test_render_multi_over_the_force_budget_takes_step_multi(
        session_assets, monkeypatch, dberr):
    calls = _count_calls(monkeypatch,
                         ("step_span", "decay_span_step", "step_multi"))
    sess = _t_session(session_assets)
    sess.SPAN_FORCE_BUDGET = 0
    mix = sess.render_multi(10, blocks_per_dispatch=4)
    # busy dispatches fall back; the idle ring-down span needs no forces
    assert calls == {"step_span": 0, "decay_span_step": 1, "step_multi": 2}
    span = _t_session(session_assets).render_multi(10, blocks_per_dispatch=4)
    assert dberr(mix, span) <= -100


def test_session_builds_and_caches_span_tables(session_assets):
    """The device table is built once per chunk size: spans of 4 and 2
    blocks (both 64-sample chunks) share it; 16 blocks take a larger
    chunk."""
    _, tbank, lam64, _, _ = session_assets
    sess = _t_session(session_assets)
    tables = sess.span_tables_for(4)
    ref = ts.build_span_tables(lam64, 4 * S, num_modes=tbank.num_modes,
                               device="cpu")
    assert torch.equal(tables.b_re, ref.b_re)
    assert torch.equal(tables.b_im, ref.b_im)
    assert (tables.chunk, tables.n_chunks) == (ref.chunk, ref.n_chunks)
    assert tables.span == 4 * S and not tables.shared
    again, short = sess.span_tables_for(4), sess.span_tables_for(2)
    assert again.b_re is tables.b_re and short.b_re is tables.b_re
    assert (short.chunk, short.span) == (S, 2 * S)
    assert sess.span_tables_for(16).chunk == ts.choose_radix(16 * S) != S
    assert len(sess._span_cache) == 2
    assert _t_session(session_assets, lam64=False).span_tables_for(4) is None


def test_session_builds_span_planes_once_per_chunk(session_assets):
    """The session's cached tables carry their SpanPlanes, built once per
    chunk size: spans of 4 and 2 blocks share one build, 16 blocks take
    another; tables put in the cache without planes get them at their
    first use, once."""
    sess = _t_session(session_assets)
    before = ts.PLANE_BUILDS
    tables = sess.span_tables_for(4)
    assert ts.PLANE_BUILDS == before + 1
    want = ts.span_planes(tables.b_re, tables.b_im)
    for name in ("lo_re", "lo_im", "bt_re", "bt_im", "bt_lo_re",
                 "bt_lo_im"):
        assert torch.equal(getattr(tables.planes, name),
                           getattr(want, name)), name
    before = ts.PLANE_BUILDS
    assert sess.span_tables_for(2).planes is tables.planes
    assert sess.span_tables_for(4).planes is tables.planes
    assert ts.PLANE_BUILDS == before
    assert sess.span_tables_for(16).planes is not None
    assert ts.PLANE_BUILDS == before + 1
    chunk = tables.chunk
    sess._span_cache[chunk] = dataclasses.replace(tables, planes=None)
    again = sess.span_tables_for(4)
    assert again.planes is not None and ts.PLANE_BUILDS == before + 2
    assert sess.span_tables_for(4).planes is again.planes
    assert ts.PLANE_BUILDS == before + 2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_session_takes_flat_tables_where_jax_takes_superchunk(
        banks, layout, dberr):
    """A span of 64 chunks of 512 samples: the JAX session takes
    build_span_tables' default (superchunk G = 32 for a shared bank), the
    port's session the flat form (measured faster on the card), with the
    same baby table bitwise; both render the span and a ring-down within
    -100 dB. Superchunk tables put in the port session's cache are used
    as they are."""
    jbank, tbank, lam64 = banks[layout]
    nb = 512
    sessions = [TSession(tbank, config=TConfig(block_size=S), lam64=lam64),
                JSession(jbank, config=JConfig(block_size=S), lam64=lam64)]
    ours, theirs = (s.span_tables_for(nb) for s in sessions)
    assert (ours.chunk, ours.n_chunks, ours.superchunk) == (512, 64, 1)
    assert theirs.superchunk == (32 if layout == "shared" else 1)
    np.testing.assert_array_equal(ours.b_re.numpy(), np.asarray(theirs.b_re))
    rng = np.random.default_rng(6)
    for sess in sessions:
        sess.hit(1, rng.standard_normal(M), kind="gaussian", width_us=400.0)
        rng = np.random.default_rng(6)
    got, ref = (s.render_multi(2 * nb, blocks_per_dispatch=nb)
                for s in sessions)
    assert np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100
    if layout == "shared":
        sess = TSession(tbank, config=TConfig(block_size=S), lam64=lam64)
        sess._span_cache[512] = ts.build_span_tables(
            lam64, nb * S, radix=512, num_modes=tbank.num_modes,
            device="cpu")
        assert sess.span_tables_for(nb).superchunk == 32


def test_session_accepts_lam64(banks):
    _, tbank, lam64 = banks["shared"]
    sess = TSession(tbank, config=TConfig(block_size=S), lam64=lam64)  # [M]
    assert sess.span_eligible() and sess._lam64.shape == (1, M)
    assert sess.span_tables_for(2).shared
    sound = sess._step_span_sound(2)
    assert sound.shape == (O, 2 * S) and sess.sample_clock == 2 * S
