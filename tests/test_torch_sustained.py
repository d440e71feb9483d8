"""Port parity: the sustained AR(2) channel (openpbso_tpu_torch), per block
and per span, from the threefry noise up to the session.

The same numpy inputs, made from a seed, go through the JAX package and the
port. Tolerances, each against the JAX package on the CPU:

- keys, fold_in and random bits: bitwise (the threefry twin, ops/threefry.py);
- normals: <= -120 dB (JAX's erfinv against torch.special.erfinv: they
  differ in the last bits of the tails);
- ar_impulse_g: bitwise (the same float64 numpy code);
- everything else (sustained_block, sustained_span, step_block, step_span,
  the session): <= -100 dB, the bar of the port's other parity tests (the
  normals' last bits and float32 sums taken in another order);
- the port's own per-block render against its span render: <= -60 dB, the
  JAX package's span-vs-block contract for drags
  (tests/test_span_sustained.py).

On the CPU the kernel wrappers (ar_noise, ar_block, toeplitz_conv,
chunk_scan) run their plain twins; tests/test_torch_gpu.py and
chip_smoke.py hold the CUDA kernels against those twins on a GPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.config import REBASE_PERIOD
from openpbso_tpu.ops import forces as jf
from openpbso_tpu.ops.coeffs import bank_from_material, lambda_from_modes
from openpbso_tpu.ops.span import build_span_tables as j_tables
from openpbso_tpu.runtime import solver as jsolver
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.runtime.state import make_solver_state as j_make_state
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy, state_from_numpy
from openpbso_tpu_torch.ops import ar_block as kb
from openpbso_tpu_torch.ops import ar_noise as ka
from openpbso_tpu_torch.ops import forces as tf
from openpbso_tpu_torch.ops import threefry
from openpbso_tpu_torch.ops.span import build_span_tables as t_tables
from openpbso_tpu_torch.runtime import session as t_session_mod
from openpbso_tpu_torch.runtime import solver as tsolver
from openpbso_tpu_torch.runtime.session import ModalSession as TSession
from openpbso_tpu_torch.runtime.solver import SolverConfig as TConfig

O, M, S = 4, 10, 64
PAST_REBASE = REBASE_PERIOD - 2 * S     # spans from here cross the modulo


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


# ------------------------------------------------------------- threefry


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_keys_fold_in_and_bits_bitwise_equal_jax(seed):
    jkeys = np.asarray(jf.make_sustained_state(O, M, seed=seed).key)
    tkeys = tf.make_sustained_state(O, M, seed=seed).key
    assert tkeys.dtype == torch.int64
    np.testing.assert_array_equal(tkeys.numpy(), jkeys.astype(np.int64))
    for o in range(O):
        jkey = jax.random.wrap_key_data(jnp.asarray(jkeys[o]))
        for b in (0, 7, REBASE_PERIOD // S - 1):
            want = np.asarray(jax.random.key_data(
                jax.random.fold_in(jkey, b))).astype(np.int64)
            got = threefry.fold_in(tkeys[o, 0], tkeys[o, 1], torch.tensor(b))
            np.testing.assert_array_equal(torch.stack(got).numpy(), want)
        want = np.asarray(jax.random.bits(jkey, (S,), jnp.uint32)).astype(
            np.int64)
        x0, x1 = threefry.threefry2x32(tkeys[o, 0], tkeys[o, 1], 0,
                                       torch.arange(S))
        np.testing.assert_array_equal((x0 ^ x1).numpy(), want)


@pytest.mark.parametrize("block_start,n_blocks", [
    (0, 3), (5 * S, 1), (PAST_REBASE, 4)])
def test_noise_matches_jax(block_start, n_blocks, dberr):
    """The span's noise [O, X, S], across the rebase modulo too."""
    jkeys = jf.make_sustained_state(O, M, seed=3).key
    ref = np.asarray(jf._noise_for_blocks(jkeys, jnp.asarray(block_start),
                                          n_blocks, S, jnp.float32))
    got = ka.ar_noise(torch.as_tensor(np.asarray(jkeys).astype(np.int64)),
                      block_start, n_blocks, S)
    assert got.shape == (O, n_blocks, S) and got.dtype == torch.float32
    assert dberr(got.numpy(), ref) <= -120
    assert ka.LAUNCHES == 0


def test_block_counter_wraps_at_the_rebase_period():
    period = REBASE_PERIOD // S
    assert ka.block_counter(0, S) == (0, period)
    assert ka.block_counter(REBASE_PERIOD + 3 * S, S) == (3, period)
    assert ka.block_counter(10 * 3, 3) == (10, 0)   # 3 does not divide it
    with pytest.raises(ValueError, match="< 0"):
        ka.block_counter(-S, S)


# ---------------------------------------------------------- host helpers


@pytest.mark.parametrize("a", [
    (0.783, 0.116), (1.2, -0.5), (1.0, -0.25),       # complex, double root
    (1.0, -0.25 + 1e-18), (0.3, 0.1)])
def test_ar_impulse_g_bitwise_equal_jax(a):
    for rows in ([a], [a, (0.783, 0.116)]):
        np.testing.assert_array_equal(tf.ar_impulse_g(np.asarray(rows), 300),
                                      jf.ar_impulse_g(np.asarray(rows), 300))


@pytest.mark.parametrize("a", [
    (0.783, 0.116), (1.5, 0.2), (0.0, -1.0), (1.0, -0.25), (np.nan, 0.1),
    (0.5, np.inf)])
def test_ar_stability_radius_matches_jax(a):
    got, want = tf.ar_stability_radius(a), jf.ar_stability_radius(a)
    assert got == want
    if not np.all(np.isfinite(a)):
        assert got == float("inf")


def test_span_group_matches_jax():
    for n in (1, 6, 16, 512, 97):
        for cap in (1, 4, 32, 512):
            assert tf.span_group(n, cap) == jf.span_group(n, cap)


# ------------------------------------------------------- channel by channel


def _channel(seed=5):
    """A JAX channel and its port copy: three of four objects active, a
    ringing history and one object with its own tuning."""
    rng = np.random.default_rng(seed)
    js = jf.make_sustained_state(O, M, seed=seed)
    a = np.tile([[0.783, 0.116]], (O, 1))
    a[2] = (0.9, 0.05)
    js = dataclasses.replace(
        js, active=jnp.asarray([True, False, True, True]),
        space=jnp.asarray(rng.standard_normal((O, M)), jnp.float32),
        ar_hist=jnp.asarray(rng.standard_normal((O, 2)) * 0.01, jnp.float32),
        a=jnp.asarray(a, jnp.float32),
        sigma=jnp.asarray(rng.uniform(0.001, 0.003, O), jnp.float32))
    return js, a


def _port(js) -> tf.SustainedState:
    st = _np(js)
    fields = [f.name for f in dataclasses.fields(tf.SustainedState)]
    return tf.SustainedState(**{
        n: torch.as_tensor(np.array(getattr(st, n)).astype(
            np.int64 if n == "key" else getattr(st, n).dtype))
        for n in fields})


@pytest.mark.parametrize("block_start", [0, 3 * S, REBASE_PERIOD + 2 * S])
def test_sustained_block_matches_jax(block_start, dberr):
    js, _ = _channel()
    j_new, j_prof, j_space = jf.sustained_block(js, S, block_start)
    t_new, t_prof, t_space = tf.sustained_block(_port(js), S, block_start)
    assert t_prof.shape == (O, S)
    assert (t_prof[1] == 0).all() and (t_space[1] == 0).all()
    assert dberr(t_prof.numpy(), np.asarray(j_prof)) <= -100
    assert dberr(t_new.ar_hist.numpy(), np.asarray(j_new.ar_hist)) <= -100
    np.testing.assert_array_equal(t_new.ar_hist[1].numpy(),
                                  np.asarray(js.ar_hist)[1])
    np.testing.assert_array_equal(t_space.numpy(), np.asarray(j_space))
    assert kb.LAUNCHES == 0


def test_ar_block_twin_takes_given_noise():
    """The twin with the noise it would draw itself is the same loop."""
    st = _port(_channel()[0])
    args = (st.key, st.a, st.ar_hist, st.sigma, st.mu, st.active)
    noise = ka.ar_noise(st.key, 7 * S, 1, S)[:, 0]
    own = kb.ar_block(*args, 7 * S, S)
    given = kb.ar_block_reference(*args, 7, S, noise=noise)
    for a, b in zip(own, given):
        assert torch.equal(a, b)


@pytest.mark.parametrize("table,n_blocks,block_start", [
    ("shared", 8, 0),            # the table covers the span: scan-free
    ("shared", 8, PAST_REBASE),  # across the rebase modulo
    ("shared-grouped", 8, 0),    # grp 2 < X: a 4-step group scan
    ("per-object", 6, 0),        # grp 1: the full X-step scan
    ("per-object-grouped", 8, PAST_REBASE),
])
def test_sustained_span_matches_jax(table, n_blocks, block_start, dberr):
    js, a = _channel()
    if table.startswith("shared"):
        js = dataclasses.replace(js, a=jnp.tile(
            jnp.asarray([[0.783, 0.116]], jnp.float32), (O, 1)))
        a = np.asarray([[0.783, 0.116]])
    length = {"shared": n_blocks * S, "shared-grouped": 2 * S,
              "per-object": S, "per-object-grouped": 4 * S}[table]
    g = jf.ar_impulse_g(a, length)
    assert g.shape[0] == (1 if table.startswith("shared") else O)
    j_new, j_prof, _ = jf.sustained_span(js, jnp.asarray(g, jnp.float32),
                                         n_blocks, S, block_start)
    t_new, t_prof, t_space = tf.sustained_span(
        _port(js), torch.as_tensor(g).float(), n_blocks, S, block_start)
    assert t_prof.shape == (O, n_blocks * S)
    assert (t_prof[1] == 0).all() and (t_space[1] == 0).all()
    assert dberr(t_prof.numpy(), np.asarray(j_prof)) <= -100
    assert dberr(t_new.ar_hist.numpy(), np.asarray(j_new.ar_hist)) <= -100


def test_sustained_span_is_the_block_sequence(dberr):
    """Block by block and over one span the port draws the same noise; the
    profiles agree to float32 rounding of the factored recurrence."""
    js, a = _channel()
    st = _port(js)
    g = torch.as_tensor(tf.ar_impulse_g(a, 5 * S)).float()
    _, span, _ = tf.sustained_span(st, g, 5, S, 2 * S)
    blocks = []
    for i in range(5):
        st, prof, _ = tf.sustained_block(st, S, (2 + i) * S)
        blocks.append(prof)
    assert dberr(span.numpy(), torch.cat(blocks, dim=1).numpy()) <= -100


# --------------------------------------------------------------- solver


@pytest.fixture(scope="module")
def scene():
    """A shared bank and a state with drags on objects 0 and 2 and gaussian
    slots on objects 0 and 1 (object 0 both drags and has a slot), as in
    tests/test_span_sustained.py."""
    md = synth_mode_data(M, 8, seed=11)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    jbank = bank_from_material(CERAMIC.density, md.omega_squared,
                               CERAMIC.alpha, CERAMIC.beta, num_objects=O,
                               block_size=S, dtype=jnp.float32)
    m = jbank.num_modes
    rng = np.random.default_rng(3)
    st = j_make_state(O, m, num_slots=4, seed=3)
    slots = st.slots
    slots = dataclasses.replace(
        slots, ftype=slots.ftype.at[0, 0].set(2).at[1, 0].set(2),
        width=slots.width.at[:, 0].set(9.0),
        space=slots.space.at[:2, 0, :].set(
            jnp.asarray(rng.standard_normal((2, m)), jnp.float32)))
    sus = st.sustained
    sus = dataclasses.replace(
        sus, active=sus.active.at[0].set(True).at[2].set(True),
        space=sus.space.at[0, :4].set(
            jnp.asarray(rng.standard_normal(4), jnp.float32))
        .at[2, :4].set(jnp.asarray(rng.standard_normal(4), jnp.float32)))
    st = dataclasses.replace(st, slots=slots, sustained=sus, transfer=(
        jnp.asarray(rng.uniform(0.5, 2.0, (O, m)), jnp.float32)))
    return jbank, bank_from_numpy(_np(jbank)), lam64, st


def test_state_from_numpy_carries_an_active_channel(scene):
    _, _, _, jst = scene
    tst = state_from_numpy(_np(jst))
    for f in dataclasses.fields(tf.SustainedState):
        want = np.asarray(getattr(jst.sustained, f.name))
        got = getattr(tst.sustained, f.name).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    assert tst.sustained.active.tolist() == [True, False, True, False]


@pytest.mark.parametrize("backend", ["blocked", "fused"])
def test_step_block_with_sustained_matches_jax(scene, backend, dberr):
    jbank, tbank, _, jst = scene
    tst = state_from_numpy(_np(jst))
    gains = np.ones((O, 2), np.float32)
    for _ in range(3):
        jst, _, j_mix, _ = jsolver.step_block(jst, jbank, jnp.asarray(gains),
                                              block_size=S, backend="blocked",
                                              with_sustained=True)
        tst, _, t_mix, _ = tsolver.step_block(tst, tbank,
                                              torch.from_numpy(gains),
                                              block_size=S, backend=backend,
                                              with_sustained=True)
        assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100
    assert dberr(tst.z_im.numpy(), np.asarray(jst.z_im)) <= -100
    assert dberr(tst.sustained.ar_hist.numpy(),
                 np.asarray(jst.sustained.ar_hist)) <= -100


@pytest.mark.parametrize("num_slots", [None, 1, 0])
@pytest.mark.parametrize("per_object", [False, True])
def test_step_span_with_sustained_matches_jax(scene, num_slots, per_object,
                                              dberr):
    jbank, tbank, lam64, jst = scene
    n_blocks = 4
    a = np.tile([[0.783, 0.116]], (O if per_object else 1, 1))
    if per_object:
        a[2] = (0.9, 0.05)
        jst = dataclasses.replace(jst, sustained=dataclasses.replace(
            jst.sustained, a=jnp.asarray(a, jnp.float32)))
    g = jf.ar_impulse_g(a, n_blocks * S)
    gains = np.random.default_rng(5).uniform(0.5, 1.5, (O, 2)).astype(
        np.float32)
    j_st, j_mix = jsolver.step_span(
        jst, jbank, j_tables(lam64, n_blocks * S, num_modes=jbank.num_modes),
        jnp.asarray(gains), n_blocks=n_blocks, block_size=S,
        num_slots=num_slots, with_sustained=True,
        ar_g=jnp.asarray(g, jnp.float32))
    t_st, t_mix = tsolver.step_span(
        state_from_numpy(_np(jst)), tbank,
        t_tables(lam64, n_blocks * S, num_modes=tbank.num_modes),
        torch.from_numpy(gains), n_blocks=n_blocks, block_size=S,
        num_slots=num_slots, with_sustained=True,
        ar_g=torch.as_tensor(g).float())
    assert dberr(t_mix.numpy(), np.asarray(j_mix)) <= -100
    assert dberr(t_st.z_re.numpy(), np.asarray(j_st.z_re)) <= -100
    assert dberr(t_st.sustained.ar_hist.numpy(),
                 np.asarray(j_st.sustained.ar_hist)) <= -100
    assert t_st.block_start == n_blocks * S


def test_span_gates_the_slots_of_a_dragged_object(scene):
    """Replace semantics (modal_solver.h:195-204): object 0's slot is gated
    off while it drags, so dropping the slot changes nothing."""
    _, tbank, lam64, jst = scene
    tst = state_from_numpy(_np(jst))
    tables = t_tables(lam64, 4 * S, num_modes=tbank.num_modes)
    g = torch.as_tensor(tf.ar_impulse_g((0.783, 0.116), 4 * S)).float()
    gains = torch.ones((O, 2))
    _, mix = tsolver.step_span(tst, tbank, tables, gains, n_blocks=4,
                               block_size=S, with_sustained=True, ar_g=g)
    tst.slots.ftype[0, 0] = 0
    _, mix2 = tsolver.step_span(tst, tbank, tables, gains, n_blocks=4,
                                block_size=S, with_sustained=True, ar_g=g)
    assert torch.equal(mix, mix2)
    with pytest.raises(ValueError, match="ar_g"):
        tsolver.step_span(tst, tbank, tables, gains, n_blocks=4,
                          block_size=S, with_sustained=True)


# -------------------------------------------------------------- session


def _drag_script(sess, multi=False):
    """A hit, two drags (one direction update, one sigma/mu retune), the
    drags ending, and a ring-down: 16 blocks, by render or (``multi``) by
    render_multi, 4 blocks per dispatch."""
    rng = np.random.default_rng(9)
    vecs = [rng.standard_normal(M) for _ in range(4)]

    def render(n):
        return (sess.render_multi(n, blocks_per_dispatch=4) if multi
                else sess.render(n))
    out = []
    sess.hit(1, vecs[0], kind="gaussian", width_us=500.0)
    sess.sustained_start(0, vecs[1])
    sess.sustained_start(2, vecs[2])
    out.append(render(3))               # drags with a live hit
    sess.sustained_update(0, vecs[3])
    sess.set_ar_params(2, sigma=0.004, mu=0.1)
    out.append(render(5))               # drags alone: the drag-only bucket
    sess.sustained_end(2)
    out.append(render(2))
    sess.clear_forces(0)                # ends the last drag
    out.append(render(6))               # ring-down
    return np.concatenate(out)


@pytest.fixture(scope="module")
def sessions(scene):
    jbank, tbank, lam64, _ = scene

    def make(pkg, lam=True):
        cls, cfg = ((JSession, JConfig) if pkg == "jax"
                    else (TSession, TConfig))
        return cls(jbank if pkg == "jax" else tbank,
                   config=cfg(block_size=S, backend="blocked"), seed=4,
                   lam64=lam64 if lam else None)
    return make


@pytest.mark.parametrize("path", ["render", "render_multi", "over_budget"])
def test_session_drag_script_matches_jax(sessions, path, dberr):
    """Per block, by span, and by span dispatches over the force budget
    (their busy dispatches fall back to step_multi with the channel)."""
    jsess, tsess = sessions("jax"), sessions("torch")
    if path == "over_budget":
        jsess.SPAN_FORCE_BUDGET = tsess.SPAN_FORCE_BUDGET = 0
    ref = _drag_script(jsess, path != "render")
    got = _drag_script(tsess, path != "render")
    assert got.shape == ref.shape == (16 * S, 2)
    assert np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100
    assert tsess._idle() and jsess._idle()
    assert not tsess._sus_active.any()
    assert dberr(tsess.state.sustained.ar_hist.numpy(),
                 np.asarray(jsess.state.sustained.ar_hist)) <= -100


def test_step_span_sound_with_a_drag_matches_jax(sessions, dberr):
    """The raw per-object sound of a span dispatch, drag and hit live."""
    jsess, tsess = sessions("jax"), sessions("torch")
    rng = np.random.default_rng(12)
    vecs = [rng.standard_normal(M) for _ in range(2)]
    for sess in (jsess, tsess):
        sess.sustained_start(2, vecs[0])
        sess.hit(0, vecs[1], kind="hertz", width_us=2000.0)
    ref = np.asarray(jsess._step_span_sound(4))
    got = tsess._step_span_sound(4)
    assert got.shape == ref.shape == (O, 4 * S)
    assert dberr(got.numpy(), ref) <= -100
    assert tsess.sample_clock == jsess.sample_clock == 4 * S


def test_session_render_matches_render_multi(sessions, dberr):
    """The port's own contract between its two paths, as the JAX
    package's (tests/test_span_sustained.py)."""
    per_block = _drag_script(sessions("torch"))
    span = _drag_script(sessions("torch"), multi=True)
    assert dberr(span, per_block) <= -60


def test_session_gating_follows_jax(sessions):
    jsess, tsess = sessions("jax"), sessions("torch")
    rng = np.random.default_rng(2)
    space = rng.standard_normal(M)
    for sess in (jsess, tsess):
        sess.hit(1, space)
        sess.sustained_start(3, space)
    for _ in range(3):
        for attr in ("_idle", "_with_sustained", "span_eligible"):
            assert getattr(tsess, attr)() == getattr(jsess, attr)(), attr
        assert tsess._slot_bucket() == jsess._slot_bucket() is None
        for ws in (False, True):
            assert tsess._span_bucket(ws) == jsess._span_bucket(ws)
        jsess.step()
        tsess.step()
    assert tsess._span_bucket(True) == jsess._span_bucket(True) == 0
    for sess in (jsess, tsess):
        sess.clear_forces(3)
    assert tsess._idle() and jsess._idle()
    assert not tsess.state.sustained.active.any()
    assert not np.asarray(jsess.state.sustained.active).any()


@pytest.mark.parametrize("a", [(1.5, 0.2), (0.0, -1.0), (np.nan, 0.1)])
def test_unstable_tuning_is_rejected_before_any_change(sessions, a):
    tsess = sessions("torch")
    tsess.sustained_start(0, np.ones(M))
    tsess.render(1)
    sus = tsess.state.sustained
    before = {f.name: getattr(sus, f.name).clone()
              for f in dataclasses.fields(sus)}
    host = tsess._ar_host.copy()
    with pytest.raises(ValueError, match="unstable"):
        tsess.set_ar_params(0, a=a)
    with pytest.raises(ValueError, match="unstable"):
        sessions("jax").set_ar_params(0, a=a)
    for name, t in before.items():
        assert torch.equal(getattr(tsess.state.sustained, name), t), name
    np.testing.assert_array_equal(tsess._ar_host, host)


def test_retune_keeps_or_rebuilds_the_ar_table(sessions):
    jsess, tsess = sessions("jax"), sessions("torch")
    tbl = tsess.ar_span_table(8)
    np.testing.assert_array_equal(tbl.numpy(),
                                  np.asarray(jsess.ar_span_table(8)))
    assert tbl.shape == (1, 8 * S + 1)
    tsess.set_ar_params(1, sigma=0.002, mu=0.2)    # sigma/mu only
    assert tsess.ar_span_table(8) is tbl
    assert tsess.state.sustained.sigma[1] == np.float32(0.002)
    for sess in (jsess, tsess):
        sess.set_ar_params(1, a=(0.9, 0.05))
    per_object = tsess.ar_span_table(8)
    assert per_object.shape == (O, 8 * S + 1)       # grp 8 under the cap 32
    np.testing.assert_array_equal(per_object.numpy(),
                                  np.asarray(jsess.ar_span_table(8)))
    assert tsess.ar_span_table(64).shape == (O, 32 * S + 1)


def test_retuned_drag_with_a_hit_steps_per_block(sessions, monkeypatch,
                                                 dberr):
    """A per-object AR table meeting a live impact slot leaves the span
    (the JAX session's carve-out): render_multi steps block by block."""
    calls = {"step_span": 0, "step_multi": 0}
    for name in calls:
        fn = getattr(t_session_mod, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(t_session_mod, name, counted)
    jsess, tsess = sessions("jax"), sessions("torch")
    rng = np.random.default_rng(6)
    vecs = [rng.standard_normal(M) for _ in range(2)]
    for sess in (jsess, tsess):
        sess.set_ar_params(2, a=(0.9, 0.05), sigma=0.002)
        sess.sustained_start(2, vecs[0])
        sess.hit(1, vecs[1], kind="gaussian", width_us=400.0)
    assert not tsess.span_eligible() and not jsess.span_eligible()
    got = tsess.render_multi(6, blocks_per_dispatch=3)
    assert calls == {"step_span": 0, "step_multi": 2}
    assert dberr(got, jsess.render_multi(6, blocks_per_dispatch=3)) <= -100
    # the hit has expired: the retuned drag rides the span again
    assert tsess.span_eligible() and jsess.span_eligible()
    got = tsess.render_multi(4, blocks_per_dispatch=4)
    assert calls["step_span"] == 1
    assert dberr(got, jsess.render_multi(4, blocks_per_dispatch=4)) <= -100


def test_kernel_wrappers_refuse_other_devices_and_shapes():
    key = torch.zeros((2, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no ar_noise kernel"):
        ka.ar_noise(key, 0, 1, S)
    f = torch.zeros((2, 2), device="meta")
    r = torch.zeros((2,), device="meta")
    with pytest.raises(ValueError, match="no ar_block kernel"):
        kb.ar_block(key, f, f, r, r, r.bool(), 0, S)
    with pytest.raises(ValueError, match=r"\[O, 2\]"):
        ka.ar_noise(torch.zeros((2, 3), dtype=torch.int64), 0, 1, S)
    with pytest.raises(ValueError, match="shape mismatch"):
        kb.ar_block(torch.zeros((2, 2), dtype=torch.int64),
                    torch.zeros((2, 2)), torch.zeros((2, 2)), torch.zeros(2),
                    torch.zeros(1), torch.zeros(2, dtype=torch.bool), 0, S)
