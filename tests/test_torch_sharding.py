"""Port parity: the sharded steps (openpbso_tpu_torch.parallel.sharding)
against the JAX package's shard_map steps on the 8-device CPU mesh.

The JAX side runs as tests/test_sharding.py runs it (a make_mesh of 8
virtual CPU devices); the port's mesh names "cpu" for each of its cells.
Both start from the same numpy inputs (the JAX bank and state carried
across by convert.py) and are held to <= -100 dB. Each port step makes
the reductions its docstring states: two per block, one per span. The
port's sharded spans through its own flat tables are also held against the
JAX package's unsharded span, which takes its two-level superchunk scan on
long shared spans.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops.coeffs import bank_from_material as j_bank_from
from openpbso_tpu.ops.coeffs import build_modal_bank, lambda_from_modes
from openpbso_tpu.ops.forces import ar_impulse_g
from openpbso_tpu.ops.span import build_span_tables
from openpbso_tpu.parallel import sharding as jsh
from openpbso_tpu.runtime import solver as jsolver
from openpbso_tpu.runtime.state import make_solver_state as j_make_state
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import (bank_from_numpy,
                                        span_tables_from_numpy,
                                        state_from_numpy)
from openpbso_tpu_torch.parallel import sharding as tsh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

S, O = 128, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _meshes(shape):
    return jsh.make_mesh(*shape), tsh.make_mesh(*shape, devices=["cpu"] * 8)


def _setup(hetero=False, transfer_im=False, sustained=False):
    """(JAX bank, JAX state, gains) with one hit in slot 0 of every object
    (test_sharding._setup), optionally a hetero bank, complex rows and an
    active AR channel on objects 2 and 5."""
    rng = np.random.default_rng(0)
    if hetero:
        parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
            16, 4, seed=50 + i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
            for i in range(O)]
        lam, b, v = (np.stack(x) for x in zip(*parts))
        bank = build_modal_bank(lam, b, v, block_size=S, shared=False,
                                dtype=jnp.float32)
    else:
        md = synth_mode_data(24, 6, seed=9)
        bank = j_bank_from(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                           CERAMIC.beta, num_objects=O, block_size=S,
                           dtype=jnp.float32)
    m = bank.num_modes
    state = j_make_state(O, m, num_slots=4, dtype=jnp.float32)
    space = rng.standard_normal((O, m))
    slots = dataclasses.replace(
        state.slots, ftype=state.slots.ftype.at[:, 0].set(1),
        space=state.slots.space.at[:, 0, :].set(jnp.asarray(space,
                                                            jnp.float32)))
    state = dataclasses.replace(state, slots=slots)
    if transfer_im:
        state = dataclasses.replace(
            state,
            transfer=jnp.asarray(rng.uniform(0.5, 1.5, (O, m)), jnp.float32),
            transfer_im=jnp.asarray(rng.uniform(-0.5, 0.5, (O, m)),
                                    jnp.float32))
    if sustained:
        sus = state.sustained
        state = dataclasses.replace(state, sustained=dataclasses.replace(
            sus, active=sus.active.at[jnp.asarray([2, 5])].set(True),
            space=sus.space.at[jnp.asarray([2, 5])].set(
                jnp.asarray(rng.standard_normal((2, m)), jnp.float32))))
    gains = jnp.asarray(rng.uniform(0.5, 1.5, (O, 2)), jnp.float32)
    return bank, state, gains


def _port(bank, state, gains, tmesh):
    tbank = bank_from_numpy(_np(bank), device="cpu")
    return (tsh.shard_bank(tmesh, tbank),
            tsh.shard_state(tmesh, state_from_numpy(_np(state),
                                                    device="cpu")),
            torch.as_tensor(np.asarray(gains)))


def _gathered(tmesh, shards):
    return tsh.gather_state(tmesh, shards)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_step_matches_jax(mesh_shape, dberr):
    bank, state, gains = _setup()
    jmesh, tmesh = _meshes(mesh_shape)
    jstep = jsh.make_sharded_step(jmesh, bank, block_size=S)
    jst, jsound, jmix, _ = jstep(jsh.shard_state(jmesh, state),
                                 jsh.shard_bank(jmesh, bank), gains)
    tbank, tstate, tgains = _port(bank, state, gains, tmesh)
    tstep = tsh.make_sharded_step(tmesh, block_size=S)
    tsh.REDUCTIONS = 0
    tst, tsound, tmix, _ = tstep(tstate, tbank, tgains)
    assert tsh.REDUCTIONS == 2          # the sound over 'mode', the mix
    assert dberr(tsound.numpy(), np.asarray(jsound)) <= -100
    assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100
    got = _gathered(tmesh, tst)
    assert dberr(got.z_im.numpy(), np.asarray(jst.z_im)) <= -100
    assert got.block_start == S
    assert all(c.block_start == S for row in tst for c in row)


def test_sharded_multi_block_continuity(dberr):
    """State threads across blocks: four sharded steps against the JAX
    package's, and make_sharded_multi against the same four."""
    bank, state, gains = _setup()
    jmesh, tmesh = _meshes((4, 2))
    jstep = jsh.make_sharded_step(jmesh, bank, block_size=S)
    jst, jbk = jsh.shard_state(jmesh, state), jsh.shard_bank(jmesh, bank)
    tbank, tstate, tgains = _port(bank, state, gains, tmesh)
    tstep = tsh.make_sharded_step(tmesh, block_size=S)
    tmulti = tsh.make_sharded_multi(tmesh, n_blocks=4, block_size=S)
    jm, tm = [], []
    st = tstate
    for _ in range(4):
        jst, _, mix, _ = jstep(jst, jbk, gains)
        jm.append(np.asarray(mix))
        st, _, mix, _ = tstep(st, tbank, tgains)
        tm.append(mix.numpy())
    assert dberr(np.concatenate(tm), np.concatenate(jm)) <= -100
    st2, mix = tmulti(tstate, tbank, tgains)    # the steps wrote nothing
    assert np.array_equal(mix.numpy(), np.concatenate(tm))
    assert dberr(_gathered(tmesh, st2).z_re.numpy(),
                 np.asarray(jst.z_re)) <= -100


def test_sharded_hetero_bank(dberr):
    """Per-object lam tables split over the obj axis as well."""
    bank, state, gains = _setup(hetero=True)
    assert not bank.shared_tables
    jmesh, tmesh = _meshes((4, 2))
    jout = jsh.make_sharded_step(jmesh, bank, block_size=S)(
        jsh.shard_state(jmesh, state), jsh.shard_bank(jmesh, bank), gains)
    tbank, tstate, tgains = _port(bank, state, gains, tmesh)
    assert tbank[1][1].pow_re.shape == (O // 4, bank.num_modes // 2, S + 1)
    tout = tsh.make_sharded_step(tmesh, block_size=S)(
        tstate, tbank, tgains)
    assert dberr(tout[2].numpy(), np.asarray(jout[2])) <= -100


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_sharded_decay_step_matches_jax(mesh_shape, dberr):
    from openpbso_tpu.runtime.solver import step_block
    bank, state, gains = _setup()
    # ring the oscillators with one block, then clear the slots: the
    # scene is idle (the decay step's contract)
    state, _, _, _ = step_block(state, bank, gains, block_size=S,
                                backend="blocked")
    state = dataclasses.replace(state, slots=dataclasses.replace(
        state.slots, ftype=state.slots.ftype.at[:].set(0)))
    jmesh, tmesh = _meshes(mesh_shape)
    jst, jsound, jmix, jq = jsh.make_sharded_decay_step(
        jmesh, bank, block_size=S, compute_qnorm=True)(
        jsh.shard_state(jmesh, state), jsh.shard_bank(jmesh, bank), gains)
    tbank, tstate, tgains = _port(bank, state, gains, tmesh)
    tsh.REDUCTIONS = 0
    tst, tsound, tmix, tq = tsh.make_sharded_decay_step(
        tmesh, block_size=S, compute_qnorm=True)(tstate, tbank, tgains)
    assert tsh.REDUCTIONS == 2
    assert dberr(tsound.numpy(), np.asarray(jsound)) <= -100
    assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100
    assert dberr(tq.numpy(), np.asarray(jq)) <= -100
    assert dberr(_gathered(tmesh, tst).z_re.numpy(),
                 np.asarray(jst.z_re)) <= -100


@pytest.mark.parametrize("complex_rows", [False, True])
def test_sharded_xfade_step_matches_jax(complex_rows, dberr):
    bank, state, gains = _setup(transfer_im=complex_rows)
    rng = np.random.default_rng(5)
    m = bank.num_modes
    prev = jnp.asarray(rng.uniform(0.5, 1.5, (O, m)), jnp.float32)
    prev_im = (jnp.asarray(rng.uniform(-0.5, 0.5, (O, m)), jnp.float32)
               if complex_rows else None)
    jmesh, tmesh = _meshes((4, 2))
    jstep = jsh.make_sharded_xfade_step(jmesh, bank, block_size=S,
                                        complex_rows=complex_rows)
    spec = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(
        "obj", "mode"))
    jargs = (jax.device_put(prev, spec),) + (
        (jax.device_put(prev_im, spec),) if complex_rows else ())
    _, jsound, jmix, _ = jstep(jsh.shard_state(jmesh, state),
                               jsh.shard_bank(jmesh, bank), gains, *jargs)
    tbank, tstate, tgains = _port(bank, state, gains, tmesh)
    tstep = tsh.make_sharded_xfade_step(tmesh, block_size=S)
    _, tsound, tmix, _ = tstep(
        tstate, tbank, tgains, torch.as_tensor(np.asarray(prev)),
        None if prev_im is None else torch.as_tensor(np.asarray(prev_im)))
    assert dberr(tsound.numpy(), np.asarray(jsound)) <= -100
    assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100


def _span_inputs(bank, nb, sustained):
    md = synth_mode_data(24, 6, seed=9)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    jtables = build_span_tables(lam64, nb * S, num_modes=bank.num_modes)
    ar = (jnp.asarray(ar_impulse_g(np.asarray([[0.783, 0.116]]), nb * S),
                      jnp.float32) if sustained else None)
    return jtables, ar


@pytest.mark.parametrize("case", ["impact", "sustained", "complex",
                                  "decay"])
def test_sharded_span_matches_jax(case, dberr):
    """One span dispatch against the JAX package's, with exactly one
    reduction (of the [N, C] mix) in every case."""
    nb = 4
    bank, state, gains = _setup(transfer_im=case == "complex",
                                sustained=case == "sustained")
    jtables, ar = _span_inputs(bank, nb, case == "sustained")
    kw = dict(n_blocks=nb, block_size=S, decay=case == "decay",
              with_sustained=case == "sustained")
    jmesh, tmesh = _meshes((4, 2))
    jargs = [jsh.shard_state(jmesh, state), jsh.shard_bank(jmesh, bank),
             jsh.shard_span_tables(jmesh, jtables), gains]
    tbank, tstate, tgains = _port(bank, state, gains, tmesh)
    ttables = tsh.shard_span_tables(
        tmesh, span_tables_from_numpy(_np(jtables), device="cpu"))
    targs = [tstate, tbank, ttables, tgains]
    if ar is not None:
        jargs.append(ar)
        targs.append(torch.as_tensor(np.asarray(ar)))
    jst, jmix = jsh.make_sharded_span(jmesh, bank, jtables,
                                      complex_rows=case == "complex",
                                      **kw)(*jargs)
    tsh.REDUCTIONS = 0
    tst, tmix = tsh.make_sharded_span(tmesh, **kw)(*targs)
    assert tsh.REDUCTIONS == 1
    assert tmix.shape == (nb * S, 2)
    assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100
    got = _gathered(tmesh, tst)
    assert dberr(got.z_re.numpy(), np.asarray(jst.z_re)) <= -100
    assert got.block_start == nb * S
    if case == "sustained":
        assert np.array_equal(got.sustained.key.numpy(),
                              np.asarray(jst.sustained.key).astype(np.int64))
        assert dberr(got.sustained.ar_hist.numpy(),
                     np.asarray(jst.sustained.ar_hist)) <= -100


def test_sharded_span_sound_matches_jax(dberr):
    nb = 4
    bank, state, gains = _setup()
    jtables, _ = _span_inputs(bank, nb, False)
    jmesh, tmesh = _meshes((2, 4))
    _, jsound = jsh.make_sharded_span_sound(
        jmesh, bank, jtables, n_blocks=nb, block_size=S)(
        jsh.shard_state(jmesh, state), jsh.shard_bank(jmesh, bank),
        jsh.shard_span_tables(jmesh, jtables))
    tbank, tstate, _ = _port(bank, state, gains, tmesh)
    ttables = tsh.shard_span_tables(
        tmesh, span_tables_from_numpy(_np(jtables), device="cpu"))
    tsh.REDUCTIONS = 0
    _, tsound = tsh.make_sharded_span_sound(
        tmesh, n_blocks=nb, block_size=S)(tstate, tbank, ttables)
    assert tsh.REDUCTIONS == 1          # the mode partials only
    assert tsound.shape == (O, nb * S)
    assert dberr(tsound.numpy(), np.asarray(jsound)) <= -100


@pytest.mark.parametrize("n_blocks", [8, 256])
@pytest.mark.parametrize("layout", ["shared", "hetero"])
def test_sharded_flat_span_matches_unsharded_jax(layout, n_blocks, dberr):
    """A sharded span through the port's own flat tables (per-object for
    ``hetero``), split as the sharded session splits them, on a (4, 2)
    mesh against the JAX package's
    unsharded span through its default tables, and the ring-down after
    it, one reduction per dispatch. At 256 blocks (64 chunks of 512) the
    JAX package takes its two-level superchunk scan on the shared bank."""
    from openpbso_tpu_torch.ops import span as ts
    hetero = layout == "hetero"
    nb = n_blocks
    bank, state, gains = _setup(hetero=hetero)
    lam64 = np.asarray(bank.lam_re) + 1j * np.asarray(bank.lam_im)
    kw = dict(num_modes=bank.num_modes, shared=not hetero)
    jtables = build_span_tables(lam64, nb * S, **kw)
    assert jtables.superchunk == (32 if nb == 256 and not hetero else 1)
    _, tmesh = _meshes((4, 2))
    tbank, tstate, tgains = _port(bank, state, gains, tmesh)
    whole = ts.with_planes(ts.build_span_tables(lam64, nb * S, device="cpu",
                                                **kw))
    assert (whole.chunk, whole.n_chunks) == (jtables.chunk,
                                             jtables.n_chunks)
    ttables = tsh.shard_span_tables(tmesh, whole)
    jst, jmix = jsolver.step_span(state, bank, jtables, gains, n_blocks=nb,
                                  block_size=S, with_sustained=False)
    tsh.REDUCTIONS = 0
    tst, tmix = tsh.make_sharded_span(tmesh, n_blocks=nb, block_size=S)(
        tstate, tbank, ttables, tgains)
    assert tsh.REDUCTIONS == 1
    assert np.abs(np.asarray(jmix)).max() > 0
    assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100
    assert dberr(_gathered(tmesh, tst).z_re.numpy(),
                 np.asarray(jst.z_re)) <= -100
    jst, jmix = jsolver.decay_span_step(jst, bank, jtables, gains,
                                        n_blocks=nb, block_size=S)
    tst, tmix = tsh.make_sharded_span(tmesh, n_blocks=nb, block_size=S,
                                      decay=True)(tst, tbank, ttables,
                                                  tgains)
    assert tsh.REDUCTIONS == 2
    assert dberr(tmix.numpy(), np.asarray(jmix)) <= -100
    assert dberr(_gathered(tmesh, tst).z_im.numpy(),
                 np.asarray(jst.z_im)) <= -100


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("hetero", [False, True])
def test_sharded_tables_carry_the_planes_of_each_shard(hetero, mesh_shape):
    """Each cell's SpanPlanes are the planes of its own baby table,
    bitwise: the lo planes split on their mode axis 2, the reversed copy
    [Og, M, C] on its axis 1, the object rows for a per-object bank."""
    from openpbso_tpu_torch.ops import span as ts
    bank, _, _ = _setup(hetero=hetero)
    lam64 = np.asarray(bank.lam_re) + 1j * np.asarray(bank.lam_im)
    jt = build_span_tables(lam64, 8 * S, radix=2 * S,
                           num_modes=bank.num_modes, shared=not hetero)
    whole = ts.with_planes(span_tables_from_numpy(_np(jt), device="cpu"))
    _, tmesh = _meshes(mesh_shape)
    grid = tsh.shard_span_tables(tmesh, whole)
    for row in grid:
        for cell in row:
            own = ts.span_planes(cell.b_re, cell.b_im)
            for name in ("lo_re", "lo_im", "bt_re", "bt_im", "bt_lo_re",
                         "bt_lo_im"):
                assert torch.equal(getattr(cell.planes, name),
                                   getattr(own, name)), name
            assert cell.planes.bt_re.shape == (
                cell.b_re.shape[0], cell.b_re.shape[2], cell.chunk)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_shards_hold_the_jax_layout(mesh_shape):
    """Every leaf of the state, the bank and the span tables: each port
    cell bitwise the JAX shard on the same mesh position, and the gather
    the whole state back."""
    bank, state, gains = _setup(hetero=True, transfer_im=True)
    jtables = build_span_tables(np.asarray(bank.lam_re)
                                + 1j * np.asarray(bank.lam_im), 2 * S,
                                num_modes=bank.num_modes)
    jmesh, tmesh = _meshes(mesh_shape)
    tstate_full = state_from_numpy(_np(state), device="cpu")
    pairs = [(jsh.shard_state(jmesh, state),
              tsh.shard_state(tmesh, tstate_full)),
             (jsh.shard_bank(jmesh, bank),
              tsh.shard_bank(tmesh, bank_from_numpy(_np(bank),
                                                    device="cpu"))),
             (jsh.shard_span_tables(jmesh, jtables),
              tsh.shard_span_tables(tmesh, span_tables_from_numpy(
                  _np(jtables), device="cpu")))]
    for jtree, tgrid in pairs:
        for name in _leaf_names(tgrid[0][0]):
            for shard in _leaf(jtree, name).addressable_shards:
                (i, j), = np.argwhere(jmesh.devices == shard.device)
                cell = _leaf(tgrid[i][j], name).numpy()
                want = np.asarray(shard.data)
                if want.dtype == np.uint32:
                    want = want.astype(np.int64)
                assert np.array_equal(cell, want), name
    back = tsh.gather_state(tmesh, pairs[0][1])
    for name in _leaf_names(tstate_full):
        assert torch.equal(_leaf(back, name), _leaf(tstate_full, name))


def _leaf_names(tree, prefix=""):
    out = []
    for f in dataclasses.fields(tree):
        if not f.init:
            continue
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out += _leaf_names(v, prefix + f.name + ".")
        elif isinstance(v, torch.Tensor):
            out.append(prefix + f.name)
    return out


def _leaf(tree, name):
    for part in name.split("."):
        tree = getattr(tree, part)
    return tree


def test_make_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        tsh.make_mesh(4, 2, devices=["cpu"] * 4)
    mesh = tsh.make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"obj": 2, "mode": 2}
    assert mesh.devices[1, 0] == torch.device("cpu")
    if not torch.cuda.is_available():
        # devices None means the CUDA cards: there are none here
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            tsh.make_mesh(2, 1)


def test_split_refuses_an_axis_the_mesh_does_not_divide():
    bank, state, _ = _setup()
    with pytest.raises(ValueError, match="does not split into 3 shards"):
        tsh.shard_state(tsh.make_mesh(3, 1, devices=["cpu"] * 3),
                        state_from_numpy(_np(state), device="cpu"))
