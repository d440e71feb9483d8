"""Multi-device scale-out: the block and span steps over an ('obj', 'mode')
grid of devices.

Counterpart of openpbso_tpu/parallel/sharding.py, whose steps are
``shard_map`` programs over a JAX mesh. The port keeps the JAX package's
single controller: one process holds every shard and launches each one's
work on its own device, so the session, the engine and the servers drive a
sharded session unchanged (parallel/session.py). The two axes shard what is
embarrassingly parallel:

- ``obj``: objects are independent; each shard integrates its own object
  rows, and the only cross-object step is the channel mixdown's sum;
- ``mode``: each shard owns a slice of the modes, and the transfer dot over
  modes becomes a partial sum.

The one cross-shard operation is ``psum``, which takes the place of
``jax.lax.psum``: it sums the shards' partials in a fixed shard order on the
first card of the reduced axis (a partial on another card is copied there
first). A block step makes two (the mode-partial sound, then the mix over
objects); a span dispatch makes exactly one, of the [N, C] mix, since the
mode-partial sound stays partial through the linear mixdown. ``REDUCTIONS``
counts the calls.

A sharded value is a grid: ``grid[i][j]`` is the part on
``mesh.devices[i, j]``. Every shard's work is the port's own solver code
(runtime/solver.py, ops/span.py) on the shard's tensors, so the span
kernels (chunk_scan, toeplitz_conv), the AR kernels (ar_noise, ar_block)
run on each shard at shard shapes. The sharded path takes the blocked and
span forms, never the fused kernel (as the JAX package's takes the blocked
form, not its Pallas kernel).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_BLOCK
from ..ops.coeffs import ModalBank
from ..ops.forces import ForceSlots, SustainedState
from ..ops.integrator import decay_block_blocked
from ..ops.span import (ChunkSpanTables, FullSpanTables, SpanPlanes,
                        SpanTables)
from ..runtime.solver import (_mixdown, _mixdown_span, advance_block,
                              step_span_sound)
from ..runtime.state import SolverState

# calls of psum, the one cross-shard reduction
REDUCTIONS = 0


class Mesh:
    """An ``n_obj x n_mode`` grid of torch devices with the axis names
    ('obj', 'mode'). ``devices[i, j]`` holds object shard i's mode shard
    j. A device may appear in more than one cell (several shards on one
    card, or the CPU cells of the tests)."""

    axis_names = ("obj", "mode")

    def __init__(self, devices):
        grid = np.asarray(devices, object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError("a mesh is a non-empty 2-d grid of devices")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)

    @property
    def shape(self) -> dict:
        """Axis name -> number of shards (as jax.sharding.Mesh.shape)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """The first cell's device: where reductions and gathers land."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def make_mesh(n_obj_shards: int, n_mode_shards: int = 1,
              devices=None) -> Mesh:
    """A mesh of ``n_obj_shards x n_mode_shards`` cells from ``devices``
    in row-major order. ``devices`` None is the CUDA cards; fewer devices
    than cells raises (a device may be named more than once, which puts
    several cells on it)."""
    if devices is None:
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = n_obj_shards * n_mode_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[i * n_mode_shards:(i + 1) * n_mode_shards]
                 for i in range(n_obj_shards)])


# ------------------------------------------------------------------ layouts
# A leaf's spec is (obj axis, mode axis): the tensor axes split over the
# mesh's 'obj' and 'mode' axes, None where the leaf replicates over that
# mesh axis (the PartitionSpecs of the JAX package, by position).


def state_specs(num_listeners: int = 1,
                complex_rows: bool = False) -> SolverState:
    """The spec of every SolverState leaf: oscillators and the slots'
    modal rows split both axes, the slots' records and the AR channel's
    per-object leaves (a, sigma, mu, key, ar_hist) follow 'obj', [L, O, M]
    listener rows replicate L; ``transfer_im`` follows ``transfer``."""
    om, o = (0, 1), (0, None)
    tspec = om if num_listeners <= 1 else (1, 2)
    return SolverState(
        z_re=om, z_im=om,
        slots=ForceSlots(ftype=o, t0=o, width=o, amp=o, space=(0, 2)),
        sustained=SustainedState(active=o, space=om, ar_hist=o, a=o,
                                 sigma=o, mu=o, key=o),
        transfer=tspec, block_start=None,
        transfer_im=tspec if complex_rows else None)


def bank_specs(bank: ModalBank) -> ModalBank:
    """Shared lam-power tables ([1, M, S+1]) replicate over 'obj' and
    split their mode axis; per-object (hetero) tables split both."""
    om = (0, 1)
    table = None
    if bank.pow_re is not None:
        table = (None, 1) if bank.shared_tables else om
    return ModalBank(lam_re=om, lam_im=om, b_re=om, b_im=om, mask=om,
                     pow_re=table, pow_im=table)


def span_table_specs(tables):
    """Specs of ops.span tables: the mode axis splits, the power axis
    replicates, the object axis follows the bank's layout. The full
    table ([M, N+1]) splits its mode axis 0. The superchunk powers of
    chunk tables split like the baby table (the JAX package's specs leave
    them out, and its shard_span_tables raises on them); so do the
    tables' SpanPlanes, so that each shard carries its own."""
    if isinstance(tables, FullSpanTables):
        return FullSpanTables(p_re=(None, 0), p_im=(None, 0))
    spec = (None, 2) if tables.shared else (0, 2)
    if isinstance(tables, SpanTables):
        return SpanTables(a_re=spec, a_im=spec, b_re=spec, b_im=spec)
    # the planes split on their mode axis: 2 of the lo planes, 1 of the
    # reversed copy [Og, M, C]
    bt = (None, 1) if tables.shared else (0, 1)
    planes = SpanPlanes(lo_re=spec, lo_im=spec, bt_re=bt, bt_im=bt,
                        bt_lo_re=bt, bt_lo_im=bt)
    return ChunkSpanTables(b_re=spec, b_im=spec, n_chunks=None,
                           s_re=spec, s_im=spec, planes=planes)


def _sound_spec(sound: torch.Tensor) -> tuple:
    """Per-block sound is [O, S] or [L, O, S] (listener axis leading)."""
    return (0, None) if sound.dim() == 2 else (1, None)


def _transfer_spec(rows: torch.Tensor) -> tuple:
    return (0, 1) if rows.dim() == 2 else (1, 2)


def _split(x, mesh: Mesh, spec, copy: bool = True):
    """The grid of ``x``'s parts under ``spec`` on the mesh's devices.
    ``copy`` gives every cell a contiguous tensor of its own (a shard's
    state is written in place); without it a part on the source device is
    a view. A tensor axis that the mesh axis does not divide raises."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        return [[x] * mesh.devices.shape[1]
                for _ in range(mesh.devices.shape[0])]
    spec = spec or (None, None)
    grid = []
    for i in range(mesh.devices.shape[0]):
        row = []
        for j in range(mesh.devices.shape[1]):
            part = x
            for axis, k, n in ((spec[0], i, mesh.devices.shape[0]),
                               (spec[1], j, mesh.devices.shape[1])):
                if axis is None:
                    continue
                size = x.shape[axis]
                if size % n:
                    raise ValueError(
                        f"axis {axis} of a {tuple(x.shape)} tensor does not "
                        f"split into {n} shards")
                part = part.narrow(axis, k * (size // n), size // n)
            dev = mesh.devices[i, j]
            row.append(part.to(dev, copy=True,
                               memory_format=torch.contiguous_format)
                       if copy else part.to(dev))
        grid.append(row)
    return grid


def _join(grid, spec, device: torch.device):
    """The inverse of _split: the parts concatenated on ``device`` along
    the split axes (a replicated axis takes its first part)."""
    oa, ma = spec or (None, None)
    rows = []
    for row in grid:
        if not isinstance(row[0], torch.Tensor):
            return row[0]          # an int leaf: replicated
        rows.append(torch.cat([p.to(device) for p in row], dim=ma)
                    if ma is not None else row[0].to(device))
    return torch.cat(rows, dim=oa) if oa is not None else rows[0]


def _fields(tree):
    return [f for f in dataclasses.fields(tree) if f.init]


def _tree_split(mesh: Mesh, tree, specs):
    """A grid of dataclasses: every leaf split under its spec."""
    n_obj, n_mode = mesh.devices.shape
    parts = {}
    for f in _fields(tree):
        v, spec = getattr(tree, f.name), getattr(specs, f.name)
        if v is None:
            parts[f.name] = None
        elif dataclasses.is_dataclass(v):
            parts[f.name] = _tree_split(mesh, v, spec)
        else:
            parts[f.name] = _split(v, mesh, spec)
    return [[type(tree)(**{k: (None if g is None else g[i][j])
                           for k, g in parts.items()})
             for j in range(n_mode)] for i in range(n_obj)]


def _tree_join(grid, specs, device: torch.device):
    tree = grid[0][0]
    out = {}
    for f in _fields(tree):
        v, spec = getattr(tree, f.name), getattr(specs, f.name)
        sub = [[getattr(cell, f.name) for cell in row] for row in grid]
        if v is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(v):
            out[f.name] = _tree_join(sub, spec, device)
        else:
            out[f.name] = _join(sub, spec, device)
    return type(tree)(**out)


def _state_specs_of(state: SolverState) -> SolverState:
    return state_specs(state.transfer.shape[0] if state.transfer.dim() == 3
                       else 1, complex_rows=state.transfer_im is not None)


def shard_state(mesh: Mesh, state: SolverState) -> list:
    """The state as a grid of per-shard SolverStates (every leaf a copy of
    its own, so that in-place writes stay on one shard)."""
    return _tree_split(mesh, state, _state_specs_of(state))


def gather_state(mesh: Mesh, shards: list) -> SolverState:
    """One SolverState on the mesh's first device from a grid of shards
    (fresh tensors: a write into it reaches no shard)."""
    return _tree_join(shards, _state_specs_of(shards[0][0]), mesh.first)


def shard_bank(mesh: Mesh, bank: ModalBank) -> list:
    return _tree_split(mesh, bank, bank_specs(bank))


def shard_span_tables(mesh: Mesh, tables) -> list:
    return _tree_split(mesh, tables, span_table_specs(tables))


def _grid(x, mesh: Mesh, spec):
    """A per-call input as a grid: one already split passes through; a
    whole tensor is split into views (copies on another device)."""
    if x is None or isinstance(x, list):
        return x
    return _split(x, mesh, spec, copy=False)


# --------------------------------------------------------------- reduction

def _sum(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device, non_blocking=True)
    return acc


def psum(grid, axis):
    """Sum a grid of partials over the mesh axis ``axis`` ('mode', 'obj'
    or both as ('obj', 'mode')), in fixed shard order, on the first card
    of each reduced group. Returns the reduced grid: [n_obj][1] over
    'mode', [1][n_mode] over 'obj', [[total]] over both. The one
    cross-shard operation of the sharded steps; counts its calls."""
    global REDUCTIONS
    REDUCTIONS += 1
    if axis == "mode":
        return [[_sum(row)] for row in grid]
    if axis == "obj":
        return [[_sum([row[j] for row in grid])
                 for j in range(len(grid[0]))]]
    if set(axis) == {"obj", "mode"}:
        return [[_sum([p for row in grid for p in row])]]
    raise ValueError(f"unknown mesh axis {axis!r}")


def _states(out):
    return [[cell[0] for cell in row] for row in out]


def _outputs(out, k):
    return [[cell[k] for cell in row] for row in out]


def _run(mesh: Mesh, fn):
    """``fn(i, j)`` on every cell, as a grid of its results."""
    n_obj, n_mode = mesh.devices.shape
    return [[fn(i, j) for j in range(n_mode)] for i in range(n_obj)]


# ------------------------------------------------------------------- steps

def _block_result(mesh, states, sounds, qnorms, gains, compute_qnorm):
    """The block step's tail: the mode-partial sounds summed (one psum),
    each object shard's mix, the mix over objects (one psum); the sound
    and qnorm gathered on the first device."""
    rows = psum(sounds, "mode")
    g = _grid(gains, mesh, (0, None))
    mix = psum([[_mixdown(rows[i][0], g[i][0])] for i in range(len(rows))],
               "obj")[0][0]
    sound = _join(rows, _sound_spec(rows[0][0]), mesh.first)
    qnorm = _join(qnorms, (0, 1), mesh.first) if compute_qnorm else None
    return states, sound, mix.to(torch.float32), qnorm


def make_sharded_step(mesh: Mesh, *,
                      block_size: int = DEFAULT_BLOCK,
                      backend: str = "blocked",
                      compute_qnorm: bool = False,
                      with_sustained: bool = True,
                      num_slots: int | None = None):
    """The block step over ``mesh``: ``step(state, bank, gains) ->
    (state', sound, mix, qnorm)`` with ``state``/``bank`` grids
    (shard_state, shard_bank) and whole gains [O, C]. Every shard runs
    solver.advance_block on its rows; the mode-partial sound and the mix
    over objects each take one psum. ``with_sustained``/``num_slots`` are
    the host-gated dead-work flags (runtime/solver.py). The steps read
    the layout (listener rows, complex rows, shared or per-object tables)
    from the shards they are given."""
    def step(state, bank, gains):
        out = _run(mesh, lambda i, j: advance_block(
            state[i][j], bank[i][j], block_size, backend, compute_qnorm,
            num_slots=num_slots, with_sustained=with_sustained))
        return _block_result(mesh, _states(out), _outputs(out, 1),
                             _outputs(out, 2), gains, compute_qnorm)
    return step


def make_sharded_xfade_step(mesh: Mesh, *,
                            block_size: int = DEFAULT_BLOCK,
                            backend: str = "blocked",
                            compute_qnorm: bool = False,
                            with_sustained: bool = True,
                            num_slots: int | None = None):
    """The transfer-ramp block step (solver.step_block_xfade) over
    ``mesh``: ``step(state, bank, gains, transfer_prev, transfer_prev_im=
    None)``, the outgoing rows whole or as grids. Either side may be real
    (im None): it ramps from or to zero phase (ops/integrator._xfade_rows),
    so a complex row fading to a real one needs no injected target."""
    def step(state, bank, gains, transfer_prev, transfer_prev_im=None):
        spec = _transfer_spec(state[0][0].transfer)
        prev = _grid(transfer_prev, mesh, spec)
        prev_im = _grid(transfer_prev_im, mesh, spec)
        out = _run(mesh, lambda i, j: advance_block(
            state[i][j], bank[i][j], block_size, backend, compute_qnorm,
            num_slots=num_slots, with_sustained=with_sustained,
            transfer_prev=prev[i][j],
            transfer_prev_im=None if prev_im is None else prev_im[i][j]))
        return _block_result(mesh, _states(out), _outputs(out, 1),
                             _outputs(out, 2), gains, compute_qnorm)
    return step


def make_sharded_decay_step(mesh: Mesh, *,
                            block_size: int = DEFAULT_BLOCK,
                            compute_qnorm: bool = False):
    """The idle-scene decay step (solver.decay_block) over ``mesh``, with
    the single-device path's host gating contract; the same two psums as
    the full step."""
    def one(st, bk):
        z_re, z_im, sound, qnorm = decay_block_blocked(
            st.z_re, st.z_im, bk, st.transfer, compute_qnorm,
            transfer_im=st.transfer_im)
        new = dataclasses.replace(st, z_re=z_re, z_im=z_im,
                                  block_start=st.block_start + block_size)
        return new, sound, qnorm

    def step(state, bank, gains):
        out = _run(mesh, lambda i, j: one(state[i][j], bank[i][j]))
        return _block_result(mesh, _states(out), _outputs(out, 1),
                             _outputs(out, 2), gains, compute_qnorm)
    return step


def make_sharded_multi(mesh: Mesh, *, n_blocks: int,
                       block_size: int = DEFAULT_BLOCK,
                       backend: str = "blocked",
                       with_sustained: bool = True,
                       num_slots: int | None = None):
    """n_blocks block steps in one call (solver.step_multi over ``mesh``):
    ``step(state, bank, gains) -> (state', mix [n_blocks*S, C])``, two
    psums per block."""
    block = make_sharded_step(mesh, block_size=block_size, backend=backend,
                              with_sustained=with_sustained,
                              num_slots=num_slots)

    def step(state, bank, gains):
        mixes = []
        for _ in range(n_blocks):
            state, _sound, mix, _ = block(state, bank, gains)
            mixes.append(mix)
        return state, torch.cat(mixes, dim=0)
    return step


def _span_shards(mesh, state, bank, tables, n_blocks, block_size,
                 num_slots, decay, with_sustained, ar_g, ar_g_shared):
    """solver.step_span_sound on every shard: a grid of (state', the
    shard's partial sound [O_i, (L,) N])."""
    if with_sustained and not decay:
        if ar_g is None:
            raise ValueError("with_sustained needs the AR impulse table")
        ar = _grid(ar_g, mesh, (None if ar_g_shared else 0, None))
    else:
        ar = None
    return _run(mesh, lambda i, j: step_span_sound(
        state[i][j], bank[i][j], tables[i][j], n_blocks=n_blocks,
        block_size=block_size, num_slots=num_slots,
        with_sustained=with_sustained and not decay,
        ar_g=None if ar is None else ar[i][j], idle=decay))


def make_sharded_span(mesh: Mesh, *, n_blocks: int,
                      block_size: int = DEFAULT_BLOCK,
                      num_slots: int | None = None,
                      decay: bool = False,
                      with_sustained: bool = False,
                      ar_g_shared: bool = True):
    """The span dispatch (ops/span.py) over ``mesh``: N = n_blocks*S
    samples with ONE psum, of the [N, C] mix. The mode-partial hom and
    convolution sums stay partial through the (linear) mixdown and reduce
    together with the sum over objects. ``step(state, bank, tables, gains)
    -> (state', mix)``; with ``with_sustained``, ``step(state, bank,
    tables, gains, ar_g)`` (the AR impulse table [Og, L+1], replicated
    when ``ar_g_shared`` else split over 'obj': the AR(2) channel is
    per-object, so it adds no reduction)."""
    def step(state, bank, tables, gains, ar_g=None):
        out = _span_shards(mesh, state, bank, tables, n_blocks, block_size,
                           num_slots, decay, with_sustained, ar_g,
                           ar_g_shared)
        g = _grid(gains, mesh, (0, None))
        parts = _run(mesh, lambda i, j: _mixdown_span(out[i][j][1],
                                                      g[i][j]))
        mix = psum(parts, ("obj", "mode"))[0][0]
        return _states(out), mix.to(torch.float32)
    return step


def make_sharded_span_sound(mesh: Mesh, *, n_blocks: int,
                            block_size: int = DEFAULT_BLOCK,
                            num_slots: int | None = None,
                            decay: bool = False,
                            with_sustained: bool = False,
                            ar_g_shared: bool = True):
    """The span returning the raw per-object sound (solver.step_span_sound,
    the span-shaped post-mix feed) over ``mesh``: the mode partials take
    one psum over 'mode' and the object shards are gathered on the first
    device. ``step(state, bank, tables[, ar_g]) -> (state', sound [O, N]
    or [O, L, N])``."""
    def step(state, bank, tables, ar_g=None):
        out = _span_shards(mesh, state, bank, tables, n_blocks, block_size,
                           num_slots, decay, with_sustained, ar_g,
                           ar_g_shared)
        rows = psum(_outputs(out, 1), "mode")
        return _states(out), _join(rows, (0, None), mesh.first)
    return step
