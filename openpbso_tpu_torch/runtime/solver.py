"""The per-block synthesis step — counterpart of openpbso_tpu/runtime/solver.py.

One call synthesizes one S-sample block for every object (the reference's
ModalSolver::step, modal_solver.h:181-276, does one object):

1. force synthesis: slot table + sustained channel -> rank-1 excitation
   (space [O, M], time [O, S]), modal_solver.h:206-240;
2. modal integration: z' = lam z + b Q and per-object sound = q . transfer
   through the chosen backend (ops/integrator.py), modal_solver.h:262-271;
3. on request the per-mode energy telemetry qnorm, modal_solver.h:270-273;
4. mixdown over objects with per-object gains, divided by OUTPUT_SCALE.

The span entries (``step_span``, ``step_span_sound``, ``decay_span_step``)
advance many blocks in one dispatch through ops/span.py; ``step_multi`` is
the block-by-block loop they replace where a span does not fit, and
``step_multi_transfers`` is that loop with one transfer row per block (a
moving listener).

``with_sustained=False`` skips the sustained channel (the host knows when
every channel is inactive; the skipped terms are exact zeros).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import DEFAULT_BLOCK, OUTPUT_SCALE
from ..device import resolve_device
from ..ops.coeffs import ModalBank
from ..ops.forces import (force_block, force_span, sustained_block,
                          sustained_span)
from ..ops.integrator import (decay_block_blocked, get_backend,
                              resolve_backend_name, step_block_blocked_xfade,
                              step_block_scan_xfade)
from ..ops.span import ChunkSpanTables, decay_span, integrate_span
from .state import SolverState


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    block_size: int = DEFAULT_BLOCK
    backend: str = "auto"   # fused for heterogeneous banks on CUDA, else
    #   blocked (scan for table-less banks)
    compute_qnorm: bool = False
    decay_fast_path: bool = True  # homogeneous-only step when scene is idle
    smooth_transfer: bool = False  # ramp transfer after a listener move
    slot_buckets: tuple[int, ...] = (1,)  # force-slot slice sizes the
    #   session may step with besides the full table; () disables pruning


def _mixdown(sound: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Object mixdown -> output channels, already 1/1E10 scaled: sound
    [O, S] with gains [O, C], or [L, O, S] with gains [O, L] (channel l is
    listener l's own mix)."""
    if sound.dim() == 3:
        mix = torch.einsum("los,ol->sl", sound, gains)
    else:
        mix = sound.T @ gains
    return mix / OUTPUT_SCALE


def _mixdown_span(sound: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Span-path mixdown: multi-listener span sound is [O, L, N] (listener
    axis inside, the layout of ops/span.py), one channel per listener."""
    if sound.dim() == 3:
        return torch.einsum("oln,ol->nl", sound, gains) / OUTPUT_SCALE
    return _mixdown(sound, gains)


def block_backend(state: SolverState, backend: str, bank: ModalBank) -> str:
    """The backend that integrates a (non-ramped) block of ``state``:
    ``backend`` resolved for the bank, except that multi-listener and
    complex rows leave the fused kernel, which supports neither, for the
    blocked form, which handles both."""
    name = resolve_backend_name(backend, bank)
    if name == "fused" and (state.transfer.dim() == 3
                            or state.transfer_im is not None):
        return "blocked"
    return name


def advance_block(
    state: SolverState,
    bank: ModalBank,
    block_size: int,
    backend: str,
    compute_qnorm: bool,
    num_slots: int | None = None,
    with_sustained: bool = True,
    transfer_prev: torch.Tensor | None = None,
    transfer_prev_im: torch.Tensor | None = None,
):
    """Core block step before the mixdown: (state', sound [(L,) O, S],
    qnorm). ``num_slots`` slices the force-slot table to its first k slots
    when the host expiry mirror proves the rest can no longer produce;
    ``with_sustained=False`` skips the AR(2) channel when the host mirror
    proves every channel inactive (both output-invariant).
    ``transfer_prev`` selects the transfer-interpolating variant: the row
    ramps linearly from it to state.transfer across the block. The sharded
    steps (parallel/sharding.py) run it on every shard and reduce the
    partial sounds before they mix.
    """
    slots = state.slots
    if num_slots is not None and num_slots < slots.num_slots:
        slots = slots.first(num_slots)
    time_imp, space_imp = force_block(slots, state.block_start, block_size)
    if with_sustained:
        sus, time_sus, space_sus = sustained_block(
            state.sustained, block_size, state.block_start)
        # a sustained force replaces the object's impact forces
        # (modal_solver.h:195-204)
        gate = sus.active[:, None].to(time_imp.dtype)
        time_profile = time_imp * (1 - gate) + time_sus
        space = space_imp * (1 - gate) + space_sus
    else:
        sus = state.sustained
        time_profile, space = time_imp, space_imp

    if transfer_prev is None:
        integrate = get_backend(block_backend(state, backend, bank), bank)
        z_re, z_im, sound, qnorm = integrate(
            state.z_re, state.z_im, bank, space, time_profile,
            state.transfer, compute_qnorm, transfer_im=state.transfer_im)
    else:
        # the reference's routing (openpbso_tpu/runtime/solver.py:138-143):
        # only the scan has a ramped form of its own; every table-form
        # backend, the fused kernel included, ramps through the blocked form
        name = resolve_backend_name(backend, bank)
        fn = (step_block_scan_xfade if name == "scan"
              else step_block_blocked_xfade)
        z_re, z_im, sound, qnorm = fn(
            state.z_re, state.z_im, bank, space, time_profile,
            transfer_prev, state.transfer, compute_qnorm,
            transfer_prev_im=transfer_prev_im,
            transfer_im=state.transfer_im)
    new_state = dataclasses.replace(
        state, z_re=z_re, z_im=z_im, sustained=sus,
        block_start=state.block_start + block_size)
    return new_state, sound, qnorm


def _step_block_impl(
    state: SolverState,
    bank: ModalBank,
    gains: torch.Tensor,
    block_size: int,
    backend: str,
    compute_qnorm: bool,
    num_slots: int | None = None,
    with_sustained: bool = True,
    transfer_prev: torch.Tensor | None = None,
    transfer_prev_im: torch.Tensor | None = None,
):
    """advance_block and the mixdown: (state', sound, mix [S, C], qnorm)."""
    new_state, sound, qnorm = advance_block(
        state, bank, block_size, backend, compute_qnorm,
        num_slots=num_slots, with_sustained=with_sustained,
        transfer_prev=transfer_prev, transfer_prev_im=transfer_prev_im)
    mix = _mixdown(sound, gains)
    return new_state, sound, mix.to(torch.float32), qnorm


def step_block(
    state: SolverState,
    bank: ModalBank,
    gains: torch.Tensor,          # [O, 2] stereo gain/pan per object
    *,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    compute_qnorm: bool = False,
    with_sustained: bool = True,
    num_slots: int | None = None,
) -> tuple[SolverState, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Advance one block. Returns (state', sound [O,S], mix [S,2], qnorm)."""
    return _step_block_impl(state, bank, gains, block_size, backend,
                            compute_qnorm, num_slots=num_slots,
                            with_sustained=with_sustained)


def step_block_xfade(
    state: SolverState,
    bank: ModalBank,
    gains: torch.Tensor,
    transfer_prev: torch.Tensor,   # [O, M] transfer before the listener moved
    *,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    compute_qnorm: bool = False,
    with_sustained: bool = True,
    num_slots: int | None = None,
    transfer_prev_im: torch.Tensor | None = None,
) -> tuple[SolverState, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """One block with the transfer ramping linearly from ``transfer_prev``
    to ``state.transfer``: the session takes it for the one block after a
    listener move when SolverConfig.smooth_transfer is on, which removes
    the level step of the reference's block-constant transfer
    (modal_solver.h:286-300). Complex rows ramp re and im independently
    (``transfer_prev_im`` is the outgoing imaginary row, None = zero
    phase)."""
    return _step_block_impl(state, bank, gains, block_size, backend,
                            compute_qnorm, num_slots=num_slots,
                            with_sustained=with_sustained,
                            transfer_prev=transfer_prev,
                            transfer_prev_im=transfer_prev_im)


def decay_block(
    state: SolverState,
    bank: ModalBank,
    gains: torch.Tensor,
    *,
    block_size: int = DEFAULT_BLOCK,
    compute_qnorm: bool = False,
) -> tuple[SolverState, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Idle-scene fast path: one block with no active forces. The same
    output as step_block when every force slot has expired, at about half
    the device work; the host gates eligibility (session._idle)."""
    z_re, z_im, sound, qnorm = decay_block_blocked(
        state.z_re, state.z_im, bank, state.transfer, compute_qnorm,
        transfer_im=state.transfer_im)
    mix = _mixdown(sound, gains)
    new_state = dataclasses.replace(
        state, z_re=z_re, z_im=z_im,
        block_start=state.block_start + block_size)
    return new_state, sound, mix.to(torch.float32), qnorm


def step_multi(
    state: SolverState,
    bank: ModalBank,
    gains: torch.Tensor,
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    with_sustained: bool = True,
    num_slots: int | None = None,
) -> tuple[SolverState, torch.Tensor]:
    """Advance n_blocks block by block in one call (the JAX package's
    lax.scan of the block step). Force slots are pure functions of the
    sample clock, so hits scheduled inside the run fire at the right block.
    Returns (state', mix [n_blocks*S, C])."""
    mixes = []
    for _ in range(n_blocks):
        state, _, mix, _ = _step_block_impl(state, bank, gains, block_size,
                                            backend, False,
                                            num_slots=num_slots,
                                            with_sustained=with_sustained)
        mixes.append(mix)
    return state, torch.cat(mixes, dim=0)


def _multi_transfers(state, bank, gains, transfers, block_size, backend,
                     smooth, with_sustained, num_slots, want_sound):
    """The loop of step_multi_transfers(_sound): block i renders with
    ``transfers[i]`` and carries (state, previous row); a ramp from an
    unchanged row is exactly the constant-transfer render. Returns
    (state', the per-block mixes or sounds)."""
    prev = state.transfer
    outs = []
    for tr in transfers.unbind(dim=0):
        state = dataclasses.replace(state, transfer=tr)
        state, sound, mix, _ = _step_block_impl(
            state, bank, gains, block_size, backend, False,
            num_slots=num_slots, with_sustained=with_sustained,
            transfer_prev=prev if smooth else None)
        prev = tr
        outs.append(sound if want_sound else mix)
    return state, outs


def step_multi_transfers(
    state: SolverState,
    bank: ModalBank,
    gains: torch.Tensor,
    transfers: torch.Tensor,      # [n_blocks, O, M] per-block transfer rows
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    smooth: bool = False,
    with_sustained: bool = True,
    num_slots: int | None = None,
) -> tuple[SolverState, torch.Tensor]:
    """Moving-listener multi-block call: block i renders with
    ``transfers[i]``.

    The reference recomputes the transfer once per listener move and holds
    it block-constant (modal_solver.h:286-300). ``smooth=True`` ramps each
    block linearly from the previous block's row (the session's
    smooth_transfer semantics: continuous motion, no level steps); False
    holds each row block-constant like the reference. Returns
    (state', mix [N, C])."""
    if transfers.shape[0] != n_blocks:
        raise ValueError(f"expected {n_blocks} transfer rows, got "
                         f"{transfers.shape[0]}")
    state, mixes = _multi_transfers(state, bank, gains, transfers,
                                    block_size, backend, smooth,
                                    with_sustained, num_slots, False)
    return state, torch.cat(mixes, dim=0)


def step_multi_transfers_sound(
    state: SolverState,
    bank: ModalBank,
    transfers: torch.Tensor,      # [n_blocks, O, M] per-block transfer rows
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    smooth: bool = False,
    with_sustained: bool = True,
    num_slots: int | None = None,
) -> tuple[SolverState, torch.Tensor]:
    """step_multi_transfers returning the raw per-object sound instead of
    the mix: (state', sound [O, n_blocks*S]), or with listener row stacks
    ``transfers`` [n_blocks, L, O, M] the per-listener sounds
    [L, O, n_blocks*S]. For stages that work on each object's signal before
    the channel mixdown (a propagation-delay resample)."""
    if transfers.shape[0] != n_blocks:
        raise ValueError(f"expected {n_blocks} transfer rows, got "
                         f"{transfers.shape[0]}")
    gains_dummy = state.z_re.new_zeros((state.z_re.shape[0], 1))
    if transfers.dim() == 4:
        gains_dummy = state.z_re.new_zeros((state.z_re.shape[0],
                                            transfers.shape[1]))
    state, sounds = _multi_transfers(state, bank, gains_dummy, transfers,
                                     block_size, backend, smooth,
                                     with_sustained, num_slots, True)
    return state, torch.cat(sounds, dim=-1)


def _span_channels(state: SolverState, n_blocks: int, block_size: int,
                   num_slots: int | None, with_sustained: bool,
                   ar_g: torch.Tensor | None):
    """The span's excitation channels: the slot table, sliced to its first
    ``num_slots`` slots, plus with ``with_sustained`` the AR(2) channel as
    one extra slot, under the reference's replace semantics (the slots of
    a dragged object are gated off, modal_solver.h:195-204). Returns
    (sustained', f_k [O, K(+1), N], space_k [O, K(+1), M]).

    ``num_slots == 0`` with the channel is the drag-only span: the host
    proved no impact slot can produce, so the AR channel is the span's
    only slot."""
    n = n_blocks * block_size
    sus = state.sustained
    if with_sustained:
        if ar_g is None:
            raise ValueError("with_sustained needs the AR impulse table "
                             "ar_g (ops/forces.py::ar_impulse_g)")
        sus, prof, space_sus = sustained_span(sus, ar_g, n_blocks,
                                              block_size, state.block_start)
        if num_slots == 0:
            return sus, prof[:, None, :], space_sus[:, None, :]
    slots = state.slots
    if num_slots is not None and num_slots < slots.num_slots:
        slots = slots.first(num_slots)
    f_k, space_k = force_span(slots, state.block_start, n, block_size)
    if with_sustained:
        keep = 1 - sus.active[:, None, None].to(f_k.dtype)    # [O, 1, 1]
        f_k = torch.cat([f_k * keep, prof[:, None, :]], dim=1)
        space_k = torch.cat([space_k * keep, space_sus[:, None, :]], dim=1)
    return sus, f_k, space_k


def step_span_sound(
    state: SolverState,
    bank: ModalBank,
    tables: ChunkSpanTables,
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    num_slots: int | None = None,
    with_sustained: bool = False,
    ar_g: torch.Tensor | None = None,
    idle: bool = False,
) -> tuple[SolverState, torch.Tensor]:
    """Advance n_blocks in one span dispatch (ops/span.py) and return the
    raw per-object sound: (state', sound [O, N] or [O, L, N]).

    ``num_slots`` slices the force-slot table to its first k slots (the
    host's live count): per-slot work scales with k. ``with_sustained``
    adds the AR(2) channel as one more slot (ops/forces.py::sustained_span,
    the per-block noise stream); ``ar_g`` is its host impulse table
    [Og, L+1] (ar_impulse_g). ``idle=True`` is the ring-down fast path
    (decay_span), for a scene whose slots have all expired and whose
    channels are inactive. The transfer is constant across the span, like
    the reference's block-constant transfer."""
    n = n_blocks * block_size
    sus = state.sustained
    if idle:
        z_re, z_im, sound = decay_span(state.z_re, state.z_im, bank, tables,
                                       state.transfer, state.transfer_im)
    else:
        sus, f_k, space_k = _span_channels(state, n_blocks, block_size,
                                           num_slots, with_sustained, ar_g)
        z_re, z_im, sound = integrate_span(
            state.z_re, state.z_im, bank, tables, space_k, f_k,
            state.transfer, state.transfer_im)
    new_state = dataclasses.replace(state, z_re=z_re, z_im=z_im,
                                    sustained=sus,
                                    block_start=state.block_start + n)
    return new_state, sound


def step_span(
    state: SolverState,
    bank: ModalBank,
    tables: ChunkSpanTables,
    gains: torch.Tensor,
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    num_slots: int | None = None,
    with_sustained: bool = False,
    ar_g: torch.Tensor | None = None,
) -> tuple[SolverState, torch.Tensor]:
    """Advance n_blocks in one span dispatch with no serial dependency
    between blocks: the successor to step_multi for offline rendering and
    throughput, with the block-granular force semantics kept exactly
    (ops/forces.py::force_span) and the sustained channel as in
    step_span_sound. Returns (state', mix [N, C])."""
    state, sound = step_span_sound(
        state, bank, tables, n_blocks=n_blocks, block_size=block_size,
        num_slots=num_slots, with_sustained=with_sustained, ar_g=ar_g)
    return state, _mixdown_span(sound, gains).to(torch.float32)


def decay_span_step(
    state: SolverState,
    bank: ModalBank,
    tables: ChunkSpanTables,
    gains: torch.Tensor,
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
) -> tuple[SolverState, torch.Tensor]:
    """Idle-scene span: n_blocks of pure ring-down in one dispatch
    (host-gated like decay_block). Returns (state', mix [N, C])."""
    state, sound = step_span_sound(state, bank, tables, n_blocks=n_blocks,
                                   block_size=block_size, idle=True)
    return state, _mixdown_span(sound, gains).to(torch.float32)


def default_gains(num_objects: int, dtype: torch.dtype = torch.float32,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """Unit mono-to-stereo gains (the reference duplicates mono to L/R)."""
    return torch.ones((num_objects, 2), dtype=dtype,
                      device=resolve_device(device))
