"""The per-block synthesis step — counterpart of openpbso_tpu/runtime/solver.py.

One call synthesizes one S-sample block for every object (the reference's
ModalSolver::step, modal_solver.h:181-276, does one object):

1. force synthesis: slot table -> rank-1 excitation (space [O, M], time
   [O, S]), modal_solver.h:206-240;
2. modal integration: z' = lam z + b Q and per-object sound = q . transfer
   through the chosen backend (ops/integrator.py), modal_solver.h:262-271;
3. mixdown over objects with per-object gains, divided by OUTPUT_SCALE.

The sustained channel is not ported, so the step takes the reference's
``with_sustained=False`` branch, which is bitwise identical to the gated
sum while no channel is active (openpbso_tpu/runtime/solver.py:119-123).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import DEFAULT_BLOCK, OUTPUT_SCALE
from ..ops.coeffs import ModalBank
from ..ops.forces import force_block
from ..ops.integrator import (decay_block_blocked, get_backend,
                              resolve_backend_name)
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


def _step_block_impl(
    state: SolverState,
    bank: ModalBank,
    gains: torch.Tensor,
    block_size: int,
    backend: str,
    compute_qnorm: bool,
    num_slots: int | None = None,
):
    """Core block step. ``num_slots`` slices the force-slot table to its
    first k slots when the host expiry mirror proves the rest can no
    longer produce (output-invariant)."""
    slots = state.slots
    if num_slots is not None and num_slots < slots.num_slots:
        slots = slots.first(num_slots)
    time_profile, space = force_block(slots, state.block_start, block_size)

    if state.transfer.dim() == 3 or state.transfer_im is not None:
        # multi-listener and complex rows: the fused kernel supports
        # neither; the blocked form handles both
        if resolve_backend_name(backend, bank) == "fused":
            backend = "blocked"
    integrate = get_backend(backend, bank)
    z_re, z_im, sound, qnorm = integrate(
        state.z_re, state.z_im, bank, space, time_profile, state.transfer,
        compute_qnorm, transfer_im=state.transfer_im)
    mix = _mixdown(sound, gains)
    new_state = dataclasses.replace(
        state, z_re=z_re, z_im=z_im,
        block_start=state.block_start + block_size)
    return new_state, sound, mix.to(torch.float32), qnorm


def step_block(
    state: SolverState,
    bank: ModalBank,
    gains: torch.Tensor,          # [O, 2] stereo gain/pan per object
    *,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    compute_qnorm: bool = False,
    num_slots: int | None = None,
) -> tuple[SolverState, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Advance one block. Returns (state', sound [O,S], mix [S,2], qnorm)."""
    return _step_block_impl(state, bank, gains, block_size, backend,
                            compute_qnorm, num_slots=num_slots)


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


def default_gains(num_objects: int, dtype: torch.dtype = torch.float32,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """Unit mono-to-stereo gains (the reference duplicates mono to L/R)."""
    return torch.ones((num_objects, 2), dtype=dtype, device=device)
