"""SolverState — the complete per-block carried state.

Counterpart of openpbso_tpu/runtime/state.py: the oscillator state, the
force-slot table, the sustained AR(2) channel and the transfer row,
as one frozen dataclass of device tensors. The block clock is a Python int:
the host always knows it, so no step reads it back from the device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import UNIT_TRANSFER
from ..device import resolve_device
from ..ops.forces import (ForceSlots, SustainedState, make_force_slots,
                          make_sustained_state)


@dataclasses.dataclass(frozen=True)
class SolverState:
    z_re: torch.Tensor          # [O, M] oscillator state Re(z)
    z_im: torch.Tensor          # [O, M] oscillator state Im(z) (= q)
    slots: ForceSlots           # pending/active impact forces
    sustained: SustainedState   # sustained AR(2) contact channel
    transfer: torch.Tensor      # [O, M] latest acoustic transfer row
    block_start: int            # device sample clock (origin-rebased)
    transfer_im: torch.Tensor | None = None   # imaginary transfer part
    #   (per-mode phase); the blocked and scan backends take it

    @property
    def num_objects(self) -> int:
        return self.z_re.shape[0]

    @property
    def num_modes(self) -> int:
        return self.z_re.shape[1]


def make_solver_state(
    num_objects: int,
    num_modes: int,
    *,
    num_slots: int = 16,
    seed: int = 0,
    unit_transfer: bool = True,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> SolverState:
    """Fresh state: silent oscillators, empty force slots, an inactive
    sustained channel whose noise keys derive from ``seed``, and the
    reference's unit transfer 1E7 (modal_solver.h:89-92)."""
    o, m = num_objects, num_modes
    device = resolve_device(device)
    fill = UNIT_TRANSFER if unit_transfer else 0.0
    return SolverState(
        z_re=torch.zeros((o, m), dtype=dtype, device=device),
        z_im=torch.zeros((o, m), dtype=dtype, device=device),
        slots=make_force_slots(o, num_slots, m, dtype, device),
        sustained=make_sustained_state(o, m, seed, dtype, device),
        transfer=torch.full((o, m), fill, dtype=dtype, device=device),
        block_start=0,
    )
