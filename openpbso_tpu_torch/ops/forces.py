"""Contact-force excitation — force-slot tables, per block and per span.

Counterpart of the slot half of openpbso_tpu/ops/forces.py. Forces are
data: a fixed-size table of typed records per object, and each block's
time profile is synthesized branchlessly from the global sample clock. A
slot's lifetime is a pure function of its start sample, so the device
carries no per-slot state and the host recycles expired slots.

The excitation of a block is rank-1 (modal_solver.h:206-221): all
producing slots' time profiles summed into one [S] row and their modal
amplitudes into one [M] row.

Force kinds (forces.h:12-16): POINT (unit impulse, one block), GAUSSIAN
(exp(-0.5((t - 4.5w)/w)^2) while block_start < 10w), HERTZ (sin(pi t/tau)^1.5
over one contact time). The sustained AR channel is not ported yet: its
state is carried as an inactive data holder (SustainedState).
"""
from __future__ import annotations

import dataclasses
import math

import torch

FORCE_NONE = 0
FORCE_POINT = 1
FORCE_GAUSSIAN = 2
FORCE_HERTZ = 3

GAUSSIAN_CUTOFF = 5  # profile truncated after cutoff*2*width samples


@dataclasses.dataclass(frozen=True)
class ForceSlots:
    """[O, K] typed force records + [O, K, M] spatial amplitudes.

    The session writes single records in place (see
    runtime/session.py::ModalSession.hit)."""
    ftype: torch.Tensor   # [O, K] int32 (FORCE_* codes)
    t0: torch.Tensor      # [O, K] int32 device sample of activation block
    width: torch.Tensor   # [O, K] float gaussian width / contact samples
    amp: torch.Tensor     # [O, K] float profile amplitude scale
    space: torch.Tensor   # [O, K, M] modal amplitudes

    @property
    def num_slots(self) -> int:
        return self.ftype.shape[1]

    def first(self, k: int) -> ForceSlots:
        """Views (not copies) of the first ``k`` slots of every object."""
        return ForceSlots(*(getattr(self, f.name)[:, :k]
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class SustainedState:
    """The sustained AR(2) contact channel (modal_solver.h:190-240), carried
    as data only: the channel is not ported yet, so ``active`` stays all
    False and the solver takes the reference's inactive branch (bitwise
    identical while no channel is active, solver.py:119-123). The per-object
    noise keys arrive with the channel."""
    active: torch.Tensor  # [O] bool
    space: torch.Tensor   # [O, M]
    ar_hist: torch.Tensor  # [O, 2]
    a: torch.Tensor       # [O, 2] AR coefficients
    sigma: torch.Tensor   # [O]
    mu: torch.Tensor      # [O]


def make_force_slots(num_objects: int, num_slots: int, num_modes: int,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str | None = None) -> ForceSlots:
    o, k, m = num_objects, num_slots, num_modes
    return ForceSlots(
        ftype=torch.zeros((o, k), dtype=torch.int32, device=device),
        t0=torch.zeros((o, k), dtype=torch.int32, device=device),
        width=torch.ones((o, k), dtype=dtype, device=device),
        amp=torch.ones((o, k), dtype=dtype, device=device),
        space=torch.zeros((o, k, m), dtype=dtype, device=device),
    )


def make_sustained_state(num_objects: int, num_modes: int,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str | None = None
                         ) -> SustainedState:
    o, m = num_objects, num_modes
    return SustainedState(
        active=torch.zeros((o,), dtype=torch.bool, device=device),
        space=torch.zeros((o, m), dtype=dtype, device=device),
        ar_hist=torch.zeros((o, 2), dtype=dtype, device=device),
        a=torch.tensor([[0.783, 0.116]], dtype=dtype,
                       device=device).repeat(o, 1),
        sigma=torch.full((o,), 0.00148, dtype=dtype, device=device),
        mu=torch.full((o,), 0.142, dtype=dtype, device=device),
    )


def slot_duration(ftype: int, width: float, block_size: int) -> int:
    """Samples during which a slot produces (host-side recycling helper).

    A slot is expired once ``block_start - t0 >= duration``. Must mirror
    the device-side ``producing`` predicate in :func:`force_block`.
    """
    if ftype == FORCE_POINT:
        return block_size
    if ftype == FORCE_GAUSSIAN:
        return int(GAUSSIAN_CUTOFF * 2 * max(width, 1.0))
    if ftype == FORCE_HERTZ:
        return int(max(width, 1.0))
    return 0


def _slot_kinds(slots: ForceSlots):
    """(is_point, is_gauss, is_hertz, clamped width) per slot."""
    return (slots.ftype == FORCE_POINT,
            slots.ftype == FORCE_GAUSSIAN,
            slots.ftype == FORCE_HERTZ,
            torch.clamp(slots.width, min=1.0))


def _slot_duration_table(is_point, is_gauss, is_hertz, w):
    """Productive duration in samples per slot (0 for empty slots)."""
    zero = torch.zeros_like(w, dtype=torch.int32)
    return torch.where(
        is_point, torch.ones_like(zero),
        torch.where(is_gauss, (GAUSSIAN_CUTOFF * 2 * w).to(torch.int32),
                    torch.where(is_hertz, w.to(torch.int32), zero)))


def _slot_profile(t_local, is_point, is_gauss, is_hertz, w, dtype):
    """Force value of each slot at local sample times ``t_local`` [..., T]:
    the reference's Force::Add evaluated branchlessly (PointForce
    forces.h:81-90, GaussianForce :92-105 with the truncated center of :45,
    Hertzian contact pulse)."""
    tf = t_local.to(dtype)
    point_prof = (t_local == 0).to(dtype)
    # center is truncated to int in the reference (forces.h:45)
    center = torch.floor((GAUSSIAN_CUTOFF - 0.5) * w)
    dt = (tf - center[..., None]) / w[..., None]
    gauss_prof = torch.exp(-0.5 * dt * dt)
    # Hertz pulse sin(pi t/tau)^{3/2}, zero outside [0, tau). A select, not
    # a multiply by the mask: in float32 sin(pi * 1.0) is -8.7e-8, whose
    # 1.5th power is NaN, and NaN * 0 stays NaN (XLA rewrites the JAX
    # package's multiply-by-converted-bool into exactly this select).
    ph = torch.clamp(tf / w[..., None], 0.0, 1.0)
    hertz_prof = torch.where((t_local >= 0) & (tf < w[..., None]),
                             torch.sin(math.pi * ph) ** 1.5,
                             torch.zeros_like(ph))
    return torch.where(
        is_point[..., None], point_prof,
        torch.where(is_gauss[..., None], gauss_prof,
                    torch.where(is_hertz[..., None], hertz_prof,
                                torch.zeros_like(ph))))


def force_block(slots: ForceSlots, block_start: int, block_size: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank-1 excitation of one block: (time_profile [O, S], space
    [O, M]).

    ``block_start`` is the device sample clock (a Python int). Slot ``t0``
    values are block-aligned (the session activates forces at block
    boundaries, modal_solver.h:184).
    """
    local0 = block_start - slots.t0                       # [O, K] int32
    is_point, is_gauss, is_hertz, w = _slot_kinds(slots)
    dur = _slot_duration_table(is_point, is_gauss, is_hertz, w)
    # producing iff the block *starts* before the cutoff (forces.h:95)
    producing = (local0 >= 0) & (local0 < dur)

    t_local = local0[..., None] + torch.arange(
        block_size, dtype=torch.int32, device=local0.device)   # [O, K, S]
    prof = _slot_profile(t_local, is_point, is_gauss, is_hertz, w,
                         slots.amp.dtype)
    prof = prof * (producing * slots.amp)[..., None]
    time_profile = prof.sum(dim=1)

    space = (slots.space * producing[..., None].to(slots.space.dtype)).sum(
        dim=1)
    return time_profile, space


def force_span(slots: ForceSlots, block_start: int, n_samples: int,
               block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot excitation over a span of many blocks (ops/span.py):
    (f_k [O, K, N] per-slot effective profiles, space_k [O, K, M]).

    Slot membership changes per block inside a span, and the excitation of
    each block is the rank-1 product of the summed profiles and the summed
    amplitudes of its producing slots (modal_solver.h:206-221). Per slot:

        Q[m, n] = sum_k space_k[m] * (time_total[n] * member_k(block(n)))

    with member_k the producing predicate evaluated at the start of the
    block holding sample n. The profiles and the predicate are those of
    force_block, so each block of the span reproduces force_block exactly.
    """
    local0 = block_start - slots.t0                       # [O, K] int32
    is_point, is_gauss, is_hertz, w = _slot_kinds(slots)
    dur = _slot_duration_table(is_point, is_gauss, is_hertz, w)
    t_local = local0[..., None] + torch.arange(
        n_samples, dtype=torch.int32, device=local0.device)   # [O, K, N]
    # t0 is block-aligned, so flooring the local time to a block multiple
    # gives the local time at the start of the sample's block
    t_block = torch.div(t_local, block_size, rounding_mode="floor") \
        * block_size
    member = (t_block >= 0) & (t_block < dur[..., None])
    prof = _slot_profile(t_local, is_point, is_gauss, is_hertz, w,
                         slots.amp.dtype)
    prof = prof * member * slots.amp[..., None]
    time_total = prof.sum(dim=1)                          # [O, N]
    f_k = time_total[:, None, :] * member.to(prof.dtype)
    return f_k, slots.space
