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
over one contact time), and the sustained AR(2) channel of scraping and
rolling contact (forces.h:107-137, one per object, modal_solver.h:190-240):
per block (``sustained_block``, the ops/ar_block.py kernel) or factored over
a whole span (``sustained_span``), both from the same counter-derived
noise (ops/ar_noise.py).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from .ar_block import ar_block
from .ar_noise import ar_noise
from .threefry import prng_key, split
from .toeplitz_conv import toeplitz_conv

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
    """Per-object sustained-force channel (modal_solver.h:190-240).

    While ``active``, an object's block excitation is the AR(2) profile
    times ``space`` and its slot table is ignored (the reference clears
    other forces on sustained start, modal_solver.h:191-194). The session
    writes single rows in place."""
    active: torch.Tensor  # [O] bool
    space: torch.Tensor   # [O, M]
    ar_hist: torch.Tensor  # [O, 2] mu~_{k-1}, mu~_{k-2}
    a: torch.Tensor       # [O, 2] AR coefficients
    sigma: torch.Tensor   # [O]
    mu: torch.Tensor      # [O]
    key: torch.Tensor     # [O, 2] int64 holding uint32 words: per-object
    #   BASE keys, never advanced (each block's noise key is fold_in(key,
    #   block index), ops/ar_noise.py), so the stream replays exactly


def make_force_slots(num_objects: int, num_slots: int, num_modes: int,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str | None = None) -> ForceSlots:
    o, k, m = num_objects, num_slots, num_modes
    device = resolve_device(device)
    return ForceSlots(
        ftype=torch.zeros((o, k), dtype=torch.int32, device=device),
        t0=torch.zeros((o, k), dtype=torch.int32, device=device),
        width=torch.ones((o, k), dtype=dtype, device=device),
        amp=torch.ones((o, k), dtype=dtype, device=device),
        space=torch.zeros((o, k, m), dtype=dtype, device=device),
    )


def make_sustained_state(num_objects: int, num_modes: int, seed: int = 0,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str | None = None
                         ) -> SustainedState:
    """An inactive channel with the reference's default tuning; the keys
    are ``jax.random.split(jax.random.PRNGKey(seed), O)``'s, bitwise."""
    o, m = num_objects, num_modes
    device = resolve_device(device)
    return SustainedState(
        active=torch.zeros((o,), dtype=torch.bool, device=device),
        space=torch.zeros((o, m), dtype=dtype, device=device),
        ar_hist=torch.zeros((o, 2), dtype=dtype, device=device),
        a=torch.tensor([[0.783, 0.116]], dtype=dtype,
                       device=device).repeat(o, 1),
        sigma=torch.full((o,), 0.00148, dtype=dtype, device=device),
        mu=torch.full((o,), 0.142, dtype=dtype, device=device),
        key=split(prng_key(seed), o, device=device),
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


# ---------------------------------------------------------------------------
# sustained AR(2) channel
# ---------------------------------------------------------------------------


def ar_stability_radius(a) -> float:
    """Largest characteristic-root magnitude of the AR(2) recurrence
    mu[n] = a1 mu[n-1] + a2 mu[n-2] (roots of r^2 - a1 r - a2 = 0); < 1 is
    stable. Non-finite coefficients return inf, so every ``radius < 1.0``
    check rejects them (``radius >= 1.0`` is False for NaN)."""
    a = np.asarray(a, np.float64).reshape(2)
    if not np.all(np.isfinite(a)):
        return float("inf")
    half = a[0] / 2.0
    root = np.sqrt(np.complex128(half * half + a[1]))
    return float(max(abs(half + root), abs(half - root)))


def ar_impulse_g(a: np.ndarray, length: int) -> np.ndarray:
    """Host float64 impulse response of the AR(2) recurrence: g[d] for d in
    [0, length], g[0] = 1, g[1] = a1, g[d] = a1 g[d-1] + a2 g[d-2].

    The companion matrix A = [[a1, a2], [1, 0]] has A^d e1 = [g[d],
    g[d-1]], so every power the span uses is a pair of g entries.
    ``a``: [2] or [O, 2]; returns [O, length+1]. Closed form from the
    characteristic roots, g[d] = (r1^(d+1) - r2^(d+1)) / (r1 - r2); near a
    double root (where that cancels) the binomial expansion in
    e2 = a1^2/4 + a2, f64-exact there after three terms."""
    a = np.atleast_2d(np.asarray(a, np.float64))
    o = a.shape[0]
    d = np.arange(length + 1, dtype=np.float64)
    half = a[:, :1] / 2.0
    root = np.sqrt((half * half + a[:, 1:2]).astype(np.complex128))
    r1, r2 = half + root, half - root
    sep = np.abs(r1 - r2)
    scale = np.maximum(np.abs(r1), np.abs(r2)).clip(min=1e-30)
    ok = (sep > 1e-8 * scale)[:, 0]
    g = np.zeros((o, length + 1))
    with np.errstate(over="ignore", invalid="ignore"):
        if ok.any():
            g[ok] = ((r1[ok] ** (d + 1) - r2[ok] ** (d + 1))
                     / (r1[ok] - r2[ok])).real
    if not ok.all():
        idx = np.nonzero(~ok)[0]
        r = half[idx]                                   # [k, 1] real
        e2 = (half * half + a[:, 1:2])[idx]             # [k, 1] ~ 0
        dp1 = d + 1.0
        c3 = dp1 * (dp1 - 1) * (dp1 - 2) / 6.0
        c5 = c3 * (dp1 - 3) * (dp1 - 4) / 20.0
        with np.errstate(over="ignore", invalid="ignore"):
            t0 = dp1 * r ** d
            t1 = np.where(d >= 2, c3 * r ** np.maximum(d - 2, 0), 0.0) * e2
            t2 = np.where(d >= 4, c5 * r ** np.maximum(d - 4, 0),
                          0.0) * (e2 * e2)
        g[idx] = t0 + t1 + t2
    return g


def span_group(n_blocks: int, cap: int) -> int:
    """Largest divisor of ``n_blocks`` that is <= ``cap`` (>= 1): the block
    group of the scan-free companion propagation. One definition for
    _companion_states and the session's AR-table sizing
    (runtime/session.py::ar_span_table), so the table always covers the
    group."""
    for cand in range(min(n_blocks, cap), 0, -1):
        if n_blocks % cand == 0:
            return cand
    return 1


def sustained_block(state: SustainedState, block_size: int,
                    block_start: int = 0):
    """One block of AR(2) profiles for every object: (new_state,
    time_profile [O, S], space [O, M]); inactive objects produce zeros and
    keep their history. mu~_k = a1 mu~_{k-1} + a2 mu~_{k-2} + sigma N(0,1),
    output mu + mu~ (forces.h:107-128), with the noise of the block at
    ``block_start`` (ops/ar_noise.py), so per-block stepping draws the span
    stream."""
    profile, hist = ar_block(state.key, state.a, state.ar_hist, state.sigma,
                             state.mu, state.active, block_start, block_size)
    space = state.space * state.active[:, None].to(state.space.dtype)
    return dataclasses.replace(state, ar_hist=hist), profile, space


def _companion_powers(g: torch.Tensor, a2: torch.Tensor, grp: int,
                      block_size: int) -> torch.Tensor:
    """A^(d*S) for d in [0, grp] from gathers of the impulse table
    (A^d = [[g[d], a2 g[d-1]], [g[d-1], a2 g[d-2]]]; d=0 set to I).
    ``g``: [Og, >= grp*S + 1], ``a2``: [Og]. Returns [Og, grp+1, 2, 2]."""
    idxp = torch.arange(grp + 1, device=g.device) * block_size
    gpad = torch.cat([torch.zeros_like(g[:, :2]), g], dim=-1)
    p00 = g[:, idxp]                       # g[dS]
    p10 = gpad[:, idxp + 1]                # g[dS-1]
    p01 = a2[:, None] * p10
    p11 = a2[:, None] * gpad[:, idxp]      # a2 g[dS-2]
    p00[:, 0], p10[:, 0], p01[:, 0], p11[:, 0] = 1.0, 0.0, 0.0, 1.0
    return torch.stack([torch.stack([p00, p01], dim=-1),
                        torch.stack([p10, p11], dim=-1)], dim=-2)


def _companion_states(h0: torch.Tensor, inj: torch.Tensor, g: torch.Tensor,
                      a2: torch.Tensor, n_blocks: int, block_size: int):
    """Propagate h_{b+1} = A^S h_b + inj[b] over the span's blocks; ``inj``
    [O, X, 2]. Returns (h_final [O, 2], hs [O, X, 2] start-of-block states).

    Scan-free up to the group size the g table affords (grp = largest
    divisor of X with grp*S < len(g)): the group-start states take X/grp
    serial steps (one for a shared table that covers the span), and the
    states inside a group are 2x2-batched contractions against the
    companion powers."""
    o = h0.shape[0]
    x = n_blocks
    shared = g.shape[0] == 1
    grp = span_group(x, (g.shape[1] - 1) // block_size)
    pows = _companion_powers(g, a2, grp, block_size)   # [Og, grp+1, 2, 2]
    xg = x // grp
    ir = inj.reshape(o, xg, grp, 2)
    # group injection: INJ_q = sum_j A^((grp-1-j)S) inj[qG + j]
    wf = pows[:, :grp].flip(1)
    if shared:
        inj_g = torch.einsum("oqjb,jrb->qor", ir, wf[0])
    else:
        inj_g = torch.einsum("oqjb,ojrb->qor", ir, wf)
    rot = pows[:, grp]                                 # A^(grp*S)
    h, hq = h0, []
    for q in range(xg):
        hq.append(h)
        if shared:
            h = torch.einsum("ob,rb->or", h, rot[0]) + inj_g[q]
        else:
            h = torch.einsum("orb,ob->or", rot, h) + inj_g[q]
    hq = torch.stack(hq)                               # [XG, O, 2]
    # interior: h[qG+j] = A^(jS) H_q + sum_{i<j} A^((j-1-i)S) inj[qG+i]
    if shared:
        car = torch.einsum("qob,jrb->oqjr", hq, pows[0, :grp])
    else:
        car = torch.einsum("qob,ojrb->oqjr", hq, pows[:, :grp])
    # powsp[k] = A^((k-1)S) with powsp[0] = 0: the clipped (j - i) gather
    # is zero for i >= j
    powsp = torch.cat([torch.zeros_like(pows[:, :1]), pows], dim=1)
    idx = torch.arange(grp, device=g.device)
    tmix = powsp[:, (idx[:, None] - idx[None, :]).clamp(min=0)]
    if shared:
        mix = torch.einsum("oqib,jirb->oqjr", ir, tmix[0])
    else:
        mix = torch.einsum("oqib,ojirb->oqjr", ir, tmix)
    return h, (car + mix).reshape(o, x, 2)


def sustained_span(state: SustainedState, g: torch.Tensor, n_blocks: int,
                   block_size: int, block_start: int = 0):
    """Whole-span AR(2) profiles: the span form of ``sustained_block``.

    The recurrence is linear and time-invariant, so it factors over the
    span like the oscillators do (ops/span.py): with h_b the companion
    state [mu~_{b-1}, mu~_{b-2}] at block b's start and g the host-f64
    impulse table (ar_impulse_g),

        h_{b+1}  = A^S h_b + sigma [n_b . rev(g[:S]), n_b . rev(gp[:S])]
        mu~_b[k] = g[k+1] h_b[0] + a2 g[k] h_b[1]
                   + sigma sum_{j<=k} g[k-j] n_b[j]

    The noise is the per-block stream (ar_noise kernel), the injections and
    the homogeneous part are float32 matrix products, the start states come
    from the scan-free group propagation (_companion_states), and the noise
    convolution is the span's Toeplitz kernel with one slot and one chunk
    per block (toeplitz_conv with K = 1, C = S): no [O, S, S] Toeplitz
    tensor is built.

    ``g``: [1, L+1] (one shared tuning) or [O, L+1] per-object tables, L >=
    S; L >= n_blocks*S makes the propagation scan-free. Returns
    (new_state, profile [O, N], space [O, M]); inactive objects produce
    zeros and keep their history."""
    if block_size < 2:
        raise ValueError("sustained_span needs block_size >= 2 (the AR(2) "
                         "injection rows assume two lags per block)")
    o = state.active.shape[0]
    s, x = block_size, n_blocks
    dtype = state.space.dtype
    shared = g.shape[0] == 1
    g = g.to(dtype)
    a2 = state.a[:1, 1] if shared else state.a[:, 1]      # [Og]
    sigma = state.sigma[:, None]                          # [O, 1]

    # gp[d+1] = g[d] with gp[0] = g[-1] = 0; injection rows: inj[0] needs
    # g[S-1-j], inj[1] needs g[S-2-j] (j < S)
    gp = torch.cat([torch.zeros_like(g[:, :1]), g], dim=-1)
    g2 = torch.stack([gp[:, 1:s + 1].flip(-1), gp[:, :s].flip(-1)],
                     dim=-1)                              # [Og, S, 2]

    noise = ar_noise(state.key, block_start, x, s).to(dtype)  # [O, X, S]
    if shared:
        inj = (noise.reshape(o * x, s) @ g2[0]).reshape(o, x, 2)
    else:
        inj = torch.bmm(noise, g2)
    inj = sigma[..., None] * inj

    h_f, hs = _companion_states(state.ar_hist, inj, g, a2, x, s)

    # within-block homogeneous part: g[k+1] h0 + a2 g[k] h1
    h_rows = torch.stack([g[:, 1:s + 1], a2[:, None] * g[:, :s]],
                         dim=1)                           # [Og, 2, S]
    if shared:
        mu_hom = (hs.reshape(o * x, 2) @ h_rows[0]).reshape(o, x, s)
    else:
        mu_hom = torch.bmm(hs, h_rows)
    # noise conv mu_conv[o, x, k] = sum_{j<=k} g[o, k-j] n[o, x, j]
    conv_g = g[:, :s].expand(o, s)[:, None, None, :]      # [O, 1, 1, S]
    mu_conv = toeplitz_conv(conv_g, noise[:, None])[:, 0]
    mu_tilde = mu_hom + sigma[..., None] * mu_conv        # [O, X, S]

    gate = state.active
    gatef = gate[:, None].to(dtype)
    profile = (state.mu[:, None] + mu_tilde.reshape(o, x * s)) * gatef
    space = state.space * gatef
    new_state = dataclasses.replace(
        state, ar_hist=torch.where(gate[:, None], h_f, state.ar_hist))
    return new_state, profile, space
