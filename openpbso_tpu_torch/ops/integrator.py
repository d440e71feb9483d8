"""Modal IIR block integrator — per-block backends.

Counterpart of openpbso_tpu/ops/integrator.py. Given carried complex state
``z_{-1}`` per (object, mode), a rank-1 excitation ``Q_s[m] = space[m]
time[s]`` and a transfer row ``t[m]``, every backend produces over a block
of S samples

    z_s      = lam z_{s-1} + b space time_s          (q_s = Im z_s)
    sound_s  = sum_m t_m q_s[m]                      (modal_solver.h:267-269)

Backends:

- ``scan``    — a loop over samples; reference semantics, needs no tables.
- ``blocked`` — the block form over the lam-power tables ``P_d = lam^d``:

      sound = Im( sum_m t_m P_{s+1} z_{-1} ) + (G (*) time)_s,
              G_d = sum_m t_m Im(P_d b space)
      z_out = P_S z_{-1} + b space sum_j P_{S-1-j} time_j

  a few mode-reduction matmuls plus one causal FFT convolution.
- ``fused``   — the hand-written CUDA kernel for heterogeneous banks
  (ops/fused_integrator.py); ``pallas`` is accepted as its name so that
  configurations written for the JAX package keep working.

``compute_qnorm=True`` adds the per-mode energy telemetry

    qnorm_m  = sqrt(sum_s q_s[m]^2)                  (modal_solver.h:270-272)

which in the blocked form is the one term that needs per-mode, per-sample
values, so it is computed only on request (_qnorm_blocked walks the block
in chunks for it). The ``*_xfade`` variants ramp the transfer row linearly
across the block (a listener move without the level step of a
block-constant row).
"""
from __future__ import annotations

import torch

from .coeffs import ModalBank

def _complex_weights(t_re, t_im, v_re, v_im):
    """Reduce-channel weights of Im(t * P * v) for a possibly complex
    transfer t = t_re + i t_im (t_im None = the real case):

        Im(t P v) = P_re (t_re v_im + t_im v_re) + P_im (t_re v_re - t_im v_im)

    Returns (w_pr, w_pi)."""
    if t_im is None:
        return t_re * v_im, t_re * v_re
    return t_re * v_im + t_im * v_re, t_re * v_re - t_im * v_im


def _mode_reduce(w: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """einsum('om,oms->os'), one plain matmul for shared tables.

    ``w`` may carry a leading listener axis ([L, O, M] -> [L, O, S])."""
    if w.dim() == 3:
        if table.shape[0] == 1:
            lo, o, m = w.shape
            return (w.reshape(lo * o, m) @ table[0]).reshape(lo, o, -1)
        return torch.einsum("lom,oms->los", w, table)
    if table.shape[0] == 1:
        return w @ table[0]
    return torch.einsum("om,oms->os", w, table)


def _weighted_gather(table: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """einsum('omd,od->om') (shared-table aware)."""
    if table.shape[0] == 1:
        return f @ table[0].T
    return torch.einsum("omd,od->om", table, f)


def _causal_conv_fft(g: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Per-object causal convolution out[s] = sum_{j<=s} g[s-j] f[j] by a
    zero-padded FFT of length 2S."""
    s = g.shape[-1]
    n = 2 * s
    gf = torch.fft.rfft(g, n=n, dim=-1)
    ff = torch.fft.rfft(f, n=n, dim=-1)
    return torch.fft.irfft(gf * ff, n=n, dim=-1)[..., :s].to(g.dtype)


def step_block_scan(
    z_re: torch.Tensor,            # [O, M]
    z_im: torch.Tensor,            # [O, M]
    bank: ModalBank,
    space: torch.Tensor,           # [O, M]
    time_profile: torch.Tensor,    # [O, S]
    transfer: torch.Tensor,        # [(L,) O, M]
    compute_qnorm: bool = False,
    transfer_im: torch.Tensor | None = None,
):
    """Per-sample loop. Returns (z_re, z_im, sound [(L,) O, S],
    qnorm [O, M] | None)."""
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask
    sound = []
    qsq = torch.zeros_like(z_im) if compute_qnorm else None
    for f_s in time_profile.unbind(dim=-1):
        f_s = f_s[:, None]
        z_re, z_im = (bank.lam_re * z_re - bank.lam_im * z_im + be_re * f_s,
                      bank.lam_im * z_re + bank.lam_re * z_im + be_im * f_s)
        snd = (tmask * z_im).sum(dim=-1)
        if timask is not None:
            snd = snd + (timask * z_re).sum(dim=-1)
        sound.append(snd)
        if compute_qnorm:
            qsq = qsq + z_im * z_im
    qnorm = torch.sqrt(qsq) if compute_qnorm else None
    return z_re, z_im, torch.stack(sound, dim=-1), qnorm


def _check_tables(bank: ModalBank, s: int) -> None:
    if bank.pow_re is None or bank.pow_re.shape[-1] != s + 1:
        raise ValueError("bank tables missing or built for a different "
                         "block size")


def _render_blocked(bank, w, wi, z_re, z_im, be_re, be_im, time_profile):
    """sound [(L,) O, S] of the blocked form for masked weight rows
    ``w`` (+ i ``wi``): the homogeneous term plus the causal convolution
    of the time profile with G."""
    s = time_profile.shape[-1]
    pr, pi = bank.pow_re, bank.pow_im           # [Og, M, S+1]
    wz_pr, wz_pi = _complex_weights(w, wi, z_re, z_im)
    hom = (_mode_reduce(wz_pr, pr[..., 1:])
           + _mode_reduce(wz_pi, pi[..., 1:]))
    wg_pr, wg_pi = _complex_weights(w, wi, be_re, be_im)
    g = (_mode_reduce(wg_pi, pi[..., :s])
         + _mode_reduce(wg_pr, pr[..., :s]))
    return hom + _causal_conv_fft(g, time_profile)


def _advance_blocked(bank, z_re, z_im, be_re, be_im, time_profile):
    """z_out = lam^S z_{-1} + b space sum_j lam^{S-1-j} time_j."""
    s = time_profile.shape[-1]
    pr, pi = bank.pow_re, bank.pow_im
    f_rev = time_profile.flip(-1)
    c_re = _weighted_gather(pr[..., :s], f_rev)
    c_im = _weighted_gather(pi[..., :s], f_rev)
    ps_re, ps_im = pr[..., s], pi[..., s]
    z_re_out = ps_re * z_re - ps_im * z_im + be_re * c_re - be_im * c_im
    z_im_out = ps_im * z_re + ps_re * z_im + be_re * c_im + be_im * c_re
    return z_re_out, z_im_out


QNORM_CHUNK = 64   # samples per chunk of _qnorm_blocked's recurrence


def _qnorm_blocked(bank, be_re, be_im, time_profile, z_re, z_im):
    """Per-mode energy over the block, qnorm_m = sqrt(sum_s q_s[m]^2) with

        q_s = Im(lam^{s+1} z_{-1}) + sum_{j<=s} Im(lam^{s-j} b space) time_j.

    Independent of the transfer, so the plain and the xfade blocked steps
    share it. The JAX package forms q for the whole block by one length-2S
    FFT convolution per mode (openpbso_tpu/ops/integrator.py:207-219). At
    256 x 1024 x 512 that is a 0.54 GB kernel, spectra of 1.08 GB and about
    20 GB of traffic for one [O, M] answer. Here the block is walked in
    chunks of C samples, as the fused step walks it: from the state z_k at
    a chunk's start,

        q_{kC+c} = Im(lam^{c+1} z_k) + sum_{j<=c} Im(lam^{c-j} b space) f_j
        z_{k+1}  = lam^C z_k + b space sum_j lam^{C-1-j} f_j,

    the within-chunk convolution as one [M, C] x [C, C] product per object
    against the Toeplitz matrix of the chunk's profile. Only the first C+1
    columns of the tables are read, and nothing larger than [O, M, C] is
    held. The same values to float32 rounding."""
    s = time_profile.shape[-1]
    c = next(d for d in range(min(QNORM_CHUNK, s), 0, -1) if s % d == 0)
    o, n_chunks = time_profile.shape[0], s // c
    pr, pi = bank.pow_re, bank.pow_im               # [Og, M, S+1]
    p0r, p0i = pr[..., :c], pi[..., :c]             # lam^0 .. lam^{C-1}
    p1r, p1i = pr[..., 1:c + 1], pi[..., 1:c + 1]   # lam^1 .. lam^C
    pcr, pci = pr[..., c], pi[..., c]
    ker = be_re[..., None] * p0i + be_im[..., None] * p0r       # [O, M, C]
    f_chunks = time_profile.reshape(o, n_chunks, c)
    idx = torch.arange(c, device=time_profile.device)
    delta = idx[None, :] - idx[:, None]             # [j, c] -> c - j
    toep = (f_chunks[:, :, delta.clamp(min=0)]
            * (delta >= 0).to(time_profile.dtype))  # [O, K, C(j), C(c)]
    f_rev = f_chunks.flip(-1)
    if pr.shape[0] == 1:                            # shared tables
        inj_re, inj_im = f_rev @ p0r[0].T, f_rev @ p0i[0].T     # [O, K, M]
    else:
        inj_re = torch.einsum("omd,okd->okm", p0r, f_rev)
        inj_im = torch.einsum("omd,okd->okm", p0i, f_rev)
    # the chunk-start states as complex numbers: two launches a chunk
    # (the host's enqueue, not the card, bounds this loop)
    inj = torch.complex(be_re, be_im)[:, None] * torch.complex(inj_re, inj_im)
    lam_c = torch.complex(pcr, pci)
    z = torch.complex(z_re, z_im)
    qsq = torch.zeros_like(z_re)
    for k in range(n_chunks):
        q = torch.baddbmm(p1r * z.imag[..., None], ker, toep[:, k])
        q.addcmul_(p1i, z.real[..., None])
        qsq.add_(q.square_().sum(dim=-1))
        z = torch.addcmul(inj[:, k], lam_c, z)
    return torch.sqrt(qsq) * bank.mask


def step_block_blocked(
    z_re: torch.Tensor,            # [O, M]
    z_im: torch.Tensor,            # [O, M]
    bank: ModalBank,
    space: torch.Tensor,           # [O, M]
    time_profile: torch.Tensor,    # [O, S]
    transfer: torch.Tensor,        # [(L,) O, M]
    compute_qnorm: bool = False,
    transfer_im: torch.Tensor | None = None,
):
    """Block-form backend (needs bank lam-power tables of size S+1)."""
    _check_tables(bank, time_profile.shape[-1])
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask
    sound = _render_blocked(bank, tmask, timask, z_re, z_im, be_re, be_im,
                            time_profile)
    z_re_out, z_im_out = _advance_blocked(bank, z_re, z_im, be_re, be_im,
                                          time_profile)
    qnorm = (_qnorm_blocked(bank, be_re, be_im, time_profile, z_re, z_im)
             if compute_qnorm else None)
    return z_re_out, z_im_out, sound, qnorm


def _xfade_rows(transfer_prev, transfer, transfer_prev_im, transfer_im,
                mask):
    """(t0_re, dt_re, t0_im | None, dt_im | None) of the ramped transfer.

    A complex xfade ramps the real and the imaginary rows independently:
    the output is linear in both, so the ramped complex dot still splits
    into two constant-weight renders. A side without an imaginary row ramps
    from or to zero phase."""
    t0 = transfer_prev * mask
    dt = (transfer - transfer_prev) * mask
    if transfer_prev_im is None and transfer_im is None:
        return t0, dt, None, None
    pim = (torch.zeros_like(transfer_prev) if transfer_prev_im is None
           else transfer_prev_im)
    nim = torch.zeros_like(transfer) if transfer_im is None else transfer_im
    return t0, dt, pim * mask, (nim - pim) * mask


def _ramp(time_profile: torch.Tensor) -> torch.Tensor:
    """(s+1)/S for s in [0, S), in the profile's dtype and on its device."""
    s = time_profile.shape[-1]
    return torch.arange(1, s + 1, dtype=time_profile.dtype,
                        device=time_profile.device) / s


def step_block_scan_xfade(
    z_re: torch.Tensor,
    z_im: torch.Tensor,
    bank: ModalBank,
    space: torch.Tensor,
    time_profile: torch.Tensor,
    transfer_prev: torch.Tensor,   # [O, M] transfer at the block start
    transfer: torch.Tensor,        # [O, M] transfer at the block end
    compute_qnorm: bool = False,
    transfer_prev_im: torch.Tensor | None = None,
    transfer_im: torch.Tensor | None = None,
):
    """The scan backend with the transfer row interpolated per sample.

    The reference holds the transfer constant per block (computeTransfer
    consumes one listener update per block), which steps the output level
    when the listener moves fast. Here the row ramps linearly across the
    block: t(s) = t_prev + (s+1)/S (t_new - t_prev). Complex rows ramp re
    and im independently.
    """
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    t0, dt, t0i, dti = _xfade_rows(transfer_prev, transfer,
                                   transfer_prev_im, transfer_im, bank.mask)
    sound = []
    qsq = torch.zeros_like(z_im) if compute_qnorm else None
    for f_s, w in zip(time_profile.unbind(dim=-1), _ramp(time_profile)):
        f_s = f_s[:, None]
        z_re, z_im = (bank.lam_re * z_re - bank.lam_im * z_im + be_re * f_s,
                      bank.lam_im * z_re + bank.lam_re * z_im + be_im * f_s)
        snd = ((t0 + w * dt) * z_im).sum(dim=-1)
        if t0i is not None:
            snd = snd + ((t0i + w * dti) * z_re).sum(dim=-1)
        sound.append(snd)
        if compute_qnorm:
            qsq = qsq + z_im * z_im
    qnorm = torch.sqrt(qsq) if compute_qnorm else None
    return z_re, z_im, torch.stack(sound, dim=-1), qnorm


def step_block_blocked_xfade(
    z_re: torch.Tensor,
    z_im: torch.Tensor,
    bank: ModalBank,
    space: torch.Tensor,
    time_profile: torch.Tensor,
    transfer_prev: torch.Tensor,
    transfer: torch.Tensor,
    compute_qnorm: bool = False,
    transfer_prev_im: torch.Tensor | None = None,
    transfer_im: torch.Tensor | None = None,
):
    """The blocked backend with the transfer row interpolated per sample.

    The output is linear in the transfer weights, so the ramped dot splits
    into two constant-weight renders, sound_s = <t_prev, q_s> + ramp_s
    <dt, q_s>: the blocked render for both weight rows plus one elementwise
    ramp. The state update does not depend on the transfer and is that of
    step_block_blocked.
    """
    _check_tables(bank, time_profile.shape[-1])
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    t0, dt, t0i, dti = _xfade_rows(transfer_prev, transfer,
                                   transfer_prev_im, transfer_im, bank.mask)
    sound = (_render_blocked(bank, t0, t0i, z_re, z_im, be_re, be_im,
                             time_profile)
             + _ramp(time_profile)
             * _render_blocked(bank, dt, dti, z_re, z_im, be_re, be_im,
                               time_profile))
    z_re_out, z_im_out = _advance_blocked(bank, z_re, z_im, be_re, be_im,
                                          time_profile)
    qnorm = (_qnorm_blocked(bank, be_re, be_im, time_profile, z_re, z_im)
             if compute_qnorm else None)
    return z_re_out, z_im_out, sound, qnorm


def decay_block_blocked(
    z_re: torch.Tensor,            # [O, M]
    z_im: torch.Tensor,            # [O, M]
    bank: ModalBank,
    transfer: torch.Tensor,        # [(L,) O, M]
    compute_qnorm: bool = False,
    transfer_im: torch.Tensor | None = None,
):
    """Homogeneous-only block step (no forces): ``step_block_blocked`` with
    a zero excitation, whose convolution and injection terms vanish. The
    host decides eligibility (every force slot expired)."""
    s = bank.pow_re.shape[-1] - 1
    pr, pi = bank.pow_re, bank.pow_im
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask
    w_pr, w_pi = _complex_weights(tmask, timask, z_re, z_im)
    sound = (_mode_reduce(w_pr, pr[..., 1:])
             + _mode_reduce(w_pi, pi[..., 1:]))
    ps_re, ps_im = pr[..., s], pi[..., s]
    z_re_out = ps_re * z_re - ps_im * z_im
    z_im_out = ps_im * z_re + ps_re * z_im
    qnorm = None
    if compute_qnorm:
        q = pr[..., 1:] * z_im[..., None] + pi[..., 1:] * z_re[..., None]
        qnorm = torch.sqrt((q * q).sum(dim=-1)) * bank.mask
    return z_re_out, z_im_out, sound, qnorm


BACKENDS = {
    "scan": step_block_scan,
    "blocked": step_block_blocked,
}

# names of the JAX package that the port serves with another backend
_ALIASES = {"pallas": "fused"}


def auto_backend(has_tables: bool, shared_tables: bool,
                 device_type: str) -> str:
    """The 'auto' decision as a pure function of the bank's layout and the
    device its tensors live on: table-less banks can only run the scan;
    heterogeneous banks on a CUDA device take the fused kernel (the blocked
    form would stream [O, M, S]-sized tables every block); everything else
    takes the blocked form."""
    if not has_tables:
        return "scan"
    if device_type == "cuda" and not shared_tables:
        return "fused"
    return "blocked"


def resolve_backend_name(name: str, bank: ModalBank | None = None) -> str:
    """'auto' -> the best backend for the bank (see auto_backend); other
    names pass through, with 'pallas' read as 'fused'."""
    if name != "auto":
        return _ALIASES.get(name, name)
    if bank is None:
        return "blocked"
    return auto_backend(bank.pow_re is not None, bank.shared_tables,
                        bank.device.type)


def get_backend(name: str, bank: ModalBank | None = None):
    name = resolve_backend_name(name, bank)
    if name == "fused" and name not in BACKENDS:
        from . import fused_integrator  # noqa: F401 (registers 'fused')
    if name in BACKENDS:
        return BACKENDS[name]
    raise KeyError(f"unknown integrator backend {name!r}; "
                   f"have {sorted(BACKENDS)}")
