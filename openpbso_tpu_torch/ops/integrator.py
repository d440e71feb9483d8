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

Per-mode energy telemetry (qnorm) and the transfer-ramp (xfade) variants
are not ported yet; ``compute_qnorm=True`` raises.
"""
from __future__ import annotations

import torch

from .coeffs import ModalBank

_QNORM_NOT_PORTED = ("qnorm telemetry is not ported yet "
                     "(ROADMAP.md Queue 1 item 3: xfade and qnorm)")


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
    """Per-sample loop. Returns (z_re, z_im, sound [(L,) O, S], None)."""
    if compute_qnorm:
        raise NotImplementedError(_QNORM_NOT_PORTED)
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask
    sound = []
    for f_s in time_profile.unbind(dim=-1):
        f_s = f_s[:, None]
        z_re, z_im = (bank.lam_re * z_re - bank.lam_im * z_im + be_re * f_s,
                      bank.lam_im * z_re + bank.lam_re * z_im + be_im * f_s)
        snd = (tmask * z_im).sum(dim=-1)
        if timask is not None:
            snd = snd + (timask * z_re).sum(dim=-1)
        sound.append(snd)
    return z_re, z_im, torch.stack(sound, dim=-1), None


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
    if compute_qnorm:
        raise NotImplementedError(_QNORM_NOT_PORTED)
    s = time_profile.shape[-1]
    if bank.pow_re is None or bank.pow_re.shape[-1] != s + 1:
        raise ValueError("bank tables missing or built for a different "
                         "block size")
    pr, pi = bank.pow_re, bank.pow_im           # [Og, M, S+1]
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask

    wz_pr, wz_pi = _complex_weights(tmask, timask, z_re, z_im)
    hom = (_mode_reduce(wz_pr, pr[..., 1:])
           + _mode_reduce(wz_pi, pi[..., 1:]))
    wg_pr, wg_pi = _complex_weights(tmask, timask, be_re, be_im)
    g = (_mode_reduce(wg_pi, pi[..., :s])
         + _mode_reduce(wg_pr, pr[..., :s]))
    sound = hom + _causal_conv_fft(g, time_profile)

    # z_out = lam^S z_{-1} + b space sum_j lam^{S-1-j} time_j
    f_rev = time_profile.flip(-1)
    c_re = _weighted_gather(pr[..., :s], f_rev)
    c_im = _weighted_gather(pi[..., :s], f_rev)
    ps_re, ps_im = pr[..., s], pi[..., s]
    z_re_out = ps_re * z_re - ps_im * z_im + be_re * c_re - be_im * c_im
    z_im_out = ps_im * z_re + ps_re * z_im + be_re * c_im + be_im * c_re
    return z_re_out, z_im_out, sound, None


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
    if compute_qnorm:
        raise NotImplementedError(_QNORM_NOT_PORTED)
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
    return z_re_out, z_im_out, sound, None


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
