"""Replay a recorded event list through the plain reference: the two ears
of a binaural listener among instances of a few models.

The events are those of replay.py, with one difference: a listener event
holds the head's world position [3], not per-object rows. From it this
module forms, with no code of the program:

- each ear's rows: the head plus the ear's offset (``ears`` [L, 3]) less
  each instance's world position (``centers`` [O, 3]);
- each ear's transfer magnitudes t [L, O, M]: the FFAT lookup (ffat.py) of
  each instance's rows in its own model's maps (``maps``, one set a model,
  ``model_of`` [O]), times the model's valid modes;
- with ``itd``, the interaural delays d = (r - min over the ears of r) *
  rate / c in samples (r an ear's distance to the instance, c the speed of
  sound) and the complex rows t e^{-i theta d} (theta = arg lam, the mode's
  phase advance a sample): a delay of d samples for a narrowband mode;
  without it, the real rows t;
- the ear channels: channel l sums every instance's sound under rows l
  times the instance's gain (``gains`` [O], alike on both ears), divided by
  the output scale.

A move ramps the next block linearly from the rows in use before it, both
parts of the complex rows (sample s weighted (s + 1) / S), as replay.py
ramps real rows; before any move every ear hears the unit transfer. The
sound of a mode under a complex row w is Im(w z): for a real row the
reference's Im z.

The hits, drags and AR retunes replay as replay.py replays them: its
host pass walks the blocks, its drag profiles give the AR(2) forces, and
each block is the product of the states with the powers plus the causal
convolution of the force with G[d] = Im(sum_m w_m b_m E_m lam^d), now one
G an ear.

Where it departs from the session's description (runtime/session.py):

- the session takes the interaural distances from the rows as the device
  holds them (cast to float32) and forms the phase in float64 before a
  cast; here the rows, distances and phases are in the reference's own
  dtype throughout (float64; the control's float32);
- the session's transfer is one lookup over both ears' rows at once; here
  each model's instances are looked up apart (each row's lookup depends on
  its own row alone, so the rows are the same).
"""
from __future__ import annotations

import numpy as np
import torch

from . import ffat, modal
from .replay import _Drags, _conv, _maps_on, host_pass, tf32


def rel_err(audio: np.ndarray, ref: np.ndarray) -> float:
    """||audio - ref|| / ||ref|| over every channel: audio and ref [N, L]."""
    audio = np.asarray(audio, np.float64).reshape(ref.shape)
    norm = np.linalg.norm(ref)
    return float(np.linalg.norm(audio - ref) / norm) if norm > 0 \
        else float("inf")


def render(scene: dict, events: list, n_blocks: int, *, ar_seed: int,
           smooth: bool, dtype: torch.dtype = torch.float64,
           device="cpu", chunk: int = 64, tf32_products: bool = False
           ) -> np.ndarray:
    """The ears' channels [n_blocks * S, L] (float64 numpy) of ``events``
    replayed over the scene from silence. ``tf32_products`` (float32 only)
    rounds every matrix product's operands to TF32: the control's
    precision."""
    if tf32_products and dtype != torch.float32:
        raise ValueError("TF32 products take float32 operands")

    def mm(a, b):
        if tf32_products:
            return tf32(a.contiguous()) @ tf32(b.contiguous())
        return a @ b
    s, o_n, m = scene["block"], scene["objects"], scene["modes"]
    cplx = torch.complex128 if dtype == torch.float64 else torch.complex64
    ears = torch.as_tensor(np.asarray(scene["ears"], np.float64),
                           device=device).to(dtype)             # [L, 3]
    l_n = ears.shape[0]
    centers = torch.as_tensor(np.asarray(scene["centers"], np.float64),
                              device=device).to(dtype)          # [O, 3]
    model_of = torch.as_tensor(np.asarray(scene["model_of"]), device=device)
    gains = torch.as_tensor(np.asarray(scene["gains"], np.float64),
                            device=device).to(dtype)            # [O]
    lam, bcoef, valid = modal.coefficients(
        scene["omega_sq"], scene["density"], scene["alpha"], scene["beta"],
        scene["rate"], scene["gain"])                           # [G, M]
    pr, pi = modal.powers(lam, s + 1, dtype, device)        # [G, M, S+1]
    q_hom = torch.cat([pi[..., 1:], pr[..., 1:]], dim=1)     # [G, 2M, S]
    q_g = torch.cat([pi[..., :s], pr[..., :s]], dim=1)       # [G, 2M, S]
    rev = (pr[..., :s].flip(-1).transpose(1, 2).contiguous(),
           pi[..., :s].flip(-1).transpose(1, 2).contiguous())  # [G, S, M]
    lam_s = torch.complex(pr[..., s], pi[..., s]).to(cplx)[model_of]
    b_t = torch.as_tensor(bcoef, device=device).to(cplx)[model_of]
    mask = torch.as_tensor(valid.astype(np.float64),
                           device=device).to(dtype)[model_of]   # [O, M]
    theta = torch.as_tensor(np.angle(lam), device=device).to(
        dtype)[model_of]                                        # [O, M]
    unit = (scene["unit_transfer"] * mask).to(cplx).expand(l_n, o_n, m)
    maps = [_maps_on(mp, dtype, device) for mp in scene["maps"]]
    by_model = [(g, (model_of == g).nonzero()[:, 0])
                for g in range(len(maps))]
    blocks, heads = host_pass(scene, events, n_blocks, smooth)
    drags = _Drags(scene, ar_seed, dtype, device, mm)
    looked = {}

    def transfer(hid):                # the ears' rows [L, O, M] of head hid
        if hid == 0:
            return unit
        if hid not in looked:
            head = torch.as_tensor(np.asarray(heads[hid], np.float64),
                                   device=device).to(dtype)
            rows = head + ears[:, None, :] - centers[None]      # [L, O, 3]
            t = torch.empty((l_n, o_n, m), dtype=dtype, device=device)
            for g, sel in by_model:
                t[:, sel] = ffat.transfer(
                    rows[:, sel].reshape(-1, 3), maps[g]).reshape(
                        l_n, sel.numel(), m)
            t = t * mask
            if scene["itd"]:
                r = torch.linalg.vector_norm(rows, dim=-1)       # [L, O]
                d = ((r - r.amin(dim=0, keepdim=True))
                     * (scene["rate"] / scene["sound_speed"]))
                phase = theta * d[..., None]
                looked[hid] = torch.complex(t * torch.cos(phase),
                                            -t * torch.sin(phase))
            else:
                looked[hid] = t.to(cplx)
        return looked[hid]

    def g_rows(w, v, groups):
        """G[d] = Im(w v lam^d) summed over modes, pair by pair: w [L, P, M]
        and v [P, M] complex, each pair through its model's table ->
        [L, P, S]."""
        out = torch.empty((l_n, v.shape[0], s), dtype=dtype, device=device)
        for ch in range(l_n):
            a = w[ch] * v
            x = torch.cat([a.real, a.imag], dim=-1)              # [P, 2M]
            for g, sel in groups:
                out[ch, sel] = mm(x[sel], q_g[g])
        return out

    z = torch.zeros((o_n, m), dtype=cplx, device=device)
    ramp = torch.arange(1, s + 1, dtype=dtype, device=device) / s
    out = np.zeros((n_blocks * s, l_n))
    for c0 in range(0, n_blocks, chunk):
        c1 = min(n_blocks, c0 + chunk)
        nb = c1 - c0
        first = min(blocks[c0][2], blocks[c0][3] or blocks[c0][2])
        for hid in [h for h in looked if h < first]:
            del looked[hid]
        pairs_o, pairs_b, spaces, profs, ar_pairs, ar_at = [], [], [], [], [], []
        for j in range(nb):
            imp, drg, _, _ = blocks[c0 + j]
            for o, (rws, prof) in imp.items():
                e = np.zeros(m)
                for r in rws:
                    r = np.asarray(r, np.float64).ravel()[:m]
                    e[: r.size] += r
                pairs_o.append(o)
                pairs_b.append(j)
                spaces.append(e)
                profs.append(prof)
            for o, sp, tune, reset in drg:
                e = np.zeros(m)
                r = np.asarray(sp, np.float64).ravel()[:m]
                e[: r.size] = r
                ar_at.append(len(pairs_o))
                ar_pairs.append((c0 + j, o, tune, reset))
                pairs_o.append(o)
                pairs_b.append(j)
                spaces.append(e)
                profs.append(None)
        n_p = len(pairs_o)
        mix = torch.zeros((l_n, nb, s), dtype=dtype, device=device)
        tid = [blocks[c0 + j][2] for j in range(nb)]
        frm = [blocks[c0 + j][3] for j in range(nb)]
        w0 = torch.stack([transfer(frm[j] if frm[j] is not None else tid[j])
                          for j in range(nb)], dim=2)       # [L, O, B, M]
        xf = [j for j in range(nb) if frm[j] is not None]
        w1 = None
        if xf:
            w1 = torch.zeros_like(w0)
            for j in xf:
                w1[:, :, j] = transfer(tid[j]) - transfer(frm[j])
        if n_p:
            po = torch.as_tensor(pairs_o, device=device)
            pb = torch.as_tensor(pairs_b, device=device)
            e = torch.as_tensor(np.stack(spaces), device=device).to(dtype)
            f = torch.zeros((n_p, s), dtype=dtype, device=device)
            imp_idx = [i for i in range(n_p) if profs[i] is not None]
            if imp_idx:
                f[torch.as_tensor(imp_idx, device=device)] = torch.as_tensor(
                    np.stack([profs[i] for i in imp_idx]),
                    device=device).to(dtype)
            if ar_pairs:
                f[torch.as_tensor(ar_at, device=device)] = drags.profiles(
                    ar_pairs)
            v = b_t[po] * e.to(cplx)                               # [P, M]
            groups = [(g, (model_of[po] == g).nonzero()[:, 0])
                      for g in range(len(maps))]
            # per pair: c = sum_j F[j] lam^(S-1-j), G = Im(w b E lam^d)
            c_re = torch.empty((n_p, m), dtype=dtype, device=device)
            c_im = torch.empty_like(c_re)
            for g, sel in groups:
                c_re[sel] = mm(f[sel], rev[0][g])
                c_im[sel] = mm(f[sel], rev[1][g])
            inj = v * torch.complex(c_re, c_im).to(cplx)
            pg = gains[po][:, None]
            forced = _conv(g_rows(w0[:, po, pb], v, groups), f) * pg
            if w1 is not None:
                forced = forced + ramp * _conv(
                    g_rows(w1[:, po, pb], v, groups), f) * pg
            for ch in range(l_n):
                mix[ch].index_add_(0, pb, forced[ch])
        # the state at each block's start, then each block's free response
        zs = torch.empty((o_n, nb, m), dtype=cplx, device=device)
        for j in range(nb):
            zs[:, j] = z
            z = lam_s * z
            if n_p:
                at = (pb == j).nonzero()[:, 0]
                if at.numel():
                    z.index_add_(0, po[at], inj[at])

        def hom(w):                   # [L, O, B, M] -> [L, B, S]
            res = torch.zeros((l_n, nb, s), dtype=dtype, device=device)
            for ch in range(l_n):
                a = w[ch] * zs
                x = torch.cat([a.real, a.imag], dim=-1)          # [O, B, 2M]
                for g, sel in by_model:
                    part = mm(x[sel].reshape(-1, 2 * m), q_hom[g])
                    res[ch] += (part.reshape(sel.numel(), nb, s)
                                * gains[sel][:, None, None]).sum(dim=0)
            return res
        mix += hom(w0)
        if w1 is not None:
            mix += ramp * hom(w1)
        out[c0 * s: c1 * s] = (mix / scene["output_scale"]).to(
            torch.float64).reshape(l_n, -1).T.cpu().numpy()
    return out
