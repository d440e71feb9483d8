"""Replay a recorded event list through the plain reference: the mix.

The events are what the program's session was asked to do, each at the
sample clock at which it was applied (always a block boundary):

    (clock, "hit", {obj, space, kind, width_us, amp, when})
    (clock, "listener", {rows})            rows [O, 3], object frames
    (clock, "drag", {op, obj, space})      op start / update / end
    (clock, "tune", {obj, a, sigma, mu})   an AR(2) retune
    (clock, "clear", {obj})

A listener move installs the new transfer rows; with ``smooth`` the next
block ramps each row linearly, sample s weighted (s + 1) / S, from the
rows in use before the first move not yet ramped. Before any move the
transfer is the upstream's unit transfer. The mix is every object's sound
summed and divided by the output scale.

The recurrence is evaluated in blocks of S samples: with z the state at a
block's start, P_d = lam^d and the block's rank-one excitation E F[j],

    z[s]  = P_(s+1) z + b E sum_(j<=s) P_(s-j) F[j]
    z'    = P_S z + b E sum_j P_(S-1-j) F[j]

so the sound of a block is a product of the states with the powers and a
causal convolution of F with G[d] = Im(sum_m w_m b_m E_m P_d), exact in
whatever precision ``dtype`` gives (float64: the reference; float32 with
TF32 products: the control). A CPU test holds it against the sample-by-
sample recurrence.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ar, ffat, forces, modal


def _maps_on(maps: dict, dtype, device) -> dict:
    out = {}
    for k, v in maps.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=torch.int64 if k in (
            "n_elements", "strides") else dtype)
    return out


def host_pass(scene: dict, events: list, n_blocks: int, smooth: bool):
    """Walk the blocks on the host: per block its impact pairs {obj: (rows,
    F)}, its drag pairs [(obj, space, tuning, reset)] and its transfer (id
    in use, id ramped from or None); and the listener rows of each id."""
    s = scene["block"]
    slots = forces.Slots(scene["objects"], scene["slots"], s, scene["rate"])
    evs = sorted(events, key=lambda e: e[0])
    for clock, _, _ in evs:
        if clock % s:
            raise ValueError(f"event at sample {clock} is not at a block "
                             "boundary")
    rows = [None]                      # id 0: the unit transfer
    cur, ramp_from = 0, None
    blocks = []
    i = 0
    for blk in range(n_blocks):
        start = blk * s
        while i < len(evs) and evs[i][0] <= start:
            clock, op, kw = evs[i]
            i += 1
            if op == "hit":
                slots.hit(kw["obj"], kw["space"], kw["kind"],
                          kw["width_us"], kw["amp"], kw.get("when"), clock)
            elif op == "listener":
                rows.append(np.asarray(kw["rows"], np.float64))
                if smooth and ramp_from is None:
                    ramp_from = cur
                cur = len(rows) - 1
            elif op == "drag":
                slots.drag(kw["op"], kw["obj"], kw.get("space"))
            elif op == "tune":
                slots.drag("tune", kw["obj"], a=kw["a"], sigma=kw["sigma"],
                           mu=kw["mu"])
            elif op == "clear":
                slots.clear(kw.get("obj"))
            else:
                raise ValueError(f"unknown event {op!r}")
        drags = []
        for o in np.nonzero(slots.active)[0]:
            drags.append((int(o), slots.sus_space[o], slots.ar[o],
                          bool(slots.reset[o])))
            slots.reset[o] = False
        blocks.append((slots.impacts(start), drags, cur, ramp_from))
        ramp_from = None
    return blocks, rows


class _Drags:
    """The AR(2) profiles of the drag pairs, chunk by chunk, with each
    object's history carried on the host."""

    def __init__(self, scene, ar_seed, dtype, device, mm):
        self.block, self.mm = scene["block"], mm
        self.keys = ar.object_keys(ar_seed, scene["objects"], device)
        self.hist = np.zeros((scene["objects"], 2))
        self.dtype, self.device = dtype, device
        self.tables = {}

    def _table(self, a):
        if a not in self.tables:
            g = ar.impulse(a, self.block)
            self.tables[a] = (g, torch.as_tensor(
                ar.toeplitz(g, self.block).T.copy()).to(self.device,
                                                        self.dtype))
        return self.tables[a]

    def profiles(self, pairs):
        """pairs [(block index, obj, (a, sigma, mu), reset)] in block order
        -> F [P, S] in the reference's dtype."""
        s = self.block
        objs = torch.as_tensor([p[1] for p in pairs], device=self.device)
        blks = torch.as_tensor([p[0] for p in pairs], dtype=torch.int64,
                               device=self.device)
        noise = ar.normals(self.keys[objs], blks, s).to(self.dtype)
        ln = torch.empty_like(noise)
        by_a = {}
        for i, p in enumerate(pairs):
            by_a.setdefault(p[2][0], []).append(i)
        for a, idx in by_a.items():
            sel = torch.as_tensor(idx, device=self.device)
            ln[sel] = self.mm(noise[sel], self._table(a)[1])
        tail = ln[:, -2:].to(torch.float64).cpu().numpy()
        h = np.zeros((len(pairs), 2))
        for i, (_, o, (a, sigma, mu), reset) in enumerate(pairs):
            if reset:
                self.hist[o] = 0.0
            g = self._table(a)[0]
            h[i] = self.hist[o]
            h0, h1 = self.hist[o]
            self.hist[o] = (
                sigma * tail[i, 1] + g[s] * h0 + a[1] * g[s - 1] * h1,
                sigma * tail[i, 0] + g[s - 1] * h0 + a[1] * g[s - 2] * h1)
        out = torch.empty_like(ln)
        for a, idx in by_a.items():
            g = torch.as_tensor(self._table(a)[0], device=self.device)
            sel = torch.as_tensor(idx, device=self.device)
            tune = [pairs[i][2] for i in idx]
            sigma = torch.as_tensor([t[1] for t in tune], device=self.device,
                                    dtype=torch.float64)
            mu = torch.as_tensor([t[2] for t in tune], device=self.device,
                                 dtype=torch.float64)
            hh = torch.as_tensor(h[idx], device=self.device)
            f = (mu[:, None] + sigma[:, None] * ln[sel].to(torch.float64)
                 + hh[:, :1] * g[1:s + 1] + hh[:, 1:] * (a[1] * g[:s]))
            out[sel] = f.to(self.dtype)
        return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest): what the
    tensor cores read of a float32 operand."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _conv(g: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """out[s] = sum_(j<=s) g[s-j] f[j] for rows of length S."""
    n = g.shape[-1]
    spec = torch.fft.rfft(g, n=2 * n) * torch.fft.rfft(f, n=2 * n)
    return torch.fft.irfft(spec, n=2 * n)[..., :n]


def render(scene: dict, events: list, n_blocks: int, *, ar_seed: int,
           smooth: bool, dtype: torch.dtype = torch.float64,
           device="cpu", chunk: int = 64, tf32_products: bool = False
           ) -> np.ndarray:
    """The mix [n_blocks * S] (float64 numpy) of ``events`` replayed over
    the scene from silence. ``tf32_products`` (float32 only) rounds every
    matrix product's operands to TF32: the control's precision."""
    if tf32_products and dtype != torch.float32:
        raise ValueError("TF32 products take float32 operands")

    def mm(a, b):
        if tf32_products:
            return tf32(a.contiguous()) @ tf32(b.contiguous())
        return a @ b
    s, o_n, m = scene["block"], scene["objects"], scene["modes"]
    cplx = torch.complex128 if dtype == torch.float64 else torch.complex64
    lam, bcoef, valid = modal.coefficients(
        scene["omega_sq"], scene["density"], scene["alpha"], scene["beta"],
        scene["rate"], scene["gain"])
    g_n = lam.shape[0]
    per_obj = g_n > 1
    pr, pi = modal.powers(lam, s + 1, dtype, device)        # [G, M, S+1]
    q_hom = torch.cat([pi[..., 1:], pr[..., 1:]], dim=1)     # [G, 2M, S]
    q_g = torch.cat([pi[..., :s], pr[..., :s]], dim=1)       # [G, 2M, S]
    rev = (pr[..., :s].flip(-1).transpose(1, 2).contiguous(),
           pi[..., :s].flip(-1).transpose(1, 2).contiguous())  # [G, S, M]
    lam_s = torch.complex(pr[..., s], pi[..., s]).to(cplx)    # [G, M]
    b_t = torch.as_tensor(bcoef, device=device).to(cplx)
    mask = torch.as_tensor(valid.astype(np.float64), device=device).to(dtype)
    unit = scene["unit_transfer"] * mask.expand(o_n, m)
    maps = _maps_on(scene["maps"], dtype, device)
    blocks, rows = host_pass(scene, events, n_blocks, smooth)
    drags = _Drags(scene, ar_seed, dtype, device, mm)
    looked = {}

    def transfer(tid):
        if tid == 0:
            return unit
        if tid not in looked:
            x = torch.as_tensor(rows[tid], device=device, dtype=dtype)
            looked[tid] = ffat.transfer(x, maps) * mask
        return looked[tid]

    def rows_of(idx, tbl):            # per-object tables at objects idx
        return tbl[idx] if per_obj else tbl[0]

    z = torch.zeros((o_n, m), dtype=cplx, device=device)
    ramp = torch.arange(1, s + 1, dtype=dtype, device=device) / s
    out = np.zeros(n_blocks * s)
    for c0 in range(0, n_blocks, chunk):
        c1 = min(n_blocks, c0 + chunk)
        nb = c1 - c0
        first = min(blocks[c0][2], blocks[c0][3] or blocks[c0][2])
        for tid in [t for t in looked if t < first]:
            del looked[tid]
        # this chunk's excitation pairs, in block order
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
        mix = torch.zeros((nb, s), dtype=dtype, device=device)
        tid = [blocks[c0 + j][2] for j in range(nb)]
        frm = [blocks[c0 + j][3] for j in range(nb)]
        w0 = torch.stack([transfer(frm[j] if frm[j] is not None else tid[j])
                          for j in range(nb)], dim=1)        # [O, B, M]
        xf = [j for j in range(nb) if frm[j] is not None]
        w1 = None
        if xf:
            w1 = torch.zeros_like(w0)
            for j in xf:
                w1[:, j] = transfer(tid[j]) - transfer(frm[j])
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
            v = rows_of(po, b_t) * e.to(cplx)                   # [P, M]
            # per pair: c = sum_j F[j] lam^(S-1-j), y = w b E
            c_re = torch.empty((n_p, m), dtype=dtype, device=device)
            c_im = torch.empty_like(c_re)
            y0 = w0[po, pb].to(cplx) * v
            y1 = w1[po, pb].to(cplx) * v if w1 is not None else None
            g0 = torch.empty((n_p, s), dtype=dtype, device=device)
            g1 = torch.zeros_like(g0) if w1 is not None else None
            groups = ([(int(u), (po == u).nonzero()[:, 0])
                       for u in torch.unique(po)] if per_obj
                      else [(0, torch.arange(n_p, device=device))])
            for u, sel in groups:
                c_re[sel] = mm(f[sel], rev[0][u])
                c_im[sel] = mm(f[sel], rev[1][u])
                g0[sel] = mm(torch.cat([y0[sel].real, y0[sel].imag], -1),
                             q_g[u])
                if y1 is not None:
                    g1[sel] = mm(torch.cat([y1[sel].real, y1[sel].imag], -1),
                                 q_g[u])
            inj = v * torch.complex(c_re, c_im).to(cplx)
            forced = _conv(g0, f)
            if g1 is not None:
                forced = forced + ramp * _conv(g1, f)
            mix.index_add_(0, pb, forced)
        # the state at each block's start, then each block's free response
        zs = torch.empty((o_n, nb, m), dtype=cplx, device=device)
        for j in range(nb):
            zs[:, j] = z
            z = lam_s.expand(o_n, m) * z
            if n_p:
                at = (pb == j).nonzero()[:, 0]
                if at.numel():
                    z.index_add_(0, po[at], inj[at])

        def hom(w):
            a = w.to(cplx) * zs
            x = torch.cat([a.real, a.imag], dim=-1)           # [O, B, 2M]
            if per_obj:
                return mm(x, q_hom).sum(dim=0)
            return mm(x.reshape(o_n * nb, 2 * m), q_hom[0]).reshape(
                o_n, nb, s).sum(dim=0)
        mix += hom(w0)
        if w1 is not None:
            mix += ramp * hom(w1)
        out[c0 * s: c1 * s] = (mix / scene["output_scale"]).to(
            torch.float64).reshape(-1).cpu().numpy()
    return out
