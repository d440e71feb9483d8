"""Chunked span integrator — N samples (many blocks) in one dispatch.

Counterpart of the chunked form of openpbso_tpu/ops/span.py. A span of
N = X * C samples is cut into X chunks of C samples, and only the baby
table lam^r, r in [0, C] (``[Og, C+1, M]``, host float64 powers cast once)
is needed:

    g_k[d]   = Im(lam^d t b e_k) . 1             d in [0, C)    per slot
    inj[x]   = sum_k b e_k sum_j lam^(C-1-j) f_k[xC + j]        per chunk
    z_{x+1}  = lam^C z_x + inj[x]                (chunk-state scan)
    hom[x]   = Im(lam^(1..C) t z_x) . 1          from each chunk's start
    sound    = hom + sum_k g_k (*) f_k           (causal, within chunks)

The contractions against the table are plain float32 matrix products
(``torch.matmul`` for a shared bank, batched per object otherwise). The
chunk-state scan and the within-chunk Toeplitz convolution, which the JAX
package left to XLA, are hand-written CUDA kernels (ops/chunk_scan.py,
ops/toeplitz_conv.py).

Only the chunked form is ported: the factored and full forms with their
FFT convolutions, and the superchunk tables, are not (ROADMAP.md, "Done —
the chunked span"). The single-level scan matches the superchunk
hierarchy to <= -100 dB (tests/test_span.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .chunk_scan import chunk_scan
from .coeffs import ModalBank, _power_table, _to_device, round_up
from .integrator import _complex_weights
from .toeplitz_conv import toeplitz_conv

_OTHER_FORMS = ("the factored and full span forms are not ported; the "
                "port has the chunked form only (ROADMAP.md, 'Done — the "
                "chunked span')")


@dataclasses.dataclass(frozen=True)
class ChunkSpanTables:
    """Baby-table span form: ``b_re/b_im`` hold lam^r for r in [0, C] as
    ``[Og, C+1, M]`` (Og == 1 for shared banks); the span is ``n_chunks``
    chunks of C samples."""
    b_re: torch.Tensor
    b_im: torch.Tensor
    n_chunks: int

    @property
    def chunk(self) -> int:
        return self.b_re.shape[1] - 1

    @property
    def span(self) -> int:
        return self.chunk * self.n_chunks

    @property
    def shared(self) -> bool:
        return self.b_re.shape[0] == 1


def choose_radix(span: int, target: int | None = None) -> int:
    """Largest divisor of ``span`` <= target: the chunk size C.

    The default target ``min(512, max(64, span // 8))`` is the JAX
    package's (measured there on a TPU; small chunks for one-block spans,
    512 for long ones). The Toeplitz work grows with C*N, the serial
    chunk scan with N/C."""
    if target is None:
        target = min(512, max(64, span // 8))
    for r in range(min(target, span), 0, -1):
        if span % r == 0:
            return r
    return 1


def build_span_tables(
    lam64: np.ndarray,
    span: int,
    *,
    radix: int | None = None,
    num_modes: int | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
    form: str = "auto",
) -> ChunkSpanTables:
    """Chunk tables from the float64 eigenvalues (not the bank's float32
    cast: powers amplify the base rounding). ``lam64``: [M] or [O, M]
    complex128, modes zero-padded to ``num_modes`` (or, as build_modal_bank
    pads them, a multiple of 128). One table row serves every object when
    all rows are equal. ``form``: 'auto' or 'chunked' (the same).
    ``device`` None is the CUDA device (device.resolve_device)."""
    device = resolve_device(device)
    if form not in ("auto", "chunked"):
        raise ValueError(f"span form {form!r}: {_OTHER_FORMS}")
    lam = np.atleast_2d(np.asarray(lam64, np.complex128))
    o, m = lam.shape
    mp = num_modes if num_modes is not None else round_up(m, 128)
    if mp < m:
        raise ValueError(f"num_modes {mp} < actual modes {m}")
    lam = np.pad(lam, ((0, 0), (0, mp - m)))
    shared = all(np.array_equal(lam[0], lam[i]) for i in range(1, o))
    src = lam[:1] if shared else lam
    r = radix if radix is not None else choose_radix(span)
    if span % r:
        raise ValueError(f"radix {r} does not divide span {span}")
    b = np.moveaxis(_power_table(src, r), -1, 1)          # [Og, C+1, M]
    return ChunkSpanTables(
        b_re=_to_device(np.ascontiguousarray(b.real), dtype, device),
        b_im=_to_device(np.ascontiguousarray(b.imag), dtype, device),
        n_chunks=span // r)


def _contract_xr(w: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """sum_m w[o,x,m] tbl[og,r,m] -> [o,x,r]; one matmul when shared."""
    if tbl.shape[0] == 1:
        o, x, m = w.shape
        return (w.reshape(o * x, m) @ tbl[0].T).reshape(o, x, -1)
    return torch.bmm(w, tbl.transpose(1, 2))


def _contract_xm(f: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """sum_r f[o,x,r] tbl[og,r,m] -> [o,x,m]; one matmul when shared."""
    if tbl.shape[0] == 1:
        o, x, r = f.shape
        return (f.reshape(o * x, r) @ tbl[0]).reshape(o, x, -1)
    return torch.bmm(f, tbl)


def _chunk_start_states(z_re, z_im, inj_re, inj_im,
                        tables: ChunkSpanTables):
    """z_{x+1} = lam^C z_x + inj[x] across the span's chunks (inj None:
    ring-down); returns (z_final_re, z_final_im, starts_re [O, X, M],
    starts_im)."""
    c = tables.chunk
    return chunk_scan(z_re, z_im, tables.b_re[:, c], tables.b_im[:, c],
                      tables.n_chunks, inj_re, inj_im)


def _listener_rows(transfer, transfer_im, bank: ModalBank):
    """Masked transfer rows with the listener axis inside: ([O, L, M]
    re, im or None, L); L = 1 for plain [O, M] rows. The only transpose
    of the multi-listener path (L*O*M, small)."""
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask
    if transfer.dim() == 3:
        return (tmask.transpose(0, 1),
                None if timask is None else timask.transpose(0, 1),
                transfer.shape[0])
    return (tmask[:, None], None if timask is None else timask[:, None], 1)


def _chunk_hom(zs_re, zs_im, t_re, t_im, tables: ChunkSpanTables):
    """Every chunk's homogeneous response from its start state,
    Im(lam^(1..C) t z_x) summed over modes: [O, L, X, C]."""
    o, x, m = zs_re.shape
    nl = t_re.shape[1]
    c = tables.chunk
    w_pr, w_pi = _complex_weights(
        t_re[:, :, None, :], None if t_im is None else t_im[:, :, None, :],
        zs_re[:, None], zs_im[:, None])                    # [O, L, X, M]
    hom = (_contract_xr(w_pr.reshape(o, nl * x, m), tables.b_re[:, 1:])
           + _contract_xr(w_pi.reshape(o, nl * x, m), tables.b_im[:, 1:]))
    return hom.reshape(o, nl, x, c)


def _span_sound(parts: torch.Tensor, multi: bool) -> torch.Tensor:
    """[O, L, X, C] -> sound [O, L, N] for listener rows, else [O, N]."""
    o, nl, x, c = parts.shape
    sound = parts.reshape(o, nl, x * c)
    return sound if multi else sound[:, 0]


def _integrate_span_chunked(z_re, z_im, bank, tables: ChunkSpanTables,
                            space_k, f_k, transfer, transfer_im=None):
    """Per-chunk force injection, the chunk-state scan, the cross-chunk
    hom and the within-chunk convolution. ``transfer`` may carry a leading
    listener axis ([L, O, M] -> sound [O, L, N], the listener axis inside
    as in the JAX package: every per-object contraction batches on O)."""
    o, m = z_re.shape
    k = space_k.shape[1]
    c, x = tables.chunk, tables.n_chunks
    b_re, b_im = tables.b_re, tables.b_im
    t_re, t_im, nl = _listener_rows(transfer, transfer_im, bank)
    be_re = bank.b_re[:, None, :] * space_k            # [O, K, M]
    be_im = bank.b_im[:, None, :] * space_k

    # short per-slot kernels g_k[d] = Im(lam^d t b e_k) . 1, d in [0, C);
    # complex transfers reshuffle the pre-products (_complex_weights)
    w_pr, w_pi = _complex_weights(
        t_re[:, :, None, :], None if t_im is None else t_im[:, :, None, :],
        be_re[:, None], be_im[:, None])                # [O, L, K, M]
    g = (_contract_xr(w_pr.reshape(o, nl * k, m), b_re[:, :c])
         + _contract_xr(w_pi.reshape(o, nl * k, m), b_im[:, :c]))

    # within-chunk causal conv, summed over slots
    fc = f_k.reshape(o, k, x, c)
    conv = toeplitz_conv(g.reshape(o, nl, k, c), fc)   # [O, L, X, C]

    # per-chunk modal force gathers: t_k = sum_j lam^(C-1-j) f_chunk[j]
    rows = fc.flip(-1).reshape(o, k * x, c)
    tk_re = _contract_xm(rows, b_re[:, :c]).reshape(o, k, x, m)
    tk_im = _contract_xm(rows, b_im[:, :c]).reshape(o, k, x, m)
    inj_re = (be_re[:, :, None, :] * tk_re
              - be_im[:, :, None, :] * tk_im).sum(dim=1)   # [O, X, M]
    inj_im = (be_re[:, :, None, :] * tk_im
              + be_im[:, :, None, :] * tk_re).sum(dim=1)

    zr_f, zi_f, zs_re, zs_im = _chunk_start_states(z_re, z_im, inj_re,
                                                   inj_im, tables)
    hom = _chunk_hom(zs_re, zs_im, t_re, t_im, tables)
    return zr_f, zi_f, _span_sound(hom + conv, transfer.dim() == 3)


def integrate_span(
    z_re: torch.Tensor,            # [O, M]
    z_im: torch.Tensor,            # [O, M]
    bank: ModalBank,
    tables: ChunkSpanTables,
    space_k: torch.Tensor,         # [O, K, M] per-slot modal amplitudes
    f_k: torch.Tensor,             # [O, K, N] per-slot effective profiles
    transfer: torch.Tensor,        # [(L,) O, M]
    transfer_im: torch.Tensor | None = None,
):
    """Integrate one span. Returns (z_re', z_im', sound [O, N] or
    [O, L, N]).

    The excitation is the per-slot decomposition of the block-granular
    rank-1 force (ops/forces.py::force_span), so the span reproduces
    n_blocks sequential block steps (constant transfer) to float32
    reduction-order noise."""
    n = f_k.shape[-1]
    if tables.span != n:
        raise ValueError(f"span tables built for {tables.span} samples, "
                         f"got {n}")
    return _integrate_span_chunked(z_re, z_im, bank, tables, space_k, f_k,
                                   transfer, transfer_im)


def decay_span(
    z_re: torch.Tensor,
    z_im: torch.Tensor,
    bank: ModalBank,
    tables: ChunkSpanTables,
    transfer: torch.Tensor,
    transfer_im: torch.Tensor | None = None,
):
    """Homogeneous-only span (scene ringing down, zero excitation): the
    convolution and injection terms of integrate_span vanish exactly;
    the chunk-state scan and the hom contraction remain."""
    t_re, t_im, _ = _listener_rows(transfer, transfer_im, bank)
    zr_f, zi_f, zs_re, zs_im = _chunk_start_states(z_re, z_im, None, None,
                                                   tables)
    hom = _chunk_hom(zs_re, zs_im, t_re, t_im, tables)
    return zr_f, zi_f, _span_sound(hom, transfer.dim() == 3)
