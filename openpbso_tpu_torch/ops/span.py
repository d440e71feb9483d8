"""Span integrator — N samples (many blocks) in one dispatch.

Counterpart of openpbso_tpu/ops/span.py in its chunked form, the one form
the port has. The JAX package also has factored and full forms and a
two-level superchunk scan, which measured slower on the H100 than this
flat scan (shared 256 x 1024, 512 blocks); convert.py carries its chunked
tables across as flat ones. A span of N = X * C samples is cut into X
chunks of C samples, and only the baby table lam^r, r in [0, C]
(``[Og, C+1, M]``, host float64 powers cast once) is needed:

    g_k[d]   = Im(lam^d t b e_k) . 1             d in [0, C)    per slot
    inj[x]   = sum_k b e_k sum_j lam^(C-1-j) f_k[xC + j]        per chunk
    z_{x+1}  = lam^C z_x + inj[x]                (chunk-state scan)
    hom[x]   = Im(lam^(1..C) t z_x) . 1          from each chunk's start
    sound    = hom + sum_k g_k (*) f_k           (causal, within chunks)

Each term is one hand-written kernel: the chunk-state scan
(ops/chunk_scan.py), the within-chunk Toeplitz convolution
(ops/toeplitz_conv.py), the injections (ops/span_inject.py) and g and hom
(ops/span_reduce.py), so a busy span is one span_inject, two span_reduce,
one toeplitz_conv and one chunk_scan, and a ring-down one chunk_scan and
one span_reduce.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .chunk_scan import chunk_scan
from .coeffs import ModalBank, _power_table, _to_device, round_up
from .span_inject import span_inject
from .span_reduce import span_reduce
from .toeplitz_conv import toeplitz_conv

# builds of span planes (span_planes calls), read by chip_smoke.py's gate
PLANE_BUILDS = 0

_HI_MASK = -8192    # 0xffffe000 as an int32: a float32's low 13 bits cleared


@dataclasses.dataclass(frozen=True)
class SpanPlanes:
    """The baby table laid out once for the contraction kernels' wgmma
    variants (csrc/span_reduce.cu, csrc/span_inject.cu), whose tensor cores
    read the top 19 bits of each float32: the table split by truncation is
    hi = b with its low 13 bits cleared (what the tensor cores read of b
    itself) and lo = b - hi (exact), so only lo is stored.

    ``lo_re/lo_im``: [Og, C+1, M], span_reduce's lo planes. ``bt_re/
    bt_im``: [Og, M, C], bt[og, m, j] = lam^(C-1-j)[m], span_inject's
    K-major reversed copy (wgmma takes TF32 operands K-major only), and
    ``bt_lo_re/bt_lo_im`` its lo planes."""
    lo_re: torch.Tensor
    lo_im: torch.Tensor
    bt_re: torch.Tensor
    bt_im: torch.Tensor
    bt_lo_re: torch.Tensor
    bt_lo_im: torch.Tensor


def _lo_plane(x: torch.Tensor) -> torch.Tensor:
    """x - (x with its low 13 bits cleared): exact in float32."""
    return x - (x.view(torch.int32) & _HI_MASK).view(torch.float32)


def span_planes(b_re: torch.Tensor, b_im: torch.Tensor) -> SpanPlanes:
    """The planes of a float32 baby table [Og, C+1, M], on its device: a
    layout step of plain tensor ops (an int32 view, a mask, flip,
    transpose), the same on the CPU and the card, bitwise."""
    global PLANE_BUILDS
    if b_re.dtype != torch.float32 or b_im.dtype != torch.float32:
        raise ValueError("span planes split float32 tables; got "
                         f"{b_re.dtype}, {b_im.dtype}")
    c = b_re.shape[1] - 1
    bt_re, bt_im = (b[:, :c].flip(1).transpose(1, 2).contiguous()
                    for b in (b_re, b_im))
    PLANE_BUILDS += 1
    return SpanPlanes(lo_re=_lo_plane(b_re.contiguous()),
                      lo_im=_lo_plane(b_im.contiguous()),
                      bt_re=bt_re, bt_im=bt_im, bt_lo_re=_lo_plane(bt_re),
                      bt_lo_im=_lo_plane(bt_im))


@dataclasses.dataclass(frozen=True)
class ChunkSpanTables:
    """Baby-table span form: ``b_re/b_im`` hold lam^r for r in [0, C] as
    ``[Og, C+1, M]`` (Og == 1 for shared banks); the span is ``n_chunks``
    chunks of C samples. ``planes`` (SpanPlanes or None) is the table laid
    out for the contraction kernels, made once with the session's tables
    (with_planes); without it a kernel call makes its own."""
    b_re: torch.Tensor
    b_im: torch.Tensor
    n_chunks: int
    planes: SpanPlanes | None = None

    @property
    def chunk(self) -> int:
        return self.b_re.shape[1] - 1

    @property
    def span(self) -> int:
        return self.chunk * self.n_chunks

    @property
    def shared(self) -> bool:
        return self.b_re.shape[0] == 1


def with_planes(tables: ChunkSpanTables) -> ChunkSpanTables:
    """``tables`` carrying their SpanPlanes (built here unless they already
    do; float32 tables only, the kernels' type)."""
    if tables.planes is not None or tables.b_re.dtype != torch.float32:
        return tables
    return dataclasses.replace(tables, planes=span_planes(tables.b_re,
                                                          tables.b_im))


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


def power_rows(lam: np.ndarray, exponents: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """lam^d for each d of ``exponents`` as ``[Og, len(exponents), M]`` re
    and im (``lam``: [Og, M], modes already padded), the host float64
    powers cast once: a span table's rows."""
    p = np.moveaxis(_power_table(lam, np.asarray(exponents, np.int64)),
                    -1, 1)
    return _to_device(p.real, dtype, device), _to_device(p.imag, dtype,
                                                         device)


def build_span_tables(
    lam64: np.ndarray,
    span: int,
    *,
    radix: int | None = None,
    num_modes: int | None = None,
    pad_modes_to: int = 128,
    shared: bool | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> ChunkSpanTables:
    """Span tables from the float64 eigenvalues (not the bank's float32
    cast: lam^N amplifies base rounding by N, so the float64 source is
    required). ``lam64``: [M] or [O, M] complex128, modes zero-padded to
    ``num_modes`` (or a multiple of ``pad_modes_to``). One table row serves
    every object when ``shared`` (default: all rows equal). ``radix`` is
    the chunk size C (default choose_radix). ``device`` None is the CUDA
    device (device.resolve_device)."""
    device = resolve_device(device)
    lam = np.atleast_2d(np.asarray(lam64, np.complex128))
    o, m = lam.shape
    mp = num_modes if num_modes is not None else round_up(m, pad_modes_to)
    if mp < m:
        raise ValueError(f"num_modes {mp} < actual modes {m}")
    lam = np.pad(lam, ((0, 0), (0, mp - m)))
    if shared is None:
        shared = all(np.array_equal(lam[0], lam[i]) for i in range(1, o))
    src = lam[:1] if shared else lam
    r = radix if radix is not None else choose_radix(span)
    if span % r:
        raise ValueError(f"radix {r} does not divide span {span}")
    b_re, b_im = power_rows(src, np.arange(r + 1), dtype, device)
    return ChunkSpanTables(b_re=b_re, b_im=b_im, n_chunks=span // r)


def _chunk_start_states(z_re, z_im, inj_re, inj_im,
                        tables: ChunkSpanTables):
    """Propagate z_{x+1} = lam^C z_x + inj[x] across the span's X chunks
    (inj None: ring-down) in one chunk_scan; returns (z_final_re,
    z_final_im, starts_re [O, X, M], starts_im)."""
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


def _chunk_hom(zs_re, zs_im, t_re, t_im, tables: ChunkSpanTables,
               conv=None):
    """Every chunk's homogeneous response from its start state,
    Im(lam^(1..C) t z_x) summed over modes, plus ``conv`` (the
    within-chunk convolution) where given: [O, L, X, C]. One span_reduce
    against table rows 1 .. C."""
    return span_reduce(t_re, t_im, zs_re, zs_im, tables.b_re, tables.b_im,
                       1, conv, tables.planes)


def _span_sound(parts: torch.Tensor, multi: bool) -> torch.Tensor:
    """[O, L, X, C] -> sound [O, L, N] for listener rows, else [O, N]."""
    o, nl, x, c = parts.shape
    sound = parts.reshape(o, nl, x * c)
    return sound if multi else sound[:, 0]


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
    """Integrate one span: per-chunk force injection, the chunk-state
    scan, the cross-chunk hom and the within-chunk convolution. Returns
    (z_re', z_im', sound [O, N] or [O, L, N]); ``transfer`` may carry a
    leading listener axis (the listener axis inside as in the JAX package:
    every per-object contraction batches on O).

    The excitation is the per-slot decomposition of the block-granular
    rank-1 force (ops/forces.py::force_span), so the span reproduces
    n_blocks sequential block steps (constant transfer) to float32
    reduction-order noise."""
    n = f_k.shape[-1]
    if tables.span != n:
        raise ValueError(f"span tables built for {tables.span} samples, "
                         f"got {n}")
    o, k = space_k.shape[:2]
    c, x = tables.chunk, tables.n_chunks
    b_re, b_im = tables.b_re, tables.b_im
    t_re, t_im, _ = _listener_rows(transfer, transfer_im, bank)
    be_re = bank.b_re[:, None, :] * space_k            # [O, K, M]
    be_im = bank.b_im[:, None, :] * space_k

    # short per-slot kernels g_k[d] = Im(lam^d t b e_k) . 1, d in [0, C);
    # complex transfers reshuffle the pre-products (_complex_weights,
    # formed inside span_reduce)
    g = span_reduce(t_re, t_im, be_re, be_im, b_re, b_im, 0, None,
                    tables.planes)                    # [O, L, K, C]

    # within-chunk causal conv, summed over slots
    conv = toeplitz_conv(g, f_k.reshape(o, k, x, c))   # [O, L, X, C]

    # per-chunk injections: sum_k b e_k sum_j lam^(C-1-j) f_chunk[j]
    inj_re, inj_im = span_inject(f_k, be_re, be_im, b_re, b_im,
                                 tables.planes)

    zr_f, zi_f, zs_re, zs_im = _chunk_start_states(z_re, z_im, inj_re,
                                                   inj_im, tables)
    sound = _chunk_hom(zs_re, zs_im, t_re, t_im, tables, conv)
    return zr_f, zi_f, _span_sound(sound, transfer.dim() == 3)


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
    what remains is the chunk-state scan and the hom contraction."""
    t_re, t_im, _ = _listener_rows(transfer, transfer_im, bank)
    zr_f, zi_f, zs_re, zs_im = _chunk_start_states(z_re, z_im, None, None,
                                                   tables)
    hom = _chunk_hom(zs_re, zs_im, t_re, t_im, tables)
    return zr_f, zi_f, _span_sound(hom, transfer.dim() == 3)
