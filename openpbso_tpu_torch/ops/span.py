"""Span integrator — N samples (many blocks) in one dispatch.

Counterpart of openpbso_tpu/ops/span.py, in its three forms.

**Chunked** (``ChunkSpanTables``, the default). A span of N = X * C samples
is cut into X chunks of C samples, and only the baby table lam^r, r in
[0, C] (``[Og, C+1, M]``, host float64 powers cast once) is needed:

    g_k[d]   = Im(lam^d t b e_k) . 1             d in [0, C)    per slot
    inj[x]   = sum_k b e_k sum_j lam^(C-1-j) f_k[xC + j]        per chunk
    z_{x+1}  = lam^C z_x + inj[x]                (chunk-state scan)
    hom[x]   = Im(lam^(1..C) t z_x) . 1          from each chunk's start
    sound    = hom + sum_k g_k (*) f_k           (causal, within chunks)

Long spans (X >= 64) also carry superchunk powers lam^(dC), d in [0, G],
which split the X-step scan in two levels: a scan over the X/G group
boundaries, and each group's interior starts from matmul-shaped mixing
(shared banks) or from one more G-step scan over every group at once
(per-object banks, opt-in). Every serial pass is the recurrence
``z <- rot * z + inj`` and runs through one hand-written kernel,
ops/chunk_scan.py. The within-chunk Toeplitz convolution is another
(ops/toeplitz_conv.py), and the mode contractions two more: the
injections (ops/span_inject.py) and g and hom (ops/span_reduce.py), so a
busy span is one span_inject, two span_reduce, one toeplitz_conv and the
scan, and a ring-down the scan and one span_reduce.

**Factored** (``SpanTables``): giant steps A[x] = lam^(xR) and baby steps
B[r] = lam^r, so every per-sample power is lam^(xR) lam^r and every
per-sample quantity is a matrix product; the slot convolution is one FFT
pair over 2N. **Full** (``FullSpanTables``, shared banks only): one
[M, N+1] table of every power, three matrix-product pairs and the same
FFT convolution.

The factored and full forms' contractions are plain float32 matrix
products (``torch.matmul`` for a shared bank, batched per object
otherwise) and their convolutions ``torch.fft`` calls, library work as in
the JAX package, where XLA computes them outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from .chunk_scan import chunk_scan
from .coeffs import ModalBank, _power_table, _to_device, round_up
from .span_inject import _contract_xm, span_inject
from .span_reduce import _contract_xr, span_reduce
from .toeplitz_conv import toeplitz_conv

FULL_TABLE_PIECE = 1 << 12    # powers per host piece of the full table


@dataclasses.dataclass(frozen=True)
class SpanTables:
    """Factored lam-power tables for one span length.

    a_*: [Og, X+1, M] giant steps lam^(x*R); b_*: [Og, R+1, M] baby steps
    lam^r. Og == 1 for shared banks (every object one mode set).
    """
    a_re: torch.Tensor
    a_im: torch.Tensor
    b_re: torch.Tensor
    b_im: torch.Tensor

    @property
    def big_steps(self) -> int:
        return self.a_re.shape[1] - 1

    @property
    def radix(self) -> int:
        return self.b_re.shape[1] - 1

    @property
    def span(self) -> int:
        return self.big_steps * self.radix

    @property
    def shared(self) -> bool:
        return self.a_re.shape[0] == 1


@dataclasses.dataclass(frozen=True)
class FullSpanTables:
    """One shared [M, N+1] lam-power table (shared banks only): the whole
    span becomes three giant [O(K), M] @ [M, N] matrix products with no
    per-object intermediates."""
    p_re: torch.Tensor   # [M, N+1]
    p_im: torch.Tensor

    @property
    def span(self) -> int:
        return self.p_re.shape[-1] - 1

    @property
    def shared(self) -> bool:
        return True


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
    chunks of C samples. ``s_re/s_im`` ([Og, G+1, M], or None) hold the
    superchunk powers lam^(dC), d in [0, G], of the two-level scan.
    ``planes`` (SpanPlanes or None) is the table laid out for the
    contraction kernels, made once with the session's tables
    (with_planes); without it a kernel call makes its own."""
    b_re: torch.Tensor
    b_im: torch.Tensor
    n_chunks: int
    s_re: torch.Tensor | None = None
    s_im: torch.Tensor | None = None
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

    @property
    def superchunk(self) -> int:
        """Chunks per superchunk group (1 = plain single-level scan)."""
        return 1 if self.s_re is None else self.s_re.shape[1] - 1


def with_planes(tables: ChunkSpanTables) -> ChunkSpanTables:
    """``tables`` carrying their SpanPlanes (built here unless they already
    do; float32 tables only, the kernels' type)."""
    if tables.planes is not None or tables.b_re.dtype != torch.float32:
        return tables
    return dataclasses.replace(tables, planes=span_planes(tables.b_re,
                                                          tables.b_im))


def choose_radix(span: int, target: int | None = None) -> int:
    """Largest divisor of ``span`` <= target: the chunk size C (the baby
    table's length R in the factored form).

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


def _full_table(lam: np.ndarray, span: int, dtype: torch.dtype,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """lam^d for d in [0, span] as [M, span+1] float32 re and im, built
    on the host in pieces of powers on a thread pool (numpy releases the
    GIL): each entry is computed alone, so the values are those of one
    ``_power_table(lam, span)`` call, bitwise, without its complex128
    [M, N+1] intermediates."""
    m = lam.shape[0]
    host = {part: torch.empty((m, span + 1), dtype=dtype)
            for part in ("re", "im")}

    def piece(lo: int) -> None:
        hi = min(lo + FULL_TABLE_PIECE, span + 1)
        p = _power_table(lam, np.arange(lo, hi, dtype=np.int64))
        host["re"][:, lo:hi] = torch.from_numpy(
            np.ascontiguousarray(p.real)).to(dtype)
        host["im"][:, lo:hi] = torch.from_numpy(
            np.ascontiguousarray(p.imag)).to(dtype)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(piece, range(0, span + 1, FULL_TABLE_PIECE)))
    return host["re"].to(device), host["im"].to(device)


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
    form: str = "auto",
    hetero_superchunk: bool = False,
):
    """Span tables from the float64 eigenvalues (not the bank's float32
    cast: lam^N amplifies base rounding by N, so the float64 source is
    required). ``lam64``: [M] or [O, M] complex128, modes zero-padded to
    ``num_modes`` (or a multiple of ``pad_modes_to``). One table row serves
    every object when ``shared`` (default: all rows equal).

    ``form``: 'chunked' (ChunkSpanTables, with superchunk powers on spans
    of 64 or more chunks), 'factored' (SpanTables), 'full' (FullSpanTables,
    shared banks only), or 'auto' (= chunked). ``radix`` is the chunk size
    in the chunked form and the baby-table length in the factored one; the
    full form needs neither. ``hetero_superchunk`` gives per-object banks
    superchunk powers too. ``device`` None is the CUDA device
    (device.resolve_device)."""
    device = resolve_device(device)
    if form not in ("auto", "chunked", "factored", "full"):
        raise ValueError(f"unknown span form {form!r}: 'auto', 'chunked', "
                         "'factored' or 'full'")
    lam = np.atleast_2d(np.asarray(lam64, np.complex128))
    o, m = lam.shape
    mp = num_modes if num_modes is not None else round_up(m, pad_modes_to)
    if mp < m:
        raise ValueError(f"num_modes {mp} < actual modes {m}")
    lam = np.pad(lam, ((0, 0), (0, mp - m)))
    if shared is None:
        shared = all(np.array_equal(lam[0], lam[i]) for i in range(1, o))
    src = lam[:1] if shared else lam
    if form == "auto":
        form = "chunked"
    if form == "full":
        if not shared:
            raise ValueError("full span tables need a shared bank "
                             "([O, M, N] would defeat the purpose)")
        p_re, p_im = _full_table(src[0], span, dtype, device)
        return FullSpanTables(p_re=p_re, p_im=p_im)
    r = radix if radix is not None else choose_radix(span)
    if span % r:
        raise ValueError(f"radix {r} does not divide span {span}")
    x = span // r
    b_re, b_im = power_rows(src, np.arange(r + 1), dtype, device)
    if form == "chunked":
        # superchunk group G: the largest divisor of X up to 32 once
        # X >= 64, for shared banks and per-object banks that opt in
        g_cap = 32 if (shared or hetero_superchunk) else 1
        g = 1
        if x >= 64:
            g = next(c for c in range(min(g_cap, x), 0, -1) if x % c == 0)
        s_re = s_im = None
        if g > 1:
            s_re, s_im = power_rows(src, np.arange(g + 1) * r, dtype, device)
        return ChunkSpanTables(b_re=b_re, b_im=b_im, n_chunks=x,
                               s_re=s_re, s_im=s_im)
    a_re, a_im = power_rows(src, np.arange(x + 1) * r, dtype, device)
    return SpanTables(a_re=a_re, a_im=a_im, b_re=b_re, b_im=b_im)


def _slot_conv_fft(g: torch.Tensor, f_k: torch.Tensor, n: int) -> torch.Tensor:
    """sum_k causal_conv(g[:, k], f_k[:, k]) via one padded FFT triple
    (conv is linear, so the slot sum happens in the frequency domain).
    Shared by the factored and full span forms."""
    nf = 2 * n
    conv_f = (torch.fft.rfft(g, n=nf, dim=-1)
              * torch.fft.rfft(f_k, n=nf, dim=-1)).sum(dim=1)
    return torch.fft.irfft(conv_f, n=nf, dim=-1)[..., :n].to(g.dtype)


def _rotate(pn_re, pn_im, z_re, z_im):
    """(pn_re + i pn_im) * (z_re + i z_im)."""
    return pn_re * z_re - pn_im * z_im, pn_im * z_re + pn_re * z_im


def _chunk_start_states(z_re, z_im, inj_re, inj_im,
                        tables: ChunkSpanTables):
    """Propagate z_{x+1} = lam^C z_x + inj[x] across the span's X chunks
    (inj None: ring-down); returns (z_final_re, z_final_im, starts_re
    [O, X, M], starts_im).

    Single-level: one X-step chunk_scan. Two-level (the tables carry
    superchunk powers lam^(dC), d in [0, G]): group G chunks, scan only the
    X/G group boundaries, and produce each group's interior starts —

        Z_{q+1}   = lam^(GC) Z_q + sum_j lam^((G-1-j)C) inj[qG + j]
        z_{qG+j}  = lam^(jC) Z_q + sum_{i<j} lam^((j-1-i)C) inj[qG + i]

    For a shared bank the group injections and the interior mixing are
    contractions against the superchunk powers. For a per-object bank
    three scans run instead (the [O, G, G, M] mixing tables would cost
    more than the scan): pass A aggregates each group's injections with a
    G-step scan over every group at once, the group scan carries the
    boundaries, and pass C re-runs each group from its start state and
    emits the interior starts. Each scan is one chunk_scan launch over
    rows of [O * X/G, M] states."""
    o, m = z_re.shape
    x = tables.n_chunks
    b_re, b_im = tables.b_re, tables.b_im
    c = tables.chunk
    g = tables.superchunk
    decay = inj_re is None
    if g <= 1 or x % g:
        return chunk_scan(z_re, z_im, b_re[:, c], b_im[:, c], x,
                          inj_re, inj_im)

    s_re, s_im = tables.s_re, tables.s_im              # [Og, G+1, M]
    xg = x // g
    if not decay and tables.shared:
        ir = inj_re.reshape(o, xg, g, m)
        ii = inj_im.reshape(o, xg, g, m)
        # group injection: INJ_q = sum_j lam^((G-1-j)C) inj[q, j]
        wfr = s_re[0, :g].flip(0)                      # [G, M]
        wfi = s_im[0, :g].flip(0)

        def gsum(a, w):
            return torch.einsum("oxjm,jm->oxm", a, w)
        inj_g_re = gsum(ir, wfr) - gsum(ii, wfi)
        inj_g_im = gsum(ir, wfi) + gsum(ii, wfr)
    elif not decay:
        # pass A: within-group aggregation from zero, every group a row
        pc_re = b_re[:, c].repeat_interleave(xg, dim=0)    # [O*XG, M]
        pc_im = b_im[:, c].repeat_interleave(xg, dim=0)
        rows_re = inj_re.reshape(o * xg, g, m)
        rows_im = inj_im.reshape(o * xg, g, m)
        zero = torch.zeros((o * xg, m), dtype=z_re.dtype, device=z_re.device)
        inj_g_re, inj_g_im, _, _ = chunk_scan(zero, zero, pc_re, pc_im, g,
                                              rows_re, rows_im)
        inj_g_re = inj_g_re.reshape(o, xg, m)
        inj_g_im = inj_g_im.reshape(o, xg, m)
    zr_f, zi_f, zg_re, zg_im = chunk_scan(
        z_re, z_im, s_re[:, g], s_im[:, g], xg,
        None if decay else inj_g_re, None if decay else inj_g_im)

    if not decay and not tables.shared:
        # pass C: every group's interior starts from its start state
        _, _, zs_re, zs_im = chunk_scan(
            zg_re.reshape(o * xg, m), zg_im.reshape(o * xg, m),
            pc_re, pc_im, g, rows_re, rows_im)
        return zr_f, zi_f, zs_re.reshape(o, x, m), zs_im.reshape(o, x, m)

    # interior starts: lam^(jC) Z_q (carry term) + within-group mixing
    car_re, car_im = _rotate(s_re[:, None, :g, :], s_im[:, None, :g, :],
                             zg_re[:, :, None, :], zg_im[:, :, None, :])
    if decay:
        return (zr_f, zi_f, car_re.reshape(o, x, m),
                car_im.reshape(o, x, m))
    # T2[j, i] = lam^((j-1-i)C) for i < j, 0 otherwise (a zero row ahead
    # of the powers makes the clipped gather self-masking)
    zero_row = torch.zeros_like(s_re[0, :1])
    gp2_re = torch.cat([zero_row, s_re[0]], dim=0)     # [G+2, M]
    gp2_im = torch.cat([zero_row, s_im[0]], dim=0)
    delta = np.arange(g)[:, None] - np.arange(g)[None, :]   # j - i
    didx = torch.as_tensor(delta.clip(0), device=z_re.device)
    t2_re, t2_im = gp2_re[didx], gp2_im[didx]          # [G(j), G(i), M]

    def mix(a, t):
        return torch.einsum("oxim,jim->oxjm", a, t)
    mix_re = mix(ir, t2_re) - mix(ii, t2_im)
    mix_im = mix(ir, t2_im) + mix(ii, t2_re)
    return (zr_f, zi_f, (car_re + mix_re).reshape(o, x, m),
            (car_im + mix_im).reshape(o, x, m))


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


def _integrate_span_chunked(z_re, z_im, bank, tables: ChunkSpanTables,
                            space_k, f_k, transfer, transfer_im=None):
    """Per-chunk force injection, the chunk-state scan, the cross-chunk
    hom and the within-chunk convolution. ``transfer`` may carry a leading
    listener axis ([L, O, M] -> sound [O, L, N], the listener axis inside
    as in the JAX package: every per-object contraction batches on O)."""
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


def _integrate_span_factored(z_re, z_im, bank, tables: SpanTables, space_k,
                             f_k, transfer):
    """Giant/baby factorization: hom, the per-slot responses and the state
    injection are matrix products against A[x] B[r]; the slot convolution
    is one FFT pair over 2N."""
    o, m = z_re.shape
    k = space_k.shape[1]
    n = f_k.shape[-1]
    x, r = tables.big_steps, tables.radix
    a_re, a_im = tables.a_re, tables.a_im
    b_re, b_im = tables.b_re, tables.b_im
    tmask = transfer * bank.mask
    tz_re = (tmask * z_re)[:, None, :]
    tz_im = (tmask * z_im)[:, None, :]
    axr, axi = a_re[:, :x], a_im[:, :x]        # giant rows 0..X-1

    # hom[n = x*R + rr] = Im(A[x] B[rr+1] z) . t  for rr in [0, R)
    wh_re, wh_im = _rotate(axr, axi, tz_re, tz_im)     # [O, X, M]
    hom = (_contract_xr(wh_re, b_im[:, 1:])
           + _contract_xr(wh_im, b_re[:, 1:])).reshape(o, n)

    # per-slot forced response: g_k[d = x*R + r] = Im(A[x] B[r] b e_k) . t
    be_re = bank.b_re[:, None, :] * space_k    # [O, K, M]
    be_im = bank.b_im[:, None, :] * space_k
    tb_re = tmask[:, None, None, :] * be_re[:, :, None, :]   # [O, K, 1, M]
    tb_im = tmask[:, None, None, :] * be_im[:, :, None, :]
    wg_re, wg_im = _rotate(axr[:, None], axi[:, None], tb_re, tb_im)
    g = (_contract_xr(wg_re.reshape(o, k * x, m), b_im[:, :r])
         + _contract_xr(wg_im.reshape(o, k * x, m), b_re[:, :r])
         ).reshape(o, k, n)

    sound = hom + _slot_conv_fft(g, f_k, n)

    # state injection per slot: F_k,m = sum_d lam^d f_k_rev[d], d = x*R + rr
    f_rev = f_k.flip(-1).reshape(o, k * x, r)
    t_re = _contract_xm(f_rev, b_re[:, :r]).reshape(o, k, x, m)
    t_im = _contract_xm(f_rev, b_im[:, :r]).reshape(o, k, x, m)
    fk_re = (axr[:, None] * t_re - axi[:, None] * t_im).sum(dim=2)
    fk_im = (axi[:, None] * t_re + axr[:, None] * t_im).sum(dim=2)
    inj_re = (be_re * fk_re - be_im * fk_im).sum(dim=1)   # [O, M]
    inj_im = (be_re * fk_im + be_im * fk_re).sum(dim=1)

    zr, zi = _rotate(a_re[:, x], a_im[:, x], z_re, z_im)   # lam^N z
    return zr + inj_re, zi + inj_im, sound


def _integrate_span_full(z_re, z_im, bank, tables: FullSpanTables,
                         space_k, f_k, transfer):
    """Shared-bank span via the full [M, N+1] power table: three giant
    matrix-product pairs, no per-object tables, no row intermediates."""
    o, m = z_re.shape
    k = space_k.shape[1]
    n = f_k.shape[-1]
    p_re, p_im = tables.p_re, tables.p_im          # [M, N+1]
    tmask = transfer * bank.mask

    # hom[o, s] = Im(P_{s+1} z) . t
    hom = (tmask * z_im) @ p_re[:, 1:] + (tmask * z_re) @ p_im[:, 1:]

    # per-slot g_k[d] = Im(P_d b e_k) . t
    be_re = bank.b_re[:, None, :] * space_k        # [O, K, M]
    be_im = bank.b_im[:, None, :] * space_k
    tb_re = (tmask[:, None, :] * be_re).reshape(o * k, m)
    tb_im = (tmask[:, None, :] * be_im).reshape(o * k, m)
    g = (tb_re @ p_im[:, :n] + tb_im @ p_re[:, :n]).reshape(o, k, n)

    sound = hom + _slot_conv_fft(g, f_k, n)

    # state injection: F_k,m = sum_d P_d f_k_rev[d]
    f_rev = f_k.flip(-1).reshape(o * k, n)
    fk_re = (f_rev @ p_re[:, :n].T).reshape(o, k, m)
    fk_im = (f_rev @ p_im[:, :n].T).reshape(o, k, m)
    inj_re = (be_re * fk_re - be_im * fk_im).sum(dim=1)
    inj_im = (be_re * fk_im + be_im * fk_re).sum(dim=1)

    zr, zi = _rotate(p_re[:, n], p_im[:, n], z_re, z_im)   # lam^N z
    return zr + inj_re, zi + inj_im, sound


def _check_rows(tables, transfer, transfer_im) -> None:
    """The factored and full forms take one real [O, M] transfer row."""
    if isinstance(tables, ChunkSpanTables):
        return
    if transfer_im is not None:
        raise ValueError("complex transfer rows need the chunked span "
                         "form (build_span_tables form='chunked')")
    if transfer.dim() == 3:
        raise ValueError("multi-listener transfer rows need the chunked "
                         "span form (build_span_tables form='chunked')")


def integrate_span(
    z_re: torch.Tensor,            # [O, M]
    z_im: torch.Tensor,            # [O, M]
    bank: ModalBank,
    tables: ChunkSpanTables | SpanTables | FullSpanTables,
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
    reduction-order noise. Listener and complex rows need the chunked
    form."""
    n = f_k.shape[-1]
    if tables.span != n:
        raise ValueError(f"span tables built for {tables.span} samples, "
                         f"got {n}")
    _check_rows(tables, transfer, transfer_im)
    if isinstance(tables, ChunkSpanTables):
        return _integrate_span_chunked(z_re, z_im, bank, tables, space_k,
                                       f_k, transfer, transfer_im)
    if isinstance(tables, FullSpanTables):
        return _integrate_span_full(z_re, z_im, bank, tables, space_k, f_k,
                                    transfer)
    return _integrate_span_factored(z_re, z_im, bank, tables, space_k, f_k,
                                    transfer)


def decay_span(
    z_re: torch.Tensor,
    z_im: torch.Tensor,
    bank: ModalBank,
    tables: ChunkSpanTables | SpanTables | FullSpanTables,
    transfer: torch.Tensor,
    transfer_im: torch.Tensor | None = None,
):
    """Homogeneous-only span (scene ringing down, zero excitation): the
    convolution and injection terms of integrate_span vanish exactly;
    what remains is the hom contraction and the state's advance by the
    span (the chunk-state scan, or the rotation by lam^N)."""
    _check_rows(tables, transfer, transfer_im)
    if isinstance(tables, ChunkSpanTables):
        t_re, t_im, _ = _listener_rows(transfer, transfer_im, bank)
        zr_f, zi_f, zs_re, zs_im = _chunk_start_states(z_re, z_im, None,
                                                       None, tables)
        hom = _chunk_hom(zs_re, zs_im, t_re, t_im, tables)
        return zr_f, zi_f, _span_sound(hom, transfer.dim() == 3)
    o, m = z_re.shape
    n = tables.span
    tmask = transfer * bank.mask
    if isinstance(tables, FullSpanTables):
        p_re, p_im = tables.p_re, tables.p_im
        sound = (tmask * z_im) @ p_re[:, 1:] + (tmask * z_re) @ p_im[:, 1:]
        return (*_rotate(p_re[:, n], p_im[:, n], z_re, z_im), sound)
    x = tables.big_steps
    a_re, a_im = tables.a_re, tables.a_im
    wh_re, wh_im = _rotate(a_re[:, :x], a_im[:, :x],
                           (tmask * z_re)[:, None, :],
                           (tmask * z_im)[:, None, :])
    sound = (_contract_xr(wh_re, tables.b_im[:, 1:])
             + _contract_xr(wh_im, tables.b_re[:, 1:])).reshape(o, n)
    return (*_rotate(a_re[:, x], a_im[:, x], z_re, z_im), sound)
