"""Chunk-injection GEMM of the chunked span: CUDA kernel + plain twin.

Counterpart of the per-chunk modal force gathers and injection sums of
openpbso_tpu/ops/span.py::_integrate_span_chunked (the Pallas kernel's
body contraction s_re/s_im and its products with b e,
openpbso_tpu/ops/pallas_integrator.py:98-101): per object o, chunk x of C
samples and mode m,

    inj[o, x, m] = sum_k be_k[o, m] sum_j lam^(C-1-j)[m] f[o, k, x C + j]

(complex), with lam^r the rows of the span's baby table. On CUDA tensors
``span_inject`` launches a hand-written kernel (csrc/span_inject.cu) that
runs the product on the tensor cores with the 3xTF32 split (held to <=
-110 dB against the twin), reads the table rows in reverse instead of
flipping f, and forms the complex sum over slots in registers, so no
[O, K, X, M] tensor exists; on CPU tensors it runs
``span_inject_reference``, the stage code it replaces, which is also what
the kernel is held against on the card. The kernel source holds three
designs; ``variant_for`` picks one from the shape alone: for per-object
tables of few short chunks and more than one slot (the live stream's
one- and four-block spans), ``stacked``, an object's (slot, chunk) pairs
stacked as the GEMM's rows and the sum over slots taken in registers; the
TMA and wgmma pipeline (reading the table's reversed K-major planes,
ops/span.py::span_planes) where a table's chunks fill 128-row tiles that
fill the card; and the cp.async and mma.sync one (the table read in
reverse and split in registers) for the rest: per-object tables of one
slot, where the table's bytes bound the call, and calls too small to fill
the card.
"""
from __future__ import annotations

import torch

MAX_BLOCKS = 2**31 - 1    # one grid dimension
SMS = 132                 # streaming multiprocessors of an H100
# the kernel's variants, by their number in its C interface
VARIANTS = ("mma16", "mma64", "wgmma", "stacked")
# the stacked variant's most chunks an object (X): the session's spans
# of chunks of at most 256 samples have 8 (ops/span.py::choose_radix)
STACKED_CHUNKS = 8
# the shapes variant_for sends to the stacked variant, by A/B against
# mma16 (PERF.md): per-object tables of at least this many slots and
# chunks of at most this many samples (the one- and four-block spans: X =
# 8, K = 17, C = 64 and 256; at K = 2 mma16 measured faster)
STACKED_ROUTE = (3, 256)
# k8 steps between restarts of the wgmma variant's products (the tensor
# cores' float32 accumulation truncates): at C = 512, 16 measured -119.7
# dB against the twin, 32 -115.6 and 64 (no restart) -111.3, at the -110
# dB bar (PERF.md); 16 keeps a margin for other data
RESTART_K8 = 16

# launches of the card's kernel (one per call)
LAUNCHES = 0


def variant_for(o: int, k: int, x: int, c: int, m: int, og: int) -> str:
    """The kernel variant for a call's shape, by the shape alone: stacked
    for per-object tables of few short chunks and three slots or more
    (STACKED_ROUTE: the one- and four-block spans); wgmma where one
    table's injection rows (all O X of a shared table, X of a per-object
    one) fill 128-row tiles, those tiles fill the card and the TMA can
    stride the chunk rows (4 | C); else mma (per-object tables with few
    chunks and slots, bound by reading them, and calls too small to fill
    the card), 64 rows a block where that fills two blocks on each SM,
    else 16."""
    shared = og == 1
    least, most_c = STACKED_ROUTE
    if not shared and k >= least and x <= STACKED_CHUNKS and c <= most_c:
        return "stacked"
    rows = x * (o if shared else 1)
    groups = 1 if shared else o
    m_tiles = -(-m // 64)
    if c % 4 == 0 and rows >= 128 and (
            groups * -(-rows // 128) * m_tiles >= SMS):
        return "wgmma"
    big = -(-rows // 64)
    return ("mma16" if rows <= 16 or big * groups * m_tiles < 2 * SMS
            else "mma64")


def _contract_xm(f: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """sum_r f[o,x,r] tbl[og,r,m] -> [o,x,m]; one matmul when shared."""
    if tbl.shape[0] == 1:
        o, x, r = f.shape
        return (f.reshape(o * x, r) @ tbl[0]).reshape(o, x, -1)
    return torch.bmm(f, tbl)


def span_inject_reference(f_k, be_re, be_im, b_re, b_im):
    """The flipped chunk rows, two matrix products against the table's
    first C rows and the complex sum over slots: f_k [O, K, N], be [O, K,
    M], table [Og, C+1, M] -> (inj_re, inj_im) [O, N/C, M]."""
    o, k, n = f_k.shape
    c = b_re.shape[1] - 1
    x, m = n // c, b_re.shape[-1]
    rows = f_k.reshape(o, k, x, c).flip(-1).reshape(o, k * x, c)
    tk_re = _contract_xm(rows, b_re[:, :c]).reshape(o, k, x, m)
    tk_im = _contract_xm(rows, b_im[:, :c]).reshape(o, k, x, m)
    inj_re = (be_re[:, :, None, :] * tk_re
              - be_im[:, :, None, :] * tk_im).sum(dim=1)   # [O, X, M]
    inj_im = (be_re[:, :, None, :] * tk_im
              + be_im[:, :, None, :] * tk_re).sum(dim=1)
    return inj_re, inj_im


def _launch(f_k, be_re, be_im, b_re, b_im, planes, variant):
    from . import _build
    o, k, n = f_k.shape
    c = b_re.shape[1] - 1
    x, m = n // c, b_re.shape[-1]
    for t in (f_k, be_re, be_im, b_re, b_im):
        if t.device != f_k.device or t.dtype != torch.float32:
            raise ValueError("span_inject takes float32 tensors on one CUDA "
                             f"device; got {t.dtype} on {t.device}")
    if min(o, x, c, m) < 1:
        raise ValueError(f"span_inject needs O, X, C, M >= 1; got f "
                         f"{tuple(f_k.shape)}, table {tuple(b_re.shape)}")
    if variant == "stacked" and x > STACKED_CHUNKS:
        raise ValueError(f"span_inject (stacked) takes at most "
                         f"{STACKED_CHUNKS} chunks an object; got X = {x}")
    lib = _build.load()
    stride = 0 if b_re.shape[0] == 1 else (c + 1) * m
    index = VARIANTS.index(variant)
    if o * x > MAX_BLOCKS or lib.span_inject_blocks(
            o, x, m, stride, index) > MAX_BLOCKS:
        raise ValueError(f"{o} objects x {x} chunks x {m} modes exceed "
                         "the kernel's grid")
    f_k, be_re, be_im, b_re, b_im = (t.contiguous() for t in (
        f_k, be_re, be_im, b_re, b_im))
    bt = [None] * 4
    if variant == "wgmma":
        if planes is None:
            from .span import span_planes
            planes = span_planes(b_re, b_im)
        bt = [planes.bt_re, planes.bt_im, planes.bt_lo_re, planes.bt_lo_im]
        want = (b_re.shape[0], m, c)
        for p in bt:
            if (p.shape != want or p.device != f_k.device
                    or p.dtype != torch.float32 or not p.is_contiguous()):
                raise ValueError(f"span_inject: plane {tuple(p.shape)} on "
                                 f"{p.device} is not the table's reversed "
                                 f"layout {want}")
        # the TMA reads from 16-byte aligned bases
        if any(t.data_ptr() % 16 for t in [f_k] + bt):
            raise ValueError(f"span_inject ({variant}) needs f and the "
                             "planes 16-byte aligned (the TMA's bases)")
    inj_re = torch.empty((o, x, m), dtype=torch.float32, device=f_k.device)
    inj_im = torch.empty_like(inj_re)
    # 16-byte copies need rows of whole float4s on 16-byte boundaries (the
    # stacked variant copies be too)
    copied = [f_k, b_re, b_im] + ([be_re, be_im] if variant == "stacked"
                                  else [])
    vec4 = int(c % 4 == 0 and m % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in copied))
    pairs = int(m % 2 == 0)
    with _build.device_guard(f_k):
        err = lib.span_inject(
            f_k.data_ptr(), be_re.data_ptr(), be_im.data_ptr(),
            b_re.data_ptr(), b_im.data_ptr(),
            *(None if p is None else p.data_ptr() for p in bt), stride,
            inj_re.data_ptr(), inj_im.data_ptr(), o, k, x, c, m, vec4, pairs,
            index, RESTART_K8, _build.launch_stream(f_k))
    _build.check(err, f"span_inject ({variant})")
    return inj_re, inj_im


def span_inject(f_k: torch.Tensor,     # [O, K, N] per-slot profiles
                be_re: torch.Tensor,   # [O, K, M] b e_k
                be_im: torch.Tensor,
                b_re: torch.Tensor,    # [Og, C+1, M] baby table lam^r
                b_im: torch.Tensor,
                planes=None):          # ops/span.py::SpanPlanes
    """Every chunk's state injection, summed over slots -> (inj_re,
    inj_im) [O, N/C, M]. CUDA tensors launch the kernel's variant for the
    shape (variant_for; a failed build or launch raises), its wgmma
    variant reading ``planes``, made for this call when not given; CPU
    tensors run the plain twin."""
    global LAUNCHES
    dtypes = [t.dtype for t in (f_k, be_re, be_im, b_re, b_im)]
    if not f_k.dtype.is_floating_point or len(set(dtypes)) > 1:
        raise ValueError("span_inject takes tensors of one floating dtype; "
                         f"got {dtypes}")
    o, k, n = f_k.shape
    og, rows, m = b_re.shape
    c = rows - 1
    if (c < 1 or k < 1 or n % c or be_re.shape != (o, k, m)
            or be_im.shape != be_re.shape or b_im.shape != b_re.shape
            or og not in (1, o)):
        raise ValueError(
            f"shape mismatch: f {tuple(f_k.shape)} [O, K >= 1, X*C], be "
            f"{tuple(be_re.shape)} [O, K, M], table {tuple(b_re.shape)} "
            "[Og, C+1, M]")
    if f_k.is_cuda:
        out = _launch(f_k, be_re, be_im, b_re, b_im, planes,
                      variant_for(o, k, n // c, c, m, og))
        LAUNCHES += 1
        return out
    if f_k.device.type == "cpu":
        return span_inject_reference(f_k, be_re, be_im, b_re, b_im)
    raise ValueError(f"no span_inject kernel for device {f_k.device}")
