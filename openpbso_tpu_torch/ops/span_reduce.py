"""Mode-reduce GEMM of the chunked span: CUDA kernel + plain twin.

Counterpart of the two contractions over modes in
openpbso_tpu/ops/span.py::_integrate_span_chunked, the per-slot kernels
``g`` and the cross-chunk ``hom`` (the Pallas kernel's body contractions G
and hom, openpbso_tpu/ops/pallas_integrator.py:86-88 and :94-96): per
object o, listener row l, row r and column c,

    out[o, l, r, c] = sum_m w_pr[o,l,r,m] b_re[og, off+c, m]
                          + w_pi[o,l,r,m] b_im[og, off+c, m]  (+ add)
    (w_pr, w_pi) = _complex_weights(t[o, l, m], v[o, r, m])

with ``v`` the chunk start states (hom: off 1, add the within-chunk
convolution) or the slots' modal amplitudes (g: off 0). On CUDA tensors
``span_reduce`` launches a hand-written kernel (csrc/span_reduce.cu) that
forms the weights in registers, runs the product on the tensor cores with
the 3xTF32 split (held to <= -110 dB against the twin) and adds ``add`` as
it writes ``out``; on CPU tensors it runs ``span_reduce_reference``, the
stage code it replaces, which is also what the kernel is held against on
the card. The kernel source holds four designs; ``variant_for`` picks
one from the shape alone: the TMA and wgmma pipeline (reading the table's
lo planes, ops/span.py::span_planes) where a table's rows fill 128-row
tiles that fill the card; for per-object g, bound by reading its tables,
a float32 stream on the CUDA cores at a few rows and ``split`` at a full
slot bucket on short chunks (the live stream's one- and four-block spans:
the table's rows as the GEMM's A, read once, the modes split over
warps); for a shared table's few rows, ``cluster``: the mma
design's tiles with the modes split over a thread-block cluster,
producer warps streaming the rows and forming the weights beside
consumer warps on the tensor cores, the partial tiles summed in rank
order through distributed shared memory; and the cp.async and mma.sync
one (the table split in registers) for the rest.
"""
from __future__ import annotations

import torch

from .integrator import _complex_weights

MAX_BLOCKS = 2**31 - 1    # one grid dimension
SMS = 132                 # streaming multiprocessors of an H100
# the kernel's variants, by their number in its C interface
VARIANTS = ("mma16", "mma64", "wgmma", "fp32", "split", "cluster")
FP32_ROWS = 4             # the fp32 variant's most rows an object (L R)
SPLIT_ROWS = 32           # the split variant's most rows an object (L R)
# the shapes variant_for sends to the split variant, by A/B against mma16
# and fp32 (PERF.md): per-object tables of at least this many rows
# an object (fewer take fp32) and at most this many columns (the one- and
# four-block spans' g, 17 rows, and hom, 8; C = 64 and 256; at C = 512
# mma16 measured level)
SPLIT_ROUTE = (FP32_ROWS + 1, 256)
# the shapes variant_for sends to the cluster variant, by A/B against
# mma16, mma64 and wgmma (PERF.md): a shared table's calls of at most
# this many rows (O L R) times 128-column tiles: g of one slot with one
# or two listener rows at C <= 512 (up to 512 x 4) and hom of 8 chunks at
# C <= 256 (2048 x 2); a full bucket's 4352-8704 rows stay with mma16,
# mma64 or wgmma, where cluster measured slower
CLUSTER_ROUTE = 4096
# k8 steps between restarts of the wgmma variant's products (the tensor
# cores' float32 accumulation truncates): at hom's depth 2M = 2048, 16
# measured -118.7 dB against the twin, 32 -114.0 and 64 -108.5, past the
# -110 dB bar (PERF.md); 16 keeps a margin for other data
RESTART_K8 = 16

# launches of the card's kernel (one per call)
LAUNCHES = 0


def variant_for(o: int, nl: int, r: int, c: int, m: int, og: int) -> str:
    """The kernel variant for a call's shape, by the shape alone: wgmma
    where one table's rows (all O R of a shared table, R of a per-object
    one) fill 128-row tiles, those tiles fill the card and the TMA can
    stride the modes (4 | M); cluster for a shared table's calls within
    CLUSTER_ROUTE (g of one slot, hom on short chunks); for per-object
    tables, which stream their
    tables and are bound by those bytes, fp32 at most FP32_ROWS rows an
    object (g of a few slots) and split within SPLIT_ROUTE (g of a full
    bucket and hom on short chunks); else mma (calls too small to fill
    the card), 64 rows a block where that fills two blocks on each SM,
    else 16."""
    shared = og == 1
    rows = r * (o if shared else 1)
    groups = 1 if shared else o
    c_tiles = -(-c // 128)
    if m % 4 == 0 and rows >= 128 and (
            nl * groups * -(-rows // 128) * c_tiles >= SMS):
        return "wgmma"
    if shared and nl * rows * c_tiles <= CLUSTER_ROUTE:
        return "cluster"
    if not shared and m % 4 == 0 and nl * r <= FP32_ROWS:
        return "fp32"
    if (not shared and SPLIT_ROUTE[0] <= nl * r <= SPLIT_ROWS
            and c <= SPLIT_ROUTE[1]):
        return "split"
    rows *= nl
    big = -(-rows // 64)
    return ("mma16" if rows <= 32 or big * groups * c_tiles < 2 * SMS
            else "mma64")


def _contract_xr(w: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """sum_m w[o,x,m] tbl[og,r,m] -> [o,x,r]; one matmul when shared."""
    if tbl.shape[0] == 1:
        o, x, m = w.shape
        return (w.reshape(o * x, m) @ tbl[0].T).reshape(o, x, -1)
    return torch.bmm(w, tbl.transpose(1, 2))


def span_reduce_reference(t_re, t_im, v_re, v_im, b_re, b_im, off: int,
                          add=None) -> torch.Tensor:
    """The weights as [O, L, R, M] tensors and two matrix products against
    table rows off .. off+C-1 (C = table rows - 1), then ``add``:
    t [O, L, M] (t_im None: real rows), v [O, R, M] -> [O, L, R, C]."""
    o, r, m = v_re.shape
    nl = t_re.shape[1]
    c = b_re.shape[1] - 1
    w_pr, w_pi = _complex_weights(
        t_re[:, :, None, :], None if t_im is None else t_im[:, :, None, :],
        v_re[:, None], v_im[:, None])                      # [O, L, R, M]
    out = (_contract_xr(w_pr.reshape(o, nl * r, m), b_re[:, off:off + c])
           + _contract_xr(w_pi.reshape(o, nl * r, m), b_im[:, off:off + c]))
    out = out.reshape(o, nl, r, c)
    return out if add is None else out + add


def _launch(t_re, t_im, v_re, v_im, b_re, b_im, off, add, planes,
            variant):
    from . import _build
    o, r, m = v_re.shape
    nl = t_re.shape[1]
    c = b_re.shape[1] - 1
    given = [t_re, v_re, v_im, b_re, b_im] + [x for x in (t_im, add)
                                              if x is not None]
    for t in given:
        if t.device != v_re.device or t.dtype != torch.float32:
            raise ValueError("span_reduce takes float32 tensors on one CUDA "
                             f"device; got {t.dtype} on {t.device}")
    if min(o, nl, r, c, m) < 1:
        raise ValueError(f"span_reduce needs O, L, R, C, M >= 1; got t "
                         f"{tuple(t_re.shape)}, v {tuple(v_re.shape)}, "
                         f"table {tuple(b_re.shape)}")
    if variant == "split" and nl * r > SPLIT_ROWS:
        raise ValueError(f"span_reduce (split) takes L R <= {SPLIT_ROWS} "
                         f"rows an object; got L R = {nl * r}")
    lib = _build.load()
    stride = 0 if b_re.shape[0] == 1 else (c + 1) * m
    index = VARIANTS.index(variant)
    if o * nl * r > MAX_BLOCKS or lib.span_reduce_blocks(
            o, nl, r, c, stride, index) > MAX_BLOCKS:
        raise ValueError(f"{o} objects x {nl} listener rows x {r} rows "
                         "exceed the kernel's grid")
    t_re, v_re, v_im, b_re, b_im = (x.contiguous() for x in (
        t_re, v_re, v_im, b_re, b_im))
    t_im = None if t_im is None else t_im.contiguous()
    add = None if add is None else add.contiguous()
    rows = [t_re, v_re, v_im, b_re, b_im] + ([] if t_im is None else [t_im])
    lo_re = lo_im = None
    if variant == "wgmma":
        if planes is None:
            from .span import span_planes
            planes = span_planes(b_re, b_im)
        lo_re, lo_im = planes.lo_re, planes.lo_im
        for lo in (lo_re, lo_im):
            if (lo.shape != b_re.shape or lo.device != b_re.device
                    or lo.dtype != torch.float32 or not lo.is_contiguous()):
                raise ValueError(f"span_reduce: lo plane {tuple(lo.shape)} "
                                 f"on {lo.device} is not the table's "
                                 f"{tuple(b_re.shape)} layout")
        # the TMA reads from 16-byte aligned bases
        if any(x.data_ptr() % 16 for x in rows + [lo_re, lo_im]):
            raise ValueError(f"span_reduce ({variant}) needs every input "
                             "16-byte aligned (the TMA's bases)")
    if variant == "fp32" and (nl * r > FP32_ROWS or m % 4
                              or b_re.data_ptr() % 16
                              or b_im.data_ptr() % 16):
        raise ValueError(f"span_reduce (fp32) takes L R <= {FP32_ROWS} rows "
                         "an object and table rows of whole 16-byte "
                         f"aligned float4s; got L R = {nl * r}, M = {m}")
    out = torch.empty((o, nl, r, c), dtype=torch.float32,
                      device=v_re.device)
    # 16-byte loads need rows of whole float4s on 16-byte boundaries
    vec4 = int(m % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in rows))
    pairs = int(c % 2 == 0 and out.data_ptr() % 8 == 0
                and (add is None or add.data_ptr() % 8 == 0))
    with _build.device_guard(v_re):
        err = lib.span_reduce(
            t_re.data_ptr(), None if t_im is None else t_im.data_ptr(),
            v_re.data_ptr(), v_im.data_ptr(), b_re.data_ptr(),
            b_im.data_ptr(), None if lo_re is None else lo_re.data_ptr(),
            None if lo_im is None else lo_im.data_ptr(), stride,
            None if add is None else add.data_ptr(), out.data_ptr(), o, nl,
            r, c, m, off, vec4, pairs, index, RESTART_K8,
            _build.launch_stream(v_re))
    _build.check(err, f"span_reduce ({variant})")
    return out


def span_reduce(t_re: torch.Tensor,           # [O, L, M] masked rows
                t_im: torch.Tensor | None,    # [O, L, M] or None (real)
                v_re: torch.Tensor,           # [O, R, M]
                v_im: torch.Tensor,
                b_re: torch.Tensor,           # [Og, C+1, M] powers
                b_im: torch.Tensor,
                off: int,                     # first table row: 0 or 1
                add: torch.Tensor | None = None,   # [O, L, R, C]
                planes=None,                  # ops/span.py::SpanPlanes
                ) -> torch.Tensor:
    """sum over modes of the complex weights of (t, v) against table rows
    off .. off+C-1, plus ``add`` -> [O, L, R, C]. CUDA tensors launch the
    kernel's variant for the shape (variant_for; a failed build or launch
    raises), its wgmma variant reading ``planes``, made for this call
    when not given; CPU tensors run the plain twin."""
    global LAUNCHES
    dtypes = [t.dtype for t in (t_re, t_im, v_re, v_im, b_re, b_im, add)
              if t is not None]
    if not v_re.dtype.is_floating_point or len(set(dtypes)) > 1:
        raise ValueError("span_reduce takes tensors of one floating dtype; "
                         f"got {dtypes}")
    o, r, m = v_re.shape
    og, rows, mt = b_re.shape
    c = rows - 1
    if off not in (0, 1):
        raise ValueError(f"span_reduce: table row offset {off} is not 0 "
                         "or 1")
    if (t_re.dim() != 3 or t_re.shape[0] != o or t_re.shape[2] != m
            or (t_im is not None and t_im.shape != t_re.shape)
            or v_im.shape != v_re.shape or b_im.shape != b_re.shape
            or og not in (1, o) or mt != m
            or (add is not None
                and add.shape != (o, t_re.shape[1], r, c))):
        raise ValueError(
            f"shape mismatch: t {tuple(t_re.shape)} [O, L, M], v "
            f"{tuple(v_re.shape)} [O, R, M], table {tuple(b_re.shape)} "
            f"[Og, C+1, M], add "
            f"{None if add is None else tuple(add.shape)} [O, L, R, C]")
    if v_re.is_cuda:
        out = _launch(t_re, t_im, v_re, v_im, b_re, b_im, off, add, planes,
                      variant_for(o, t_re.shape[1], r, c, m, og))
        LAUNCHES += 1
        return out
    if v_re.device.type == "cpu":
        return span_reduce_reference(t_re, t_im, v_re, v_im, b_re, b_im,
                                     off, add)
    raise ValueError(f"no span_reduce kernel for device {v_re.device}")
