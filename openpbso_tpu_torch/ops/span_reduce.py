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
the card.
"""
from __future__ import annotations

import torch

from .integrator import _complex_weights

MAX_BLOCKS = 2**31 - 1    # one grid dimension

# launches of the card's kernel (one per call)
LAUNCHES = 0


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


def _launch(t_re, t_im, v_re, v_im, b_re, b_im, off, add):
    from . import _build
    lib = _build.load()
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
    stride = 0 if b_re.shape[0] == 1 else (c + 1) * m
    if o * nl * r > MAX_BLOCKS or lib.span_reduce_blocks(
            o, nl, r, c, stride) > MAX_BLOCKS:
        raise ValueError(f"{o} objects x {nl} listener rows x {r} rows "
                         "exceed the kernel's grid")
    t_re, v_re, v_im, b_re, b_im = (x.contiguous() for x in (
        t_re, v_re, v_im, b_re, b_im))
    t_im = None if t_im is None else t_im.contiguous()
    add = None if add is None else add.contiguous()
    out = torch.empty((o, nl, r, c), dtype=torch.float32,
                      device=v_re.device)
    rows = [t_re, v_re, v_im, b_re, b_im] + ([] if t_im is None else [t_im])
    # 16-byte loads need rows of whole float4s on 16-byte boundaries
    vec4 = int(m % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in rows))
    pairs = int(c % 2 == 0 and out.data_ptr() % 8 == 0
                and (add is None or add.data_ptr() % 8 == 0))
    with _build.device_guard(v_re):
        err = lib.span_reduce(
            t_re.data_ptr(), None if t_im is None else t_im.data_ptr(),
            v_re.data_ptr(), v_im.data_ptr(), b_re.data_ptr(),
            b_im.data_ptr(), stride, None if add is None else add.data_ptr(),
            out.data_ptr(), o, nl, r, c, m, off, vec4, pairs,
            _build.launch_stream(v_re))
    _build.check(err, "span_reduce")
    return out


def span_reduce(t_re: torch.Tensor,           # [O, L, M] masked rows
                t_im: torch.Tensor | None,    # [O, L, M] or None (real)
                v_re: torch.Tensor,           # [O, R, M]
                v_im: torch.Tensor,
                b_re: torch.Tensor,           # [Og, C+1, M] powers
                b_im: torch.Tensor,
                off: int,                     # first table row: 0 or 1
                add: torch.Tensor | None = None,   # [O, L, R, C]
                ) -> torch.Tensor:
    """sum over modes of the complex weights of (t, v) against table rows
    off .. off+C-1, plus ``add`` -> [O, L, R, C]. CUDA tensors launch the
    kernel (a failed build or launch raises); CPU tensors run the plain
    twin."""
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
        out = _launch(t_re, t_im, v_re, v_im, b_re, b_im, off, add)
        LAUNCHES += 1
        return out
    if v_re.device.type == "cpu":
        return span_reduce_reference(t_re, t_im, v_re, v_im, b_re, b_im,
                                     off, add)
    raise ValueError(f"no span_reduce kernel for device {v_re.device}")
