"""Chunk-state propagation of the chunked span: CUDA kernel + plain twin.

Counterpart of the single-level ``lax.scan`` in
openpbso_tpu/ops/span.py::_chunk_start_states. Over the X chunks of a span,
for every (object, mode) oscillator,

    starts[x] = z_x,    z_{x+1} = lam^C z_x + inj[x]    (inj None: ring-down)

In eager PyTorch the scan is a Python loop of X steps of a few launches
each (~3k launches per span at X = 512); on CUDA tensors ``chunk_scan``
launches one hand-written kernel (csrc/chunk_scan.cu) instead. On CPU
tensors it runs ``chunk_scan_reference``, the loop itself, which is also
what the kernel is held against on the card.
"""
from __future__ import annotations

import torch

MAX_GRID_Y = 65535        # one grid row per object

# launches of the card's kernel (one per call)
LAUNCHES = 0


def chunk_scan_reference(z_re, z_im, pc_re, pc_im, n_chunks: int,
                         inj_re=None, inj_im=None):
    """The X-step loop in plain PyTorch, in the JAX scan body's order.
    Returns (z_final_re, z_final_im, starts_re [O, X, M], starts_im)."""
    zr, zi = z_re, z_im
    starts_re, starts_im = [], []
    for x in range(n_chunks):
        starts_re.append(zr)
        starts_im.append(zi)
        zr, zi = pc_re * zr - pc_im * zi, pc_im * zr + pc_re * zi
        if inj_re is not None:
            zr = zr + inj_re[:, x]
            zi = zi + inj_im[:, x]
    return zr, zi, torch.stack(starts_re, dim=1), torch.stack(starts_im,
                                                              dim=1)


def _launch(z_re, z_im, pc_re, pc_im, n_chunks, inj_re, inj_im):
    from . import _build
    lib = _build.load()
    o, m = z_re.shape
    decay = inj_re is None
    rows = [z_re, z_im, pc_re, pc_im] + ([] if decay else [inj_re, inj_im])
    for t in rows:
        if t.device != z_re.device or t.dtype != torch.float32:
            raise ValueError("chunk_scan takes float32 tensors on one CUDA "
                             f"device; got {t.dtype} on {t.device}")
    if (z_im.shape != (o, m) or pc_re.shape != pc_im.shape
            or pc_re.dim() != 2 or pc_re.shape[0] not in (1, o)
            or pc_re.shape[1] != m
            or not decay and (inj_re.shape != (o, n_chunks, m)
                              or inj_im.shape != inj_re.shape)):
        raise ValueError("shape mismatch: expected z [O, M], lam^C [Og, M] "
                         "and injections [O, X, M]")
    if pc_re.stride(-1) != 1 or pc_im.stride(-1) != 1 or \
            pc_re.stride(0) != pc_im.stride(0):
        raise ValueError("lam^C rows must have contiguous modes and one "
                         "row stride")
    if o > MAX_GRID_Y:
        raise ValueError(f"{o} objects exceed the kernel's grid "
                         f"({MAX_GRID_Y} rows)")
    z_re, z_im = z_re.contiguous(), z_im.contiguous()
    if not decay:
        inj_re, inj_im = inj_re.contiguous(), inj_im.contiguous()
    starts_re = torch.empty((o, n_chunks, m), dtype=torch.float32,
                            device=z_re.device)
    starts_im = torch.empty_like(starts_re)
    zf_re, zf_im = torch.empty_like(z_re), torch.empty_like(z_im)
    stride = 0 if pc_re.shape[0] == 1 else pc_re.stride(0)
    with torch.cuda.device(z_re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.chunk_scan(
            z_re.data_ptr(), z_im.data_ptr(),
            None if decay else inj_re.data_ptr(),
            None if decay else inj_im.data_ptr(),
            pc_re.data_ptr(), pc_im.data_ptr(), stride,
            starts_re.data_ptr(), starts_im.data_ptr(),
            zf_re.data_ptr(), zf_im.data_ptr(), o, m, n_chunks, stream)
    _build.check(err, "chunk_scan")
    return zf_re, zf_im, starts_re, starts_im


def chunk_scan(z_re: torch.Tensor,           # [O, M]
               z_im: torch.Tensor,           # [O, M]
               pc_re: torch.Tensor,          # [Og, M] lam^C
               pc_im: torch.Tensor,
               n_chunks: int,
               inj_re: torch.Tensor | None = None,   # [O, X, M]
               inj_im: torch.Tensor | None = None):
    """Every chunk's start state and the final state of a span. CUDA
    tensors launch the kernel (a failed build or launch raises); CPU
    tensors run the plain twin. Returns (z_final_re, z_final_im,
    starts_re [O, X, M], starts_im)."""
    global LAUNCHES
    if (inj_re is None) != (inj_im is None):
        raise ValueError("give both injection parts or neither")
    if z_re.is_cuda:
        out = _launch(z_re, z_im, pc_re, pc_im, n_chunks, inj_re, inj_im)
        LAUNCHES += 1
        return out
    if z_re.device.type == "cpu":
        return chunk_scan_reference(z_re, z_im, pc_re, pc_im, n_chunks,
                                    inj_re, inj_im)
    raise ValueError(f"no chunk_scan kernel for device {z_re.device}")
