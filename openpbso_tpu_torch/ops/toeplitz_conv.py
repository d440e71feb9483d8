"""Within-chunk causal convolution of the chunked span: CUDA kernel + twin.

Counterpart of the Toeplitz step of
openpbso_tpu/ops/span.py::_integrate_span_chunked: per object, listener row
l and chunk x of C samples,

    out[o, l, x, c] = sum_k sum_{j<=c} g[o, l, k, c-j] f[o, k, x, j]

The JAX package gathered ``g`` into a Toeplitz tensor ``[O, L*K, C, C]``
(268 MB at 256 objects, one slot, C = 512) and contracted it with one
einsum. On CUDA tensors ``toeplitz_conv`` launches a hand-written kernel
(csrc/toeplitz_conv.cu) that runs the triangular product on the tensor
cores with the 3xTF32 split (FP32-accurate: held to <= -110 dB against
the twin) and builds each Toeplitz fragment from ``g`` in shared memory;
on CPU tensors it runs ``toeplitz_conv_reference``, the JAX formula, which
is also what the kernel is held against on the card.
"""
from __future__ import annotations

import torch

MAX_SMEM_BYTES = 232448   # dynamic shared memory a block may use on sm_90
MAX_BLOCKS = 2**31 - 1    # one grid dimension

# launches of the card's kernel (one per call)
LAUNCHES = 0


def toeplitz_conv_reference(g: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The materialised Toeplitz product: g [O, L, K, C], f [O, K, X, C]
    -> [O, L, X, C]."""
    c = g.shape[-1]
    idx = torch.arange(c, device=g.device)
    delta = idx[:, None] - idx[None, :]
    t_g = g[..., delta.clamp(min=0)] * (delta >= 0).to(g.dtype)
    return torch.einsum("olkcj,okxj->olxc", t_g, f)


def _launch(g, f):
    from . import _build
    lib = _build.load()
    o, nl, k, c = g.shape
    x = f.shape[2]
    for t in (g, f):
        if t.device != g.device or t.dtype != torch.float32:
            raise ValueError("toeplitz_conv takes float32 tensors on one "
                             f"CUDA device; got {t.dtype} on {t.device}")
    if min(o, nl, x, c) < 1:
        raise ValueError(f"toeplitz_conv needs O, L, X, C >= 1; got g "
                         f"{tuple(g.shape)}, f {tuple(f.shape)}")
    if lib.toeplitz_conv_blocks(o, nl, x, c) > MAX_BLOCKS:
        raise ValueError(f"{o} objects x {nl} listener rows x {x} chunks "
                         "exceed the kernel's grid")
    if lib.toeplitz_conv_smem_bytes(c) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {c} does not fit the kernel's shared "
                         "memory; use a smaller chunk")
    g, f = g.contiguous(), f.contiguous()
    # 16-byte copies need rows of whole float4s on 16-byte boundaries
    vec4 = int(c % 4 == 0 and g.data_ptr() % 16 == 0
               and f.data_ptr() % 16 == 0)
    out = torch.empty((o, nl, x, c), dtype=torch.float32, device=g.device)
    with _build.device_guard(g):
        err = lib.toeplitz_conv(g.data_ptr(), f.data_ptr(), out.data_ptr(),
                                o, nl, k, x, c, vec4, _build.launch_stream(g))
    _build.check(err, "toeplitz_conv")
    return out


def toeplitz_conv(g: torch.Tensor,     # [O, L, K, C] per-slot kernels
                  f: torch.Tensor      # [O, K, X, C] chunked profiles
                  ) -> torch.Tensor:
    """Causal within-chunk convolution summed over slots -> [O, L, X, C].
    CUDA tensors launch the kernel (a failed build or launch raises); CPU
    tensors run the plain twin."""
    global LAUNCHES
    o, _, k, c = g.shape
    if f.dim() != 4 or f.shape[0] != o or f.shape[1] != k or f.shape[3] != c:
        raise ValueError(f"shape mismatch: g {tuple(g.shape)} [O, L, K, C] "
                         f"against f {tuple(f.shape)} [O, K, X, C]")
    if g.is_cuda:
        out = _launch(g, f)
        LAUNCHES += 1
        return out
    if g.device.type == "cpu":
        return toeplitz_conv_reference(g, f)
    raise ValueError(f"no toeplitz_conv kernel for device {g.device}")
