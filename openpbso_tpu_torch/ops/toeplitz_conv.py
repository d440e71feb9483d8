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
is also what the kernel is held against on the card. The kernel source
holds two designs; ``variant_for`` picks one from the shape alone: v3
(16 chunks a block as the GEMM's rows, the Toeplitz operand as B) and,
for the live stream's short spans (at most 8 chunks of at most 256
samples), the transposed product (the samples as rows, the chunks one n8
tile, one block an object).
"""
from __future__ import annotations

import torch

MAX_SMEM_BYTES = 232448   # dynamic shared memory a block may use on sm_90
MAX_BLOCKS = 2**31 - 1    # one grid dimension
# the kernel's variants, by their number in its C interface
VARIANTS = ("v3", "short")
SHORT_ROUTE = (8, 256)   # the short variant's limits: X chunks, C samples
# the fewest slots at which short measured faster than v3 (bench/
# toeplitz_ab.py, PERF.md), by chunk: from 2 slots at chunks of up to 64
# samples (1 slot: 0.0055 against 0.0043 ms), from 8 past them (2-5 slots
# at 256 samples: 2-8% slower, 8 slots 0.030 against 0.039)
SHORT_SLOTS = ((64, 2), (SHORT_ROUTE[1], 8))

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


def variant_for(o: int, nl: int, k: int, x: int, c: int) -> str:
    """The kernel variant for a call's shape, by the shape alone: short
    within SHORT_ROUTE (the one- and four-block spans' X = 8 chunks of 64
    or 256 samples) at SHORT_SLOTS' slots or more (a busy stream's full
    bucket), else v3."""
    if x > SHORT_ROUTE[0] or c > SHORT_ROUTE[1]:
        return "v3"
    fewest = next(n for most, n in SHORT_SLOTS if c <= most)
    return "short" if k >= fewest else "v3"


def _launch(g, f, variant):
    from . import _build
    o, nl, k, c = g.shape
    x = f.shape[2]
    for t in (g, f):
        if t.device != g.device or t.dtype != torch.float32:
            raise ValueError("toeplitz_conv takes float32 tensors on one "
                             f"CUDA device; got {t.dtype} on {t.device}")
    if min(o, nl, x, c) < 1:
        raise ValueError(f"toeplitz_conv needs O, L, X, C >= 1; got g "
                         f"{tuple(g.shape)}, f {tuple(f.shape)}")
    if variant == "short" and (x > 8 or c > 256):
        raise ValueError("toeplitz_conv (short) takes X <= 8 chunks of C "
                         f"<= 256 samples; got X = {x}, C = {c}")
    lib = _build.load()
    index = VARIANTS.index(variant)
    if lib.toeplitz_conv_blocks(o, nl, x, c, index) > MAX_BLOCKS:
        raise ValueError(f"{o} objects x {nl} listener rows x {x} chunks "
                         "exceed the kernel's grid")
    if lib.toeplitz_conv_smem_bytes(c, index) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {c} does not fit the kernel's shared "
                         "memory; use a smaller chunk")
    g, f = g.contiguous(), f.contiguous()
    # 16-byte copies need rows of whole float4s on 16-byte boundaries
    vec4 = int(c % 4 == 0 and g.data_ptr() % 16 == 0
               and f.data_ptr() % 16 == 0)
    out = torch.empty((o, nl, x, c), dtype=torch.float32, device=g.device)
    with _build.device_guard(g):
        err = lib.toeplitz_conv(g.data_ptr(), f.data_ptr(), out.data_ptr(),
                                o, nl, k, x, c, vec4, index,
                                _build.launch_stream(g))
    _build.check(err, f"toeplitz_conv ({variant})")
    return out


def toeplitz_conv(g: torch.Tensor,     # [O, L, K, C] per-slot kernels
                  f: torch.Tensor      # [O, K, X, C] chunked profiles
                  ) -> torch.Tensor:
    """Causal within-chunk convolution summed over slots -> [O, L, X, C].
    CUDA tensors launch the kernel's variant for the shape (variant_for; a
    failed build or launch raises); CPU tensors run the plain twin."""
    global LAUNCHES
    o, _, k, c = g.shape
    if f.dim() != 4 or f.shape[0] != o or f.shape[1] != k or f.shape[3] != c:
        raise ValueError(f"shape mismatch: g {tuple(g.shape)} [O, L, K, C] "
                         f"against f {tuple(f.shape)} [O, K, X, C]")
    if g.is_cuda:
        out = _launch(g, f, variant_for(o, g.shape[1], k, f.shape[2], c))
        LAUNCHES += 1
        return out
    if g.device.type == "cpu":
        return toeplitz_conv_reference(g, f)
    raise ValueError(f"no toeplitz_conv kernel for device {g.device}")
