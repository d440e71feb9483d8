"""Counter-based threefry2x32 and JAX's normal map, in plain PyTorch.

The sustained channel's noise is a pure function of (per-object key, block
index, sample index): the JAX package draws it with ``jax.random``'s
threefry2x32 (with ``jax_threefry_partitionable``, JAX's default), as

    key_o      = split(PRNGKey(seed), O)[o]      = tf(PRNGKey(seed), (0, o))
    key_{o,b}  = fold_in(key_o, b)               = tf(key_o, (0, b))
    bits[j]    = x0 ^ x1 of tf(key_{o,b}, (0, j))
    normal[j]  = sqrt(2) * erfinv(u(bits[j]))

(openpbso_tpu/ops/forces.py::make_sustained_state, _noise_for_blocks).
This module computes the same keys and bits bitwise, without jax: it is
the twin that the CUDA kernels (csrc/threefry.cuh, used by csrc/ar_noise.cu
and csrc/ar_block.cu) are held against.

torch has no full uint32 arithmetic, so every 32-bit word rides in an
int64 tensor (or a Python int) holding the uint32 value; sums are masked
with 0xFFFFFFFF and shifts stay below bit 62. Keys are ``[O, 2]`` int64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax.random.normal draws u in [nextafter(-1, 0), 1), then sqrt(2) erfinv(u)
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SCALE = float(np.float32(1.0) - np.float32(_LO))       # rounds to 2.0
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """threefry2x32 (20 rounds) of the counter words (c0, c1) under the key
    (k0, k1). Arguments are int64 tensors or Python ints holding uint32
    values, broadcast together; returns the two output words (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed as uint32)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return 0, seed & MASK


def split(key: tuple[int, int], n: int,
          device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.split(key, n)``'s key data: [n, 2] int64."""
    i = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    x0, x1 = threefry2x32(key[0], key[1], 0, i)
    return torch.stack([x0, x1], dim=-1)


def fold_in(k0, k1, data):
    """``jax.random.fold_in(key, data)`` for int32 ``data`` (words as in
    threefry2x32): the key words (x0, x1)."""
    return threefry2x32(k0, k1, 0, data & MASK)


def uniform_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 normal from 32 random bits (uint32 values in int64):
    the top 23 bits as a mantissa in [1, 2), mapped to u in [lo, 1) with
    lo = nextafter(-1, 0), each product and sum rounded in float32, then
    sqrt(2) * erfinv(u)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    lo = torch.tensor(_LO, dtype=torch.float32, device=bits.device)
    u = torch.maximum(lo, f * _SCALE + lo)
    return _SQRT2 * torch.special.erfinv(u)
