"""The drag's noise and AR(2) recurrence for the plain reference.

The noise follows the upstream JAX package's draw, which the port keeps
(threefry2x32 with 20 rounds, ``jax.random`` key semantics):

    key_o     = threefry(key(seed), (0, o))         split(key(seed), O)[o]
    key_{o,b} = threefry(key_o, (0, b))              fold_in(key_o, b)
    bits[j]   = x0 ^ x1 of threefry(key_{o,b}, (0, j))
    n[j]      = sqrt(2) erfinv(u), u = max(lo, 2 f + lo) in float32

with f the top 23 bits of bits[j] as a float in [0, 1) and lo the float32
just above -1. Here the words ride in int64 tensors; erfinv is taken in
float64.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _rotl(v, r):
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry(k0, k1, c0, c1):
    """threefry2x32 of counter (c0, c1) under key (k0, k1); int64 tensors
    or ints holding uint32 words, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def object_keys(seed: int, objects: int, device) -> torch.Tensor:
    """[O, 2] int64: the per-object keys of a session seeded ``seed``."""
    o = torch.arange(objects, dtype=torch.int64, device=device)
    x0, x1 = threefry(0, int(seed) & MASK, 0, o)
    return torch.stack([x0, x1], dim=-1)


def normals(keys: torch.Tensor, blocks: torch.Tensor,
            block: int) -> torch.Tensor:
    """The noise [P, S] float64 of pairs (keys [P, 2], absolute block index
    [P])."""
    k0, k1 = threefry(keys[:, :1], keys[:, 1:], 0, blocks[:, None] & MASK)
    j = torch.arange(block, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry(k0, k1, 0, j[None, :])
    bits = (x0 ^ x1) >> 9
    f = ((bits | 0x3F800000).to(torch.int32).view(torch.float32)
         - torch.tensor(1.0, dtype=torch.float32))
    u = torch.maximum(f * 2.0 + torch.tensor(LO, dtype=torch.float32),
                      torch.tensor(LO, dtype=torch.float32))
    return np.sqrt(2.0) * torch.special.erfinv(u.to(torch.float64))


def impulse(a, length: int) -> np.ndarray:
    """g[d], d in [0, length]: g[0] = 1, g[1] = a1, g[d] = a1 g[d-1] + a2
    g[d-2], the recurrence's response to a unit input, in float64."""
    g = np.zeros(length + 1)
    g[0] = 1.0
    if length >= 1:
        g[1] = a[0]
    for d in range(2, length + 1):
        g[d] = a[0] * g[d - 1] + a[1] * g[d - 2]
    return g


def toeplitz(g: np.ndarray, block: int) -> np.ndarray:
    """L[j, i] = g[j - i] for i <= j, else 0: the block's response to its
    own noise."""
    j = np.arange(block)
    lag = j[:, None] - j[None, :]
    return np.where(lag >= 0, g[np.clip(lag, 0, None)], 0.0)
