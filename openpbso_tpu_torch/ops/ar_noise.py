"""Counter-based noise of the sustained channel: CUDA kernel + plain twin.

Counterpart of openpbso_tpu/ops/forces.py::_noise_for_blocks. The noise of
block b of object o is N(0, 1)^S drawn from fold_in(key_o, b), with b the
absolute block index taken modulo the clock's rebase period in blocks (the
session's rebase subtracts whole periods, so a live block-by-block stream
and a span of any length draw the same noise across the boundary). There
is no key chain: every block's draw is a pure function of (key, b), so any
dispatch split gives the same stream.

On CUDA tensors ``ar_noise`` launches a hand-written kernel
(csrc/ar_noise.cu, one threefry per sample); on CPU tensors it runs
``ar_noise_reference``, the threefry twin of ops/threefry.py, which is
also what the kernel is held against on the card. The bits are equal
(``bits=True`` returns them in place of the normals); the normals may
differ in the last bits (CUDA's erfinvf against torch.special.erfinv). The
noise is float32, as the JAX package draws it for a float32 session.
"""
from __future__ import annotations

import torch

from ..config import REBASE_PERIOD
from .threefry import MASK, fold_in, threefry2x32, uniform_to_normal

MAX_GRID_Y = 65535        # one grid row per object

# launches of the card's kernel (one per call)
LAUNCHES = 0


def block_counter(block_start: int, block_size: int) -> tuple[int, int]:
    """(index of the block at ``block_start``, modulus of the block index):
    the modulus is REBASE_PERIOD in blocks when the block size divides it,
    else 0 (none), as in the JAX package."""
    if block_start < 0:
        raise ValueError(f"block_start {block_start} < 0")
    period = (REBASE_PERIOD // block_size
              if REBASE_PERIOD % block_size == 0 else 0)
    idx0 = block_start // block_size
    return (idx0 % period if period else idx0), period


def ar_noise_reference(key: torch.Tensor, idx0: int, n_blocks: int,
                       period: int, block_size: int,
                       bits: bool = False) -> torch.Tensor:
    """The threefry twin: key [O, 2] int64 -> noise [O, n_blocks, S]
    float32 (``bits``: the random bits, int64 holding uint32)."""
    b = idx0 + torch.arange(n_blocks, dtype=torch.int64, device=key.device)
    if period:
        b = b % period
    k0, k1 = fold_in(key[:, :1], key[:, 1:], b[None, :])      # [O, X]
    j = torch.arange(block_size, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(k0[..., None], k1[..., None], 0, j)
    return (x0 ^ x1) if bits else uniform_to_normal(x0 ^ x1)


def _launch(key, idx0, n_blocks, period, block_size, bits):
    from . import _build
    lib = _build.load()
    o = key.shape[0]
    if key.dtype != torch.int64:
        raise ValueError(f"ar_noise takes int64 keys; got {key.dtype}")
    if o > MAX_GRID_Y:
        raise ValueError(f"{o} objects exceed the kernel's grid "
                         f"({MAX_GRID_Y} rows)")
    key = key.contiguous()
    out = torch.empty((o, n_blocks, block_size), dtype=torch.float32,
                      device=key.device)
    with _build.device_guard(key):
        err = lib.ar_noise(key.data_ptr(), idx0, period, out.data_ptr(), o,
                           n_blocks, block_size, int(bits),
                           _build.launch_stream(key))
    _build.check(err, "ar_noise")
    return out.view(torch.int32).to(torch.int64) & MASK if bits else out


def ar_noise(key: torch.Tensor,       # [O, 2] int64 per-object base keys
             block_start: int,        # device sample clock of the first block
             n_blocks: int,
             block_size: int,
             bits: bool = False) -> torch.Tensor:
    """The noise of ``n_blocks`` blocks from ``block_start``:
    [O, n_blocks, S] float32, object-major (``bits``: the random bits
    under it, int64 holding uint32). CUDA tensors launch the kernel (a
    failed build or launch raises); CPU tensors run the plain twin."""
    global LAUNCHES
    if key.dim() != 2 or key.shape[1] != 2:
        raise ValueError(f"keys must be [O, 2]; got {tuple(key.shape)}")
    idx0, period = block_counter(block_start, block_size)
    if key.is_cuda:
        out = _launch(key, idx0, n_blocks, period, block_size, bits)
        LAUNCHES += 1
        return out
    if key.device.type == "cpu":
        return ar_noise_reference(key, idx0, n_blocks, period, block_size,
                                  bits)
    raise ValueError(f"no ar_noise kernel for device {key.device}")
