"""One block of the sustained AR(2) recurrence: CUDA kernel + plain twin.

Counterpart of the ``lax.scan`` in openpbso_tpu/ops/forces.py::
sustained_block. Per object, over the S samples of one block with the
counter-derived noise n_j of ops/ar_noise.py (forces.h:107-128):

    m_j       = (a0 h0 + a1 h1) + sigma n_j,      (h0, h1) <- (m_j, h0)
    profile_j = (mu + m_j) * active
    hist'     = (h0, h1) after the block where active, else hist

In eager PyTorch that is a loop of ~5 launches per sample; on CUDA tensors
``ar_block`` launches one hand-written kernel (csrc/ar_block.cu) that draws
the block's noise and runs the recurrence. On CPU tensors it runs
``ar_block_reference``, the loop itself, which is also what the kernel is
held against on the card: bitwise, given the kernel's own normals.
"""
from __future__ import annotations

import torch

from .ar_noise import ar_noise_reference, block_counter

# shared memory a launch may use without an attribute call (the normals)
MAX_SMEM_BYTES = 48 * 1024

# launches of the card's kernel (one per call)
LAUNCHES = 0


def ar_block_reference(key, a, hist, sigma, mu, active, block_index: int,
                       block_size: int, noise: torch.Tensor | None = None):
    """The S-step loop in plain PyTorch, in the JAX scan body's order.
    ``noise`` [O, S] replaces the twin's own draw (the threefry twin of
    block ``block_index``). Returns (profile [O, S], hist' [O, 2])."""
    if noise is None:
        noise = ar_noise_reference(key, block_index, 1, 0, block_size)[:, 0]
    noise = noise.to(a.dtype)
    a0, a1 = a[:, 0], a[:, 1]
    h0, h1 = hist[:, 0], hist[:, 1]
    out = []
    for j in range(block_size):
        m = a0 * h0 + a1 * h1
        m = m + sigma * noise[:, j]
        out.append(m)
        h0, h1 = m, h0
    profile = (mu[:, None] + torch.stack(out, dim=1)) \
        * active[:, None].to(a.dtype)
    return profile, torch.where(active[:, None], torch.stack([h0, h1], 1),
                                hist)


def _launch(key, a, hist, sigma, mu, active, block_index, block_size):
    from . import _build
    lib = _build.load()
    o = key.shape[0]
    idx = key.get_device()
    for t in (a, hist, sigma, mu):
        if t.get_device() != idx or t.dtype != torch.float32:
            raise ValueError("ar_block takes float32 tensors on the keys' "
                             f"CUDA device; got {t.dtype} on {t.device}")
    if (key.dtype != torch.int64 or active.dtype != torch.bool
            or active.get_device() != idx):
        raise ValueError("ar_block takes int64 keys and a bool activity "
                         "row on one device")
    if not all(t.is_contiguous() for t in (key, a, hist, sigma, mu, active)):
        raise ValueError("ar_block takes contiguous tensors")
    if 16 * -(-block_size // 4) > MAX_SMEM_BYTES:   # the block's normals
        raise ValueError(f"block size {block_size} does not fit the "
                         "kernel's shared memory")
    profile = torch.empty((o, block_size), dtype=torch.float32,
                          device=key.device)
    hist_out = torch.empty_like(hist)
    with _build.device_guard(key):
        err = lib.ar_block(key.data_ptr(), a.data_ptr(), hist.data_ptr(),
                           sigma.data_ptr(), mu.data_ptr(), active.data_ptr(),
                           block_index, profile.data_ptr(),
                           hist_out.data_ptr(), o, block_size,
                           _build.launch_stream(key))
    _build.check(err, "ar_block")
    return profile, hist_out


def ar_block(key: torch.Tensor,       # [O, 2] int64 per-object base keys
             a: torch.Tensor,         # [O, 2] AR coefficients
             hist: torch.Tensor,      # [O, 2] (m_{-1}, m_{-2})
             sigma: torch.Tensor,     # [O]
             mu: torch.Tensor,        # [O]
             active: torch.Tensor,    # [O] bool
             block_start: int,        # device sample clock of the block
             block_size: int):
    """One block of every object's AR(2) profile: (profile [O, S], hist'
    [O, 2]). CUDA tensors launch the kernel (a failed build or launch
    raises); CPU tensors run the plain twin."""
    global LAUNCHES
    o = key.shape[0]
    if (key.shape != (o, 2) or a.shape != (o, 2) or hist.shape != (o, 2)
            or sigma.shape != (o,) or mu.shape != (o,)
            or active.shape != (o,)):
        raise ValueError("shape mismatch: expected keys, a, hist [O, 2] and "
                         "sigma, mu, active [O]")
    block_index, _ = block_counter(block_start, block_size)
    if key.is_cuda:
        out = _launch(key, a, hist, sigma, mu, active, block_index,
                      block_size)
        LAUNCHES += 1
        return out
    if key.device.type == "cpu":
        return ar_block_reference(key, a, hist, sigma, mu, active,
                                  block_index, block_size)
    raise ValueError(f"no ar_block kernel for device {key.device}")
