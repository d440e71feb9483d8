"""Where the port's builders put their tensors.

The port runs on the card: a builder called without ``device`` builds on
CUDA, and raises when no CUDA device is present rather than building on
the CPU, where a session would silently run the kernels' plain twins.
Work on the CPU (the tests, a machine without a GPU) passes
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the GPU by default; pass "
            "device=\"cpu\" to build on the CPU (the kernels' plain twins)")
    return torch.device("cuda")
