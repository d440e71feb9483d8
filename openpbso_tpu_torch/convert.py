"""Carry the JAX package's bank, state, FFAT maps and span tables across.

Each function takes an object whose fields can be read with ``np.asarray``
(for example a JAX ``ModalBank``, ``SolverState``, ``FFATMaps`` or
span tables after ``jax.tree.map(np.asarray, x)``) and returns the
port's counterpart on the chosen device (None: the CUDA device, as every
builder of the port), dtypes unchanged. This module does not import jax, so
both packages can compute from identical float32 tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.coeffs import ModalBank
from .ops.ffat import DeviceFFAT, FFATMaps
from .ops.forces import ForceSlots, SustainedState
from .ops.span import ChunkSpanTables
from .runtime.state import SolverState


def _t(x, device) -> torch.Tensor | None:
    return None if x is None else torch.as_tensor(np.array(x)).to(device)


def bank_from_numpy(src, device=None) -> ModalBank:
    device = resolve_device(device)
    return ModalBank(**{name: _t(getattr(src, name), device) for name in (
        "lam_re", "lam_im", "b_re", "b_im", "mask", "pow_re", "pow_im")})


def state_from_numpy(src, device=None) -> SolverState:
    """A SolverState, the sustained channel with it (its uint32 noise keys
    as the port's int64 words)."""
    device = resolve_device(device)
    sus = src.sustained
    sl = src.slots
    return SolverState(
        z_re=_t(src.z_re, device),
        z_im=_t(src.z_im, device),
        slots=ForceSlots(*(_t(getattr(sl, n), device) for n in (
            "ftype", "t0", "width", "amp", "space"))),
        sustained=SustainedState(
            *(_t(getattr(sus, n), device) for n in (
                "active", "space", "ar_hist", "a", "sigma", "mu")),
            key=_t(np.asarray(sus.key).astype(np.int64), device)),
        transfer=_t(src.transfer, device),
        block_start=int(np.asarray(src.block_start)),
        transfer_im=_t(src.transfer_im, device),
    )


def ffat_from_numpy(src, device=None) -> FFATMaps:
    """FFAT maps, the compressed second texture ``psi_c`` with them when
    the source carries one."""
    device = resolve_device(device)
    g = src.geom
    names = ("psi", "k", "center", "bbox_low", "bbox_top", "low_corners",
             "n_elements", "strides", "mode_mask", "psi_c")
    geom = DeviceFFAT(**{n: _t(getattr(g, n, None), device) for n in names})
    return FFATMaps(geom=geom, cell_size=_t(src.cell_size, device))


def span_tables_from_numpy(src, device=None):
    """JAX chunked span tables as the port's flat ``ChunkSpanTables``: the
    baby table and chunk count, with any superchunk powers of the JAX
    package's two-level scan dropped (the flat scan runs the same span to
    float32 rounding). The JAX package's factored and full tables raise
    ValueError. The tables come without their SpanPlanes: those are made
    where the tables are used (ops/span.py::with_planes, a session's
    span_tables_for), from the tables on that device."""
    device = resolve_device(device)
    if not hasattr(src, "n_chunks"):
        raise ValueError("the port takes only the chunked span form "
                         "(ChunkSpanTables), not factored or full tables")
    return ChunkSpanTables(b_re=_t(src.b_re, device),
                           b_im=_t(src.b_im, device),
                           n_chunks=int(src.n_chunks))
