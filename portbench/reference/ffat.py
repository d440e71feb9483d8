"""The FFAT transfer lookup of the plain reference.

The upstream's FFAT_Map::GetMapVal (openpbso ffat_solver.h): a ray from
the listener toward the map's center enters the outer cubemap shell
through the face whose plane the entry point lies nearest (the planes
scanned as low x, top x, low y, top y, low z, top z; the first strictly
nearest wins); the amplitude there is the bilinear interpolation of the
face's grid of cell-centred values, clamped at the face's edges; the
transfer is |psi / (k r)| with r the listener's distance to the center.
Face f has its normal along axis f // 2, lies on the top plane for even f
and the low plane for odd f, and its grid runs over axes (f//2 + 1) % 3
and (f//2 + 2) % 3.
"""
from __future__ import annotations

import torch


def transfer(rows: torch.Tensor, maps: dict) -> torch.Tensor:
    """Transfer magnitudes [O, M] of listener rows [O, 3] (each relative
    to its object's frame) for the maps of M modes: ``maps`` holds psi [M,
    P], k [M], center [M, 3], bbox_low/bbox_top [M, 3], low_corners [M, 6,
    3], n_elements [M, 6, 2], strides [M, 6], cell [M] and mask [M], as
    tensors on the rows' device and in their dtype (n_elements and strides
    as int64)."""
    eps = 1e-30
    p = rows[:, None, :]                                    # [O, 1, 3]
    d = maps["center"][None] - p                            # [O, M, 3]
    d_safe = torch.where(d.abs() < eps, torch.full_like(d, eps), d)
    t_lo = (maps["bbox_low"][None] - p) / d_safe
    t_hi = (maps["bbox_top"][None] - p) / d_safe
    t_in = torch.minimum(t_lo, t_hi).amax(dim=-1, keepdim=True)
    surf = p + t_in * d                                     # [O, M, 3]
    dist = torch.stack(
        [(maps["bbox_low"][None][..., a] - surf[..., a]).abs() if lo
         else (maps["bbox_top"][None][..., a] - surf[..., a]).abs()
         for a in range(3) for lo in (True, False)], dim=-1)
    # planes in scan order low x, top x, ... -> faces 1, 0, 3, 2, 5, 4
    scan = dist.argmin(dim=-1)
    face = scan + 1 - 2 * (scan % 2)
    axis = face // 2
    ui = (axis + 1) % 3
    vj = (axis + 2) % 3

    def per_face(x):                       # [M, 6, ...] at face [O, M]
        xe = x[None].expand((face.shape[0],) + x.shape)
        idx = face.reshape(face.shape + (1,) * (x.dim() - 1))
        idx = idx.expand(face.shape + (1,) + x.shape[2:])
        return torch.gather(xe, 2, idx).squeeze(2)

    def along(x, ax):                       # [O, M, 3] at axis [O, M]
        return torch.gather(x, -1, ax[..., None])[..., 0]

    low = per_face(maps["low_corners"])                    # [O, M, 3]
    n_el = per_face(maps["n_elements"])                    # [O, M, 2]
    stride = per_face(maps["strides"])                     # [O, M]
    h = maps["cell"][None]
    nu, nv = n_el[..., 0], n_el[..., 1]
    xf = (along(surf, ui) - (along(low, ui) + 0.5 * h)) / h
    yf = (along(surf, vj) - (along(low, vj) + 0.5 * h)) / h
    x0 = torch.floor(xf).long()
    y0 = torch.floor(yf).long()
    x_in = (x0 >= 0) & (x0 < nu - 1)
    y_in = (y0 >= 0) & (y0 < nv - 1)
    xc = torch.minimum(x0.clamp_min(0), nu - 1)
    yc = torch.minimum(y0.clamp_min(0), nv - 1)
    x1 = torch.where(x_in, xc + 1, xc)
    y1 = torch.where(y_in, yc + 1, yc)
    tx = torch.where(x_in, xf - xc, torch.zeros_like(xf)).clamp(0.0, 1.0)
    ty = torch.where(y_in, yf - yc, torch.zeros_like(yf)).clamp(0.0, 1.0)
    psi = maps["psi"][None].expand(rows.shape[0], -1, -1)

    def at(x, y):
        return torch.gather(psi, -1, (stride + x * nv + y)[..., None])[..., 0]
    val = ((1 - tx) * (1 - ty) * at(xc, yc) + tx * (1 - ty) * at(x1, yc)
           + (1 - tx) * ty * at(xc, y1) + tx * ty * at(x1, y1))
    r = torch.linalg.vector_norm(p - maps["center"][None], dim=-1)
    kr = maps["k"][None] * r.clamp_min(eps)
    return (val / kr.clamp_min(eps)).abs() * maps["mask"][None]
