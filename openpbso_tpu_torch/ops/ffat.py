"""FFAT acoustic-transfer maps on the device — gather-based cubemap lookup.

Counterpart of openpbso_tpu/ops/ffat.py. The decoded maps become dense
tensors and the lookup is one vectorized intersect / gather / reconstruct
over every (object, mode) at once, at listener-update rate. Per-face
amplitude grids keep the reference's flat row-major indexing
(``stride[face] + u * Nv[face] + v``, ffat_solver.h:141-144). Geometry is
carried per (object, mode) with a leading axis Og that is 1 when every
object shares one model and O otherwise. A second, compressed Psi texture
(``psi_c``, the reference's useCompressed query) can ride beside the raw
one, which makes the compressed-vs-raw toggle a switch with no rebuild.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..io.fatcube import FatcubeMap
from .coeffs import round_up
from .ffat_fit import compress_map


@dataclasses.dataclass(frozen=True)
class DeviceFFAT:
    """Device-resident FFAT maps for a batch of objects. Modes without a
    map have ``mode_mask`` 0 and yield zero transfer."""
    psi: torch.Tensor          # [Og, M, P] flat amplitudes (padded)
    k: torch.Tensor            # [Og, M] wavenumber per mode
    center: torch.Tensor       # [Og, M, 3]
    bbox_low: torch.Tensor     # [Og, M, 3]
    bbox_top: torch.Tensor     # [Og, M, 3]
    low_corners: torch.Tensor  # [Og, M, 6, 3]
    n_elements: torch.Tensor   # [Og, M, 6, 2] int32 (Nu, Nv)
    strides: torch.Tensor      # [Og, M, 6] int32
    mode_mask: torch.Tensor    # [Og, M] 1.0 where a map exists
    psi_c: torch.Tensor | None = None   # [Og, M, P] optional compressed
    #   amplitudes, same layout: the reference keeps both Psi sets and
    #   picks per query (GetMapVal(pos, getCompressed),
    #   ffat_solver.h:1180-1214)

    @property
    def shared(self) -> bool:
        return self.psi.shape[0] == 1


@dataclasses.dataclass(frozen=True)
class FFATMaps:
    geom: DeviceFFAT
    cell_size: torch.Tensor    # [Og, M]


def _host_maps(maps: dict[int, FatcubeMap], m: int,
               compressed_maps: dict[int, FatcubeMap] | str | None = None
               ) -> dict[str, np.ndarray]:
    """One object's maps as float64/int32 host arrays with a leading axis 1;
    with ``compressed_maps`` (a dict, or "auto": compress_map of each map at
    the reference tool's JPEG quality 65) also the second texture
    ``psi_c``."""
    if compressed_maps == "auto":
        compressed_maps = {mid: compress_map(mm, jpeg_quality=65)
                           for mid, mm in maps.items()}
    p_max = max((mm.psi.shape[0] for mm in maps.values()), default=0)
    p_pad = round_up(max(p_max, 1), 128)
    a = {
        "psi": np.zeros((1, m, p_pad)),
        "k": np.ones((1, m)),
        "center": np.zeros((1, m, 3)),
        "bbox_low": np.zeros((1, m, 3)),
        "bbox_top": np.ones((1, m, 3)),
        "low_corners": np.zeros((1, m, 6, 3)),
        "n_elements": np.ones((1, m, 6, 2), np.int32),
        "strides": np.zeros((1, m, 6), np.int32),
        "mode_mask": np.zeros((1, m)),
        "cell_size": np.ones((1, m)),
    }
    for mode_id, mm in maps.items():
        if mode_id >= m:
            continue
        s = mm.shell
        a["psi"][0, mode_id, : mm.psi.shape[0]] = mm.psi
        a["k"][0, mode_id] = mm.k
        a["center"][0, mode_id] = mm.center
        a["bbox_low"][0, mode_id] = s.bbox_low
        a["bbox_top"][0, mode_id] = s.bbox_top
        a["low_corners"][0, mode_id] = s.low_corners
        a["n_elements"][0, mode_id] = s.n_elements
        a["strides"][0, mode_id] = s.strides
        a["mode_mask"][0, mode_id] = 1.0
        a["cell_size"][0, mode_id] = s.cell_size
    if compressed_maps:
        a["psi_c"] = np.zeros((1, m, p_pad))
        for mode_id, mm in compressed_maps.items():
            if mode_id < m:
                a["psi_c"][0, mode_id, : mm.psi.shape[0]] = mm.psi
    return a


def _maps_to_device(a: dict[str, np.ndarray], dtype: torch.dtype,
                    device) -> FFATMaps:
    def dev(name):
        if name not in a:
            return None
        x = torch.as_tensor(a[name])
        return x.to(device=device,
                    dtype=torch.int32 if x.dtype == torch.int32 else dtype)
    geom = DeviceFFAT(**{f.name: dev(f.name)
                         for f in dataclasses.fields(DeviceFFAT)})
    return FFATMaps(geom=geom, cell_size=dev("cell_size"))


def build_ffat(maps: dict[int, FatcubeMap], num_modes: int, *,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None,
               compressed_maps: dict[int, FatcubeMap] | str | None = None,
               ) -> FFATMaps:
    """Pack decoded fatcube maps (mode id -> map) into device tensors: one
    shared geometry/texture set (Og = 1). ``device`` None is the CUDA
    device (device.resolve_device).

    ``compressed_maps`` carries the reference's second Psi set for the
    runtime compressed-vs-raw toggle: a dict of compressed FatcubeMaps (the
    same geometry), or "auto" to run each map through
    ffat_fit.compress_map at the reference tool's JPEG quality 65."""
    device = resolve_device(device)
    return _maps_to_device(_host_maps(maps, num_modes, compressed_maps),
                           dtype, device)


def build_ffat_hetero(per_object_maps: list[dict[int, FatcubeMap]],
                      num_modes: int, *, dtype: torch.dtype = torch.float32,
                      device: torch.device | str | None = None,
                      compressed_maps: list | str | None = None) -> FFATMaps:
    """Per-object FFAT maps (heterogeneous scene): geometry axis Og = O.
    ``compressed_maps``: a per-object list of compressed dicts, or "auto"
    (as build_ffat); the second texture is kept only when every object has
    one. Objects that share their map dicts (a scene's instances of one
    model) are packed once on the host and repeated on the device."""
    device = resolve_device(device)
    comp = (compressed_maps if isinstance(compressed_maps, list)
            else [compressed_maps] * len(per_object_maps))
    keys = [(id(maps), id(c)) for maps, c in zip(per_object_maps, comp)]
    first = {}
    for i, key in enumerate(keys):
        first.setdefault(key, i)
    singles = [_host_maps(per_object_maps[i], num_modes, comp[i])
               for i in first.values()]
    p_max = max(a["psi"].shape[-1] for a in singles)
    for a in singles:
        for name in ("psi", "psi_c"):
            if name in a:
                a[name] = np.pad(a[name], ((0, 0), (0, 0),
                                           (0, p_max - a[name].shape[-1])))
    names = [n for n in singles[0] if n != "psi_c"]
    if all("psi_c" in a for a in singles):
        names.append("psi_c")
    cat = {name: np.concatenate([a[name] for a in singles], axis=0)
           for name in names}
    unique = _maps_to_device(cat, dtype, device)
    slot = {key: u for u, key in enumerate(first)}
    index = torch.as_tensor([slot[key] for key in keys], device=device)

    def repeat(x):
        return None if x is None else x.index_select(0, index)
    return FFATMaps(geom=DeviceFFAT(**{
        f.name: repeat(getattr(unique.geom, f.name))
        for f in dataclasses.fields(DeviceFFAT)}),
        cell_size=repeat(unique.cell_size))


def _take_face(arr: torch.Tensor, face: torch.Tensor) -> torch.Tensor:
    """arr [..., O, M, 6, ...] at per-(object, mode) face [..., O, M] ->
    [..., O, M, ...]."""
    d = face.dim()
    idx = face.long().reshape(face.shape + (1,) * (arr.dim() - d))
    idx = idx.expand(face.shape + (1,) + arr.shape[d + 1:])
    return torch.gather(arr, d, idx).squeeze(d)


def compute_transfer(ffat: FFATMaps, listener: torch.Tensor,
                     compressed: bool = False) -> torch.Tensor:
    """Transfer magnitudes |Psi(dir)/(k r)| for every (object, mode).

    ``listener``: [O, 3] listener position relative to each object's frame,
    or [3] (broadcast). Returns [O, M]. Leading dimensions batch: [L, O, 3]
    gives [L, O, M] in one call, each object's maps shared by its L rows,
    and every row equals the call on that row alone (gathers and
    elementwise math, reductions only within a row).

    Mirrors FFAT_Map<T,3>::GetMapVal (ffat_solver.h:1180-1214): slab-test
    ray from the listener toward the map center, nearest-plane face pick,
    bilinear interpolation with edge clamping on the outer shell, then the
    1/(kr) reconstruct (ffat_solver.h:899-906); computeTransfer takes the
    absolute value per mode (modal_solver.h:294-297). ``compressed=True``
    samples the second (compressed) Psi texture: the reference's
    useCompressed query flag (modal_solver.h:84-98).
    """
    g = ffat.geom
    if compressed:
        if g.psi_c is None:
            raise ValueError("FFAT maps were built without a compressed "
                             "Psi set (build_ffat compressed_maps=...)")
        g = dataclasses.replace(g, psi=g.psi_c)
    p = torch.atleast_2d(listener)                       # [..., O, 3]
    # per-object maps with a [3] listener widen to the geometry's count
    o = max(p.shape[-2], g.psi.shape[0])
    batch = p.shape[:-2]
    p = p.expand(batch + (o, 3))
    eps = torch.tensor(1e-30, dtype=p.dtype, device=p.device)

    def per_object(x):                           # [Og, ...] -> [..., O, ...]
        return x.expand(batch + (o,) + x.shape[1:])

    pm = p[..., None, :]                                 # [..., O, 1, 3]
    d = g.center - pm                                    # [O, M, 3]
    d_safe = torch.where(d.abs() < eps, eps, d)
    t_min = (g.bbox_low - pm) / d_safe
    t_max = (g.bbox_top - pm) / d_safe
    t_enter = torch.minimum(t_min, t_max)
    t_en = t_enter.amax(dim=-1, keepdim=True)            # [O, M, 1]
    surf = pm + t_en * d                                 # [O, M, 3]

    # face pick: first strict minimum over the C++ scan order
    # (low0, top0, low1, top1, low2, top2) -> faces (1, 0, 3, 2, 5, 4)
    d_low = (g.bbox_low - surf).abs()
    d_top = (g.bbox_top - surf).abs()
    dists = torch.stack([d_low[..., 0], d_top[..., 0],
                         d_low[..., 1], d_top[..., 1],
                         d_low[..., 2], d_top[..., 2]], dim=-1)
    scan_face = torch.tensor([1, 0, 3, 2, 5, 4], dtype=torch.int32,
                             device=p.device)
    face = scan_face[dists.argmin(dim=-1)]               # [O, M]

    dk = face // 2
    di = ((dk + 1) % 3).long()
    dj = ((dk + 2) % 3).long()

    def take_axis(arr3, axis_idx):                       # [O, M, 3] -> [O, M]
        return torch.gather(arr3, -1, axis_idx[..., None])[..., 0]

    low_f = _take_face(per_object(g.low_corners), face)  # [O, M, 3]
    ne_f = _take_face(per_object(g.n_elements), face)    # [O, M, 2]
    stride_f = _take_face(per_object(g.strides), face)   # [O, M]

    h = ffat.cell_size                                   # [Og, M]
    nu = ne_f[..., 0]
    nv = ne_f[..., 1]
    surf_i = take_axis(surf, di)
    surf_j = take_axis(surf, dj)
    low_i = take_axis(low_f, di)
    low_j = take_axis(low_f, dj)

    # bilinear stencil with edge clamping (ffat_solver.h:737-803)
    x_f = (surf_i - (low_i + 0.5 * h)) / h
    y_f = (surf_j - (low_j + 0.5 * h)) / h
    x = torch.floor(x_f).to(torch.int32)
    y = torch.floor(y_f).to(torch.int32)
    x_in = (x >= 0) & (x < nu - 1)
    y_in = (y >= 0) & (y < nv - 1)
    xc = torch.minimum(torch.clamp(x, min=0), nu - 1)
    yc = torch.minimum(torch.clamp(y, min=0), nv - 1)
    xp = torch.where(x_in, xc + 1, xc)
    yp = torch.where(y_in, yc + 1, yc)
    zero = torch.zeros_like(x_f)
    tx = torch.where(x_in, x_f - xc.to(x_f.dtype), zero).clamp(0.0, 1.0)
    ty = torch.where(y_in, y_f - yc.to(y_f.dtype), zero).clamp(0.0, 1.0)

    base = stride_f
    idx = torch.stack([base + xc * nv + yc, base + xp * nv + yc,
                       base + xc * nv + yp, base + xp * nv + yp],
                      dim=-1).long()                     # [O, M, 4]
    w = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty),
                     (1 - tx) * ty, tx * ty], dim=-1)
    vals = torch.gather(per_object(g.psi), -1, idx)      # [O, M, 4]
    psi = (vals * w).sum(dim=-1)                         # [O, M]

    r = torch.linalg.vector_norm(pm - g.center, dim=-1)  # [O, M]
    kr = g.k * torch.maximum(r, eps)
    return (psi / torch.maximum(kr, eps)).abs() * g.mode_mask
