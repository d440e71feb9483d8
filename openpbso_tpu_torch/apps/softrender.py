"""Headless software renderer — screenshots without OpenGL.

The reference's viewer renders the object with a matcap shader (normal ->
sphere UV -> texture lookup, tools/matcap_shader.h) inside a GL window.
This module reproduces those stills headlessly: an orthographic z-buffer
rasterizer with per-vertex normals and either matcap shading (from a
generated or loaded spherical texture) or Lambertian shading, used by
render_fields for mode-shape frames and hit-flash previews.

Pure numpy; output is [H, W, 3] uint8 (write with render_fields._write_png).
The port's copy of openpbso_tpu/apps/softrender.py.
"""
from __future__ import annotations

import numpy as np


def look_at_rotation(eye: np.ndarray, target: np.ndarray,
                     up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """[3,3] rotation taking world coords to camera coords."""
    f = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    return np.stack([r, u, -f])


def default_matcap(size: int = 256) -> np.ndarray:
    """A generated metallic-ish matcap texture [size, size, 3] float."""
    y, x = np.mgrid[0:size, 0:size]
    u = (x + 0.5) / size * 2 - 1
    v = (y + 0.5) / size * 2 - 1
    r2 = np.clip(u * u + v * v, 0, 1)
    nz = np.sqrt(1 - r2)
    # key light upper-left + rim + base tone
    key = np.clip(0.7 * (-0.5 * u + 0.6 * v + 0.62 * nz), 0, 1) ** 1.5
    rim = np.clip(1 - nz, 0, 1) ** 3 * 0.35
    base = 0.22 + 0.55 * nz
    lum = np.clip(base + key + rim, 0, 1)
    tint = np.asarray([0.93, 0.95, 1.0])
    return lum[..., None] * tint[None, None, :]


def load_matcap(path: str) -> np.ndarray:
    """Load a matcap texture image -> [H, W, 3] float in [0, 1].

    The reference loads its ``-tex`` PNG into the GUI matcap shader
    (real_time_modal_sound.cpp:1179-1199); this is the headless
    equivalent, consumed by render_mesh(matcap=...).
    """
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float64) / 255.0


def render_mesh(
    v: np.ndarray,
    f: np.ndarray,
    vn: np.ndarray | None = None,
    *,
    width: int = 512,
    height: int = 512,
    eye=(1.6, 1.2, 2.2),
    target=(0.0, 0.0, 0.0),
    matcap: np.ndarray | None = None,
    face_colors: np.ndarray | None = None,
    background=(18, 18, 24),
) -> np.ndarray:
    """Rasterize a triangle mesh to [H, W, 3] uint8.

    Shading: matcap lookup from interpolated normals when ``matcap`` given
    (the reference's matcap shader math: n_eye.xy remapped to texture UV),
    else Lambertian; ``face_colors`` [F, 3] overrides albedo per face (the
    hit-flash highlight, real_time_modal_sound.cpp:611-616).
    """
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.int64)
    if vn is None:
        from ..io.objmesh import per_vertex_normals
        vn = per_vertex_normals(v, f)
    rot = look_at_rotation(np.asarray(eye), np.asarray(target))
    vc = (v - np.asarray(target)[None, :]) @ rot.T       # camera space
    nc = vn @ rot.T
    # orthographic fit
    span = np.abs(vc[:, :2]).max() * 1.15 or 1.0
    px = (vc[:, 0] / span * 0.5 + 0.5) * (width - 1)
    py = (1.0 - (vc[:, 1] / span * 0.5 + 0.5)) * (height - 1)
    depth = vc[:, 2]

    img = np.empty((height, width, 3), np.float64)
    img[:] = np.asarray(background, np.float64) / 255.0
    zbuf = np.full((height, width), -np.inf)

    tri_px = px[f]                                       # [F, 3]
    tri_py = py[f]
    order = np.argsort(depth[f].mean(axis=1))            # far to near
    mc = matcap if matcap is None else np.asarray(matcap)
    for fi in order:
        xs, ys = tri_px[fi], tri_py[fi]
        x0, x1 = int(max(np.floor(xs.min()), 0)), \
            int(min(np.ceil(xs.max()), width - 1))
        y0, y1 = int(max(np.floor(ys.min()), 0)), \
            int(min(np.ceil(ys.max()), height - 1))
        if x1 < x0 or y1 < y0:
            continue
        gx, gy = np.mgrid[x0:x1 + 1, y0:y1 + 1]
        gx = gx.T.astype(np.float64)
        gy = gy.T.astype(np.float64)
        d = ((ys[1] - ys[2]) * (xs[0] - xs[2])
             + (xs[2] - xs[1]) * (ys[0] - ys[2]))
        if abs(d) < 1e-12:
            continue
        w0 = ((ys[1] - ys[2]) * (gx - xs[2])
              + (xs[2] - xs[1]) * (gy - ys[2])) / d
        w1 = ((ys[2] - ys[0]) * (gx - xs[2])
              + (xs[0] - xs[2]) * (gy - ys[2])) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        vid = f[fi]
        z = w0 * depth[vid[0]] + w1 * depth[vid[1]] + w2 * depth[vid[2]]
        yy, xx = np.nonzero(inside)
        zi = z[yy, xx]
        py_idx = yy + y0
        px_idx = xx + x0
        closer = zi > zbuf[py_idx, px_idx]
        if not closer.any():
            continue
        py_idx, px_idx = py_idx[closer], px_idx[closer]
        zbuf[py_idx, px_idx] = zi[closer]
        wi = np.stack([w0[yy, xx][closer], w1[yy, xx][closer],
                       w2[yy, xx][closer]], axis=1)
        n = wi @ nc[vid]                                  # [P, 3]
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        if mc is not None:
            # matcap: n_eye.xy -> [0,1]^2 texture UV (matcap_shader.h)
            u = np.clip((n[:, 0] * 0.49 + 0.5), 0, 1)
            tv = np.clip((-n[:, 1] * 0.49 + 0.5), 0, 1)
            ti = (tv * (mc.shape[0] - 1)).astype(int)
            tj = (u * (mc.shape[1] - 1)).astype(int)
            shade = mc[ti, tj]
        else:
            lam = np.clip(n @ np.asarray([0.35, 0.45, 0.82]), 0.0, 1.0)
            shade = (0.15 + 0.85 * lam)[:, None] * \
                np.asarray([0.8, 0.82, 0.9])[None, :]
        if face_colors is not None:
            shade = shade * np.asarray(face_colors[fi])[None, :]
        img[py_idx, px_idx] = shade
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)
