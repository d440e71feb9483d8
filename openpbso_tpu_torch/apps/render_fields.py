"""render_fields — offline visualization exporter.

The port's counterpart of openpbso_tpu/apps/render_fields.py: the same
exports and flags; the transfer ball's lookup runs on the session's device
(the CUDA device for ``--transfer-ball``).

Headless re-design of the reference's GL viewer tools: the reference's
``render_fields`` binary animates superposed mode shapes next to colored
pressure-field slices and captures GL frames to numbered PNGs
(tools/render_fields.cpp:40-169, 241-289); the main tool's HUD additionally
shows per-mode FFAT images and the transfer ball. Without a display, this
tool exports the same artifacts as files:

- ``--mode-shapes``: per-frame OBJ meshes of sum_k U_k cos(omega_k t)
  displacement animation (render_fields.cpp:241-261 math).
- ``--fields DIR``: renders binary float32 field slices (the wavesolver's
  ``*.dat`` grids, default 424x424x88 layout per render_fields.cpp:86-98)
  to PNGs with a jet-style colormap.
- ``--ffat-images``: per-mode cubemap face images of a FFAT map dir
  (FFAT_Map::ConvertToImages equivalent, ffat_solver.h:1106-1122).
- ``--transfer-ball``: icosphere OBJ with per-vertex transfer magnitudes
  (real_time_modal_sound.cpp:917-927) written as a sidecar .npy.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.meta import resolve_model_dir
from ..io.objmesh import icosphere, write_obj


def _colormap_jet(x: np.ndarray) -> np.ndarray:
    """[...]->[..., 3] uint8 jet-like colormap (no matplotlib needed)."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def _write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal PNG writer (no external deps)."""
    import struct
    import zlib
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def export_mode_shapes(model, out_dir: str, *, mode_indices=None,
                       frames: int = 24, scale: float = 1e-3) -> list[str]:
    """OBJ animation frames of superposed mode displacement
    (sum_k U_k cos(omega_k t), render_fields.cpp:241-261)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for fr, v in enumerate(_mode_shape_frames(model, mode_indices, frames,
                                              scale)):
        path = os.path.join(out_dir, f"mode_shape_{fr:04d}.obj")
        write_obj(path, v, model.faces)
        paths.append(path)
    return paths


def _mode_shape_frames(model, mode_indices, frames: int, scale: float):
    """Yield displaced vertex arrays of the superposed mode animation —
    ONE implementation for the OBJ and PNG exports (sum_k U_k cos(w_k t),
    render_fields.cpp:241-261), normalized over one period of the
    slowest selected mode."""
    if mode_indices is None:
        mode_indices = list(range(min(4, model.num_modes_audible)))
    if not mode_indices:
        raise ValueError("no audible modes to animate (mode_indices is "
                         "empty; check freq_threshold.txt culling)")
    freqs = model.modes.frequencies_hz(model.material.density)
    base_f = min(freqs[i] for i in mode_indices)
    for fr in range(frames):
        t = fr / frames / base_f
        disp = np.zeros_like(model.vertices)
        for k in mode_indices:
            u = model.modes.mode_displacements(k)
            disp += u * np.cos(2 * np.pi * freqs[k] * t)
        yield model.vertices + scale * disp


def decode_field_plane(data: np.ndarray, nx: int, ny: int, nz: int,
                       z: int) -> np.ndarray | None:
    """Raw float32 field file -> one [ny, nx] plane, or None on a size
    mismatch. The reference memcpys the raw floats into a column-major
    Eigen (nx, ny) matrix (render_fields.cpp:121-127), so raw index
    ii = x + y*nx — x FASTEST — i.e. plane[y, x] = data[x + y*nx]
    (a Fortran reshape transposed every frame; round-5 review fix,
    consistent with the volume branch)."""
    if data.size == nx * ny:
        return data.reshape(ny, nx)
    if data.size >= nx * ny * nz:
        return data[: nx * ny * nz].reshape(nz, ny, nx)[z]
    return None


def render_field_slices(field_dir: str, out_dir: str, *,
                        nx: int = 424, ny: int = 424, nz: int = 88,
                        z_slice: int | None = None,
                        vmin: float | None = None,
                        vmax: float | None = None) -> list[str]:
    """Binary float32 field files -> colormapped PNGs.

    The reference's wavesolver emits ONE nx*ny plane per .dat file
    (render_fields.cpp:100-129: Plane::Load reads dims[0]*dims[1]
    floats, column-major Eigen), which is the primary format here; files
    carrying a full nx*ny*nz volume are also accepted (the z_slice plane
    is extracted). Files matching neither size are reported, not
    silently skipped."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    files = [f for f in sorted(os.listdir(field_dir))
             if f.endswith((".dat", ".bin", ".raw"))]
    z = nz // 2 if z_slice is None else z_slice
    for i, name in enumerate(files):
        data = np.fromfile(os.path.join(field_dir, name), "<f4")
        plane = decode_field_plane(data, nx, ny, nz, z)
        if plane is None:
            print(f"skipping {name}: {data.size} floats is neither a "
                  f"{nx}x{ny} plane nor a {nx}x{ny}x{nz} volume")
            continue
        lo = vmin if vmin is not None else np.percentile(plane, 2)
        hi = vmax if vmax is not None else np.percentile(plane, 98)
        norm = (plane - lo) / max(hi - lo, 1e-12)
        path = os.path.join(out_dir, f"field_{i:05d}.png")
        _write_png(path, _colormap_jet(norm))
        out.append(path)
    return out


def export_ffat_images(maps: dict, out_dir: str) -> list[str]:
    """Per-mode, per-face amplitude PNGs (ConvertToImages equivalent:
    the flat psi vector reshaped row-major per face,
    ffat_solver.h:1106-1122)."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for mode_id, m in sorted(maps.items()):
        peak = float(np.abs(m.psi).max()) or 1.0
        for face in range(6):
            nu, nv = (int(x) for x in m.shell.n_elements[face])
            start = int(m.shell.strides[face])
            img = m.psi[start: start + nu * nv].reshape(nu, nv) / peak
            path = os.path.join(out_dir, f"ffat_{mode_id:04d}_f{face}.png")
            _write_png(path, _colormap_jet(img))
            out.append(path)
    return out


def export_transfer_ball(session, out_dir: str, *,
                         subdivisions: int = 3,
                         radius: float = 1.0,
                         qnorm: np.ndarray | None = None
                         ) -> tuple[str, str]:
    """Icosphere + per-vertex transfer values (the HUD ball colored by
    log10(qnorm . transfer), real_time_modal_sound.cpp:917-979).

    With ``qnorm`` (per-mode energy from the engine's telemetry channel,
    shape [M] or [O, M] reduced over objects) the export reproduces the
    reference's live coloring: each direction weighted by the modes that
    are currently ringing; without it, the static sum over modes.
    """
    os.makedirs(out_dir, exist_ok=True)
    v, f = icosphere(subdivisions, radius)
    import torch

    from ..ops.ffat import compute_transfer
    vals = np.zeros(v.shape[0])
    if session.ffat is not None:
        # transfer per vertex direction: [V, M]
        t = compute_transfer(session.ffat, torch.as_tensor(
            np.asarray(v, np.float32),
            device=session.device)).cpu().numpy()
        if qnorm is not None:
            w = np.asarray(qnorm, np.float64)
            if w.ndim == 2:
                w = w.sum(axis=0)
            vals = t[:, : w.shape[0]] @ w
        else:
            vals = t.sum(axis=-1)
    obj_path = os.path.join(out_dir, "transfer_ball.obj")
    npy_path = os.path.join(out_dir, "transfer_ball_values.npy")
    write_obj(obj_path, v, f)
    np.save(npy_path, vals)
    return obj_path, npy_path


def render_mode_shape_frames(model, out_dir: str, *, mode_indices=None,
                             frames: int = 24, scale: float = 1e-3,
                             size: int = 512) -> list[str]:
    """PNG stills of the mode-shape animation, matcap-shaded — the headless
    equivalent of the reference viewer's captured GL frames
    (render_fields.cpp:40-84 CapturePlugin + matcap_shader.h)."""
    from .softrender import default_matcap, render_mesh
    os.makedirs(out_dir, exist_ok=True)
    mc = default_matcap()
    radius = np.abs(model.vertices).max()
    paths = []
    for fr, v in enumerate(_mode_shape_frames(model, mode_indices, frames,
                                              scale)):
        img = render_mesh(v, model.faces, width=size, height=size,
                          eye=np.asarray([1.6, 1.2, 2.2]) * radius,
                          matcap=mc)
        path = os.path.join(out_dir, f"frame_{fr:04d}.png")
        _write_png(path, img)
        paths.append(path)
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", dest="data_dir", required=False)
    p.add_argument("-name", dest="name", default=None)
    p.add_argument("--out-dir", default="viz")
    p.add_argument("--mode-shapes", action="store_true")
    p.add_argument("--render-frames", action="store_true",
                   help="matcap-shaded PNG stills of the mode animation")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--fields", default=None,
                   help="directory of binary float32 field slices")
    p.add_argument("--field-dims", default="424,424,88",
                   help="nx,ny,nz of the field files (reference default)")
    p.add_argument("--z-slice", type=int, default=None,
                   help="volume files: which z plane (default nz//2)")
    p.add_argument("--vmin", type=float, default=None,
                   help="pin the color scale floor (the reference pins "
                        "plane_vmin; default per-frame 2nd percentile)")
    p.add_argument("--vmax", type=float, default=None,
                   help="pin the color scale ceiling (default per-frame "
                        "98th percentile)")
    p.add_argument("--ffat-images", action="store_true")
    p.add_argument("--transfer-ball", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    model = None
    if args.data_dir:
        from ..models.modal_model import load_model
        model = load_model(resolve_model_dir(args.data_dir, args.name))
    if args.mode_shapes:
        if model is None:
            raise SystemExit("--mode-shapes needs -d")
        paths = export_mode_shapes(model,
                                   os.path.join(args.out_dir, "modes"),
                                   frames=args.frames)
        print(f"wrote {len(paths)} mode-shape frames")
    if args.render_frames:
        if model is None:
            raise SystemExit("--render-frames needs -d")
        paths = render_mode_shape_frames(
            model, os.path.join(args.out_dir, "stills"),
            frames=args.frames)
        print(f"wrote {len(paths)} matcap stills")
    if args.fields:
        nx, ny, nz = (int(v) for v in args.field_dims.split(","))
        paths = render_field_slices(args.fields,
                                    os.path.join(args.out_dir, "fields"),
                                    nx=nx, ny=ny, nz=nz,
                                    z_slice=args.z_slice,
                                    vmin=args.vmin, vmax=args.vmax)
        print(f"wrote {len(paths)} field slices")
    if args.ffat_images:
        if model is None:
            raise SystemExit("--ffat-images needs -d")
        paths = export_ffat_images(model.ffat_maps,
                                   os.path.join(args.out_dir, "ffat"))
        print(f"wrote {len(paths)} FFAT face images")
    if args.transfer_ball:
        if model is None:
            raise SystemExit("--transfer-ball needs -d")
        import torch

        from ..ops.coeffs import bank_from_material
        from ..ops.ffat import build_ffat
        from ..runtime.session import ModalSession
        bank = bank_from_material(
            model.material.density,
            model.modes.omega_squared[: model.num_modes_audible],
            model.material.alpha, model.material.beta, block_size=512,
            dtype=torch.float32)
        ffat = (build_ffat(model.ffat_maps, bank.num_modes,
                           dtype=torch.float32, device=bank.device)
                if model.ffat_maps else None)
        sess = ModalSession(bank, ffat=ffat)
        obj, npy = export_transfer_ball(sess, args.out_dir)
        print(f"wrote {obj} / {npy}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
