"""Minimal triangle-mesh IO + geometry helpers.

The port's own copy of openpbso_tpu/io/objmesh.py.

The runtime only needs: OBJ read (the ``.tet.obj`` surface meshes), per-vertex
normals (for modal force projection, reference real_time_modal_sound.cpp:509),
and icosphere generation (the transfer-ball HUD asset, reference
``assets/ball.obj``; we synthesize it instead of shipping binary assets).
"""
from __future__ import annotations

import numpy as np


def read_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an OBJ file -> (V [n,3] float64, F [m,3] int32).

    Supports v/f records with polygonal faces (fan-triangulated) and the
    ``v/vt/vn`` index syntax; everything else is ignored.
    """
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for j in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[j], idx[j + 1]])
    return (np.asarray(verts, np.float64),
            np.asarray(faces, np.int32).reshape(-1, 3))


def write_obj(path: str, v: np.ndarray, f: np.ndarray) -> None:
    with open(path, "w") as out:
        for row in v:
            out.write(f"v {row[0]} {row[1]} {row[2]}\n")
        for row in f:
            out.write(f"f {row[0]+1} {row[1]+1} {row[2]+1}\n")


def per_vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (matches libigl's default weighting)."""
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)  # length = 2x area
    vn = np.zeros_like(v)
    for c in range(3):
        np.add.at(vn, f[:, c], fn)
    norms = np.linalg.norm(vn, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return vn / norms


def icosphere(subdivisions: int = 3,
              radius: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Generate an icosphere (replaces the reference's assets/ball.obj)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
        np.float64)
    f = np.asarray(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        np.int64)
    for _ in range(subdivisions):
        cache: dict[tuple[int, int], int] = {}
        vlist = list(v)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                cache[key] = len(vlist)
                vlist.append((vlist[a] + vlist[b]) / 2.0)
            return cache[key]

        new_f = []
        for tri in f:
            a, b, c = (int(x) for x in tri)
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_f += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(vlist)
        f = np.asarray(new_f, np.int64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    return v, f.astype(np.int32)
