"""Synthetic model/asset generation for tests and benchmarks.

The port's own copy of openpbso_tpu/utils/synth.py: the same seeds give
the same arrays and the same file bytes (tests/test_torch_io.py). The
reference ships only meta pointers to an external dataset, so both
packages generate physically plausible synthetic models: an icosphere
surface mesh, log-spaced modal frequencies with random orthonormal-ish mode
shapes, a ceramic-like material, and analytic FFAT cubemaps — all written in
the reference's exact file formats so the loaders are exercised end-to-end.
"""
from __future__ import annotations

import os

import numpy as np

from ..config import SOUND_SPEED
from ..io.fatcube import CubemapShell, FatcubeMap, save_fatcube
from ..io.material import ModalMaterial, write_material
from ..io.mode_data import ModeData, write_modes
from ..io.objmesh import icosphere, write_obj

# a ceramic-like modal material (density, E, nu, Rayleigh alpha/beta) in the
# range of the materials used by the modal-sound literature
CERAMIC = ModalMaterial(density=2700.0, youngs_modulus=7.2e10,
                        poisson_ratio=0.19, alpha=6.0, beta=1e-7,
                        name="synthetic-ceramic")


def synth_mode_data(num_modes: int, num_vertices: int, *,
                    material: ModalMaterial = CERAMIC,
                    f_low: float = 120.0, f_high: float = 15000.0,
                    seed: int = 0) -> ModeData:
    """Log-spaced audible frequencies + random unit mode shapes."""
    rng = np.random.default_rng(seed)
    freqs = np.geomspace(f_low, f_high, num_modes)
    omega = 2.0 * np.pi * freqs
    omega_squared = omega ** 2 * material.density  # undivided eigenvalues
    modes = rng.standard_normal((num_modes, num_vertices * 3))
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    return ModeData(omega_squared=omega_squared, modes=modes)


def synth_cubemap_shell(center: np.ndarray, half_extent: float,
                        n: int) -> CubemapShell:
    """A uniform n x n cubemap shell centered at ``center``."""
    center = np.asarray(center, np.float64)
    bbox_low = center - half_extent
    bbox_top = center + half_extent
    cell = 2.0 * half_extent / n
    low_corners = np.zeros((6, 3))
    n_elements = np.full((6, 2), n, np.int32)
    strides = np.arange(6, dtype=np.int32) * n * n
    for face in range(6):
        dk = face // 2
        di, dj = (dk + 1) % 3, (dk + 2) % 3
        lc = np.zeros(3)
        lc[di] = bbox_low[di]
        lc[dj] = bbox_low[dj]
        lc[dk] = bbox_top[dk] if face % 2 == 0 else bbox_low[dk]
        low_corners[face] = lc
    return CubemapShell(
        cell_size=cell, low_corners=low_corners, n_elements=n_elements,
        strides=strides, center=center, bbox_low=bbox_low, bbox_top=bbox_top)


def synth_fatcube(mode_id: int, freq_hz: float, *,
                  center=(0.0, 0.0, 0.0), half_extent: float = 0.2,
                  n: int = 20, seed: int = 0) -> FatcubeMap:
    """An analytic smooth directional amplitude map for one mode."""
    rng = np.random.default_rng(seed + mode_id)
    shell = synth_cubemap_shell(np.asarray(center, np.float64),
                                half_extent, n)
    k = 2.0 * np.pi * freq_hz / SOUND_SPEED
    # smooth positive lobe pattern over directions
    axes = rng.standard_normal((3, 3))
    psi = np.zeros(6 * n * n)
    for face in range(6):
        dk = face // 2
        di, dj = (dk + 1) % 3, (dk + 2) % 3
        for u in range(n):
            for v in range(n):
                pos = np.zeros(3)
                pos[di] = shell.low_corners[face, di] + (u + 0.5) * shell.cell_size
                pos[dj] = shell.low_corners[face, dj] + (v + 0.5) * shell.cell_size
                pos[dk] = shell.low_corners[face, dk]
                dirn = pos - shell.center
                dirn /= np.linalg.norm(dirn)
                val = 1.0
                for ax in axes:
                    val += 0.4 * np.tanh(dirn @ ax)
                psi[shell.strides[face] + u * n + v] = max(val, 0.05) * 1e6
    return FatcubeMap(mode_id=mode_id, k=k,
                      center=np.asarray(center, np.float64),
                      shell=shell, psi=psi)


def synth_model_dir(root: str, name: str = "synth", *,
                    num_modes: int = 24, subdivisions: int = 1,
                    material: ModalMaterial = CERAMIC,
                    ffat_n: int = 16, freq_threshold: float | None = 20000.0,
                    seed: int = 0) -> str:
    """Write a complete synthetic model directory in reference layout.

    Produces ``<name>.tet.obj``, ``<name>_surf.modes``,
    ``<name>_material.txt``, ``<name>_ffat_maps/*.fatcube`` (+ optional
    ``freq_threshold.txt``). Returns ``root``.
    """
    os.makedirs(root, exist_ok=True)
    v, f = icosphere(subdivisions=subdivisions, radius=0.05)
    write_obj(os.path.join(root, f"{name}.tet.obj"), v, f)
    modes = synth_mode_data(num_modes, v.shape[0], material=material,
                            seed=seed)
    write_modes(os.path.join(root, f"{name}_surf.modes"), modes)
    write_material(os.path.join(root, f"{name}_material.txt"), material,
                   comment="synthetic")
    ffat_dir = os.path.join(root, f"{name}_ffat_maps")
    os.makedirs(ffat_dir, exist_ok=True)
    freqs = modes.frequencies_hz(material.density)
    for mode_id in range(num_modes):
        m = synth_fatcube(mode_id, float(freqs[mode_id]), seed=seed)
        save_fatcube(os.path.join(ffat_dir, f"{mode_id:06d}.fatcube"), m)
    if freq_threshold is not None:
        with open(os.path.join(ffat_dir, "freq_threshold.txt"), "w") as fh:
            fh.write(f"{freq_threshold}\n")
    return root
