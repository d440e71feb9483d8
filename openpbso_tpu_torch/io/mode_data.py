"""Reader/writer for the ``.modes`` binary eigenmode format.

The port's own copy of what it uses of openpbso_tpu/io/mode_data.py.

File layout (reference ModeData.h:62-107): little-endian
``int32 nDOF, int32 nModes``, then ``nModes`` float64 eigenvalues
(omega^2 * density, i.e. *not* divided by density), then ``nModes`` rows of
``nDOF`` float64 modal displacements (3 DOF per surface vertex).

It loads straight into dense numpy arrays:
``omega_squared [M]`` and ``modes [M, nDOF]`` (row per mode) so that modal
force projection is a single matvec.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class ModeData:
    omega_squared: np.ndarray  # [M] float64, undivided-by-density eigenvalues
    modes: np.ndarray          # [M, nDOF] float64 modal displacements

    @property
    def num_modes(self) -> int:
        return int(self.omega_squared.shape[0])

    @property
    def num_dof(self) -> int:
        return int(self.modes.shape[1]) if self.modes.size else 0

    @property
    def num_vertices(self) -> int:
        return self.num_dof // 3

    def frequencies_hz(self, density: float) -> np.ndarray:
        """Natural frequencies in Hz (reference ModeData.h:129-131)."""
        return np.sqrt(self.omega_squared / density) / (2.0 * math.pi)

    def num_modes_audible(self, density: float, audible_freq: float) -> int:
        """Count of leading modes with frequency <= audible_freq.

        Mirrors reference ModeData.h:120-148: scans in order and stops at the
        first mode above the threshold (modes are assumed frequency-sorted).
        """
        if self.num_modes == 0:
            return 0
        freqs = self.frequencies_hz(density)
        if freqs[0] > audible_freq:
            return 0
        if freqs[-1] <= audible_freq:
            return self.num_modes
        return int(np.argmax(freqs > audible_freq))

    def mode_displacements(self, mode_index: int) -> np.ndarray:
        """[V, 3] displacement vectors of one mode (the mode-shape
        exports of apps/render_fields.py)."""
        return self.modes[mode_index].reshape(-1, 3)


def read_modes(path: str, dtype=np.float64) -> ModeData:
    """Load a ``.modes`` file (layout per reference ModeData.h:62-83)."""
    import os
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype="<i4", count=2)
        if header.size != 2:
            raise ValueError(f"truncated modes file: {path}")
        n_dof, n_modes = int(header[0]), int(header[1])
        if n_dof < 0 or n_modes < 0:
            raise ValueError(f"corrupt modes header ({n_dof}, {n_modes}): {path}")
        # bound the claimed payload against the actual file size BEFORE
        # np.fromfile pre-allocates count*8 bytes — a corrupt header
        # (e.g. 2^30 x 2^30) would otherwise demand exabytes instead of
        # reaching the truncation error below
        remaining = os.fstat(f.fileno()).st_size - f.tell()
        need = 8 * (n_modes + n_modes * n_dof)
        if need > remaining:
            raise ValueError(
                f"modes header claims {need} payload bytes but file has "
                f"{remaining}: {path}")
        omega_squared = np.fromfile(f, dtype="<f8", count=n_modes)
        modes = np.fromfile(f, dtype="<f8", count=n_modes * n_dof)
        if omega_squared.size != n_modes or modes.size != n_modes * n_dof:
            raise ValueError(f"truncated modes payload: {path}")
    return ModeData(
        omega_squared=omega_squared.astype(dtype),
        modes=modes.reshape(n_modes, n_dof).astype(dtype),
    )


def write_modes(path: str, data: ModeData) -> None:
    """Write a ``.modes`` file (layout per reference ModeData.h:87-107)."""
    n_modes = data.num_modes
    n_dof = data.num_dof
    with open(path, "wb") as f:
        np.asarray([n_dof, n_modes], dtype="<i4").tofile(f)
        np.asarray(data.omega_squared, dtype="<f8").tofile(f)
        np.asarray(data.modes, dtype="<f8").reshape(n_modes, n_dof).tofile(f)
