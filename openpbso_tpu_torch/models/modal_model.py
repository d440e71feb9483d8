"""ModalSoundModel — one vibrating object's complete sound description.

The port's own copy of openpbso_tpu/models/modal_model.py. It bundles what
the reference loads per model (real_time_modal_sound.cpp:477-525): surface
mesh + normals, mode data, material, audible-mode culling, and the FFAT map
directory, and provides the modal force projection used when the user
strikes the surface (GetModalForceVertex / GetModalForceFace,
real_time_modal_sound.cpp:236-295). ``.fatcube`` files are decoded by the
Python codec (``io.fatcube``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DEFAULT_AUDIBLE_FREQ
from ..io.fatcube import FatcubeMap, load_all_fatcubes
from ..io.material import ModalMaterial, read_material
from ..io.meta import ModelPaths, read_freq_threshold
from ..io.mode_data import ModeData, read_modes
from ..io.objmesh import per_vertex_normals, read_obj


@dataclasses.dataclass
class ModalSoundModel:
    name: str
    vertices: np.ndarray          # [V, 3]
    faces: np.ndarray             # [F, 3]
    normals: np.ndarray           # [V, 3]
    material: ModalMaterial
    modes: ModeData
    num_modes_audible: int
    ffat_maps: dict[int, FatcubeMap]

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    def modal_force_vertex(self, vid: int,
                           normal: np.ndarray | None = None) -> np.ndarray:
        """Modal amplitudes for a hit at vertex ``vid`` along ``normal``.

        force[m] = n . mode_m[vid] over the audible modes
        (reference GetModalForceVertex, real_time_modal_sound.cpp:268-295).
        """
        n = self.normals[vid] if normal is None else np.asarray(normal)
        disp = self.modes.modes[: self.num_modes_audible]  # [M, 3V]
        vec = disp[:, 3 * vid: 3 * vid + 3]                # [M, 3]
        return vec @ n

    def modal_force_face(self, vids: np.ndarray, coords: np.ndarray,
                         normal: np.ndarray) -> np.ndarray:
        """Barycentric-interpolated hit over a face's three vertices.

        (reference GetModalForceFace, real_time_modal_sound.cpp:236-266 —
        note the reference uses one shared normal for all three corners.)
        """
        out = np.zeros(self.num_modes_audible)
        for vid, w in zip(vids, coords):
            out += w * self.modal_force_vertex(int(vid), normal)
        return out


def load_model(paths: ModelPaths, name: str = "",
               audible_freq: float | None = None) -> ModalSoundModel:
    """Load a model following BuildSolver (real_time_modal_sound.cpp:309-345).

    The culling threshold comes from ``freq_threshold.txt`` in the FFAT dir if
    present, else 20 kHz; an explicit ``audible_freq`` overrides both.
    """
    v, f = read_obj(paths.obj_file)
    vn = per_vertex_normals(v, f)
    material = read_material(paths.material_file)
    modes = read_modes(paths.modes_file)
    if audible_freq is None:
        audible_freq = read_freq_threshold(paths.ffat_dir,
                                           DEFAULT_AUDIBLE_FREQ)
    n_aud = modes.num_modes_audible(material.density, audible_freq)
    maps = load_all_fatcubes(paths.ffat_dir)
    if modes.num_dof != v.shape[0] * 3:
        raise ValueError(
            f"DOF mismatch: mesh has {v.shape[0] * 3}, modes have "
            f"{modes.num_dof} (reference asserts the same, "
            f"real_time_modal_sound.cpp:456)")
    return ModalSoundModel(
        name=name or paths.obj_file,
        vertices=v,
        faces=f,
        normals=vn,
        material=material,
        modes=modes,
        num_modes_audible=n_aud,
        ffat_maps=maps,
    )
