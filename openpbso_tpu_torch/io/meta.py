"""Model descriptors and data-directory conventions.

The port's own copy of what it uses of openpbso_tpu/io/meta.py. The
reference locates model data by convention over a data dir
(real_time_modal_sound.cpp:480-501): ``<name>.tet.obj``,
``<name>_surf.modes``, ``<name>_material.txt``, ``<name>_ffat_maps/`` (a
directory of ``*.fatcube``), with an optional ``freq_threshold.txt`` inside
the FFAT dir.
"""
from __future__ import annotations

import dataclasses
import os

from ..config import DEFAULT_AUDIBLE_FREQ


@dataclasses.dataclass
class ModelPaths:
    obj_file: str
    modes_file: str
    material_file: str
    ffat_dir: str


def resolve_model_dir(data_dir: str, name: str | None = None) -> ModelPaths:
    """Resolve model paths by naming convention.

    Mirrors real_time_modal_sound.cpp:480-501: if no name given, find the
    unique ``*.tet.obj`` in the dir and use its prefix.
    """
    if name is None:
        candidates = [f for f in sorted(os.listdir(data_dir))
                      if f.endswith(".tet.obj")]
        if not candidates:
            raise FileNotFoundError(f"no *.tet.obj found in {data_dir}")
        name = candidates[0][: -len(".tet.obj")]
    join = os.path.join
    return ModelPaths(
        obj_file=join(data_dir, f"{name}.tet.obj"),
        modes_file=join(data_dir, f"{name}_surf.modes"),
        material_file=join(data_dir, f"{name}_material.txt"),
        ffat_dir=join(data_dir, f"{name}_ffat_maps"),
    )


def read_freq_threshold(ffat_dir: str,
                        default: float = DEFAULT_AUDIBLE_FREQ) -> float:
    """Read ``freq_threshold.txt`` from the FFAT dir, else the 20 kHz default.

    Mirrors BuildSolver's culling threshold logic
    (real_time_modal_sound.cpp:316-329).
    """
    path = os.path.join(ffat_dir, "freq_threshold.txt")
    try:
        with open(path) as f:
            return float(f.readline().split()[0])
    except (OSError, ValueError, IndexError):
        return default
