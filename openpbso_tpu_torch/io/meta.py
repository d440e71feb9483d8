"""Model descriptors and data-directory conventions.

The port's own copy of openpbso_tpu/io/meta.py. The
reference locates model data two ways (real_time_modal_sound.cpp:480-501):

1. Convention over a data dir: ``<name>.tet.obj``, ``<name>_surf.modes``,
   ``<name>_material.txt``, ``<name>_ffat_maps/`` (a directory of
   ``*.fatcube``), with an optional ``freq_threshold.txt`` inside the FFAT dir.
2. A 4-line ``.meta`` descriptor file: obj path, modes path, material path,
   FFAT dir path (reference real_time_modal_sound.cpp:388-398).
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

    def exists(self) -> bool:
        return (
            os.path.isfile(self.obj_file)
            and os.path.isfile(self.modes_file)
            and os.path.isfile(self.material_file)
        )


def read_meta(path: str) -> ModelPaths:
    """Parse a 4-line .meta descriptor (real_time_modal_sound.cpp:388-398)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    if len(lines) < 4:
        raise ValueError(f"meta file needs 4 lines: {path}")
    return ModelPaths(*lines[:4])


def write_meta(path: str, paths: ModelPaths) -> None:
    with open(path, "w") as f:
        for p in (paths.obj_file, paths.modes_file,
                  paths.material_file, paths.ffat_dir):
            f.write(p + "\n")


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


def list_dir_files(dirname: str, contains: str = "") -> list[str]:
    """List full paths of regular files whose name contains ``contains``.

    Mirrors reference io.cpp:18-35 (sorted for determinism).
    """
    if not os.path.isdir(dirname):
        return []
    out = []
    for name in sorted(os.listdir(dirname)):
        full = os.path.join(dirname, name)
        if contains in name and os.path.isfile(full):
            out.append(full)
    return out


def prepare_meta_dir(data_root: str, out_dir: str | None = None,
                     relative: bool = False) -> list[str]:
    """Write a .meta descriptor for every model found under ``data_root``.

    The reference ships prepare_meta.sh, which emits 4-line meta files for
    each ``*.tet.obj`` model in a dataset directory; this is its in-library
    equivalent. Returns the written meta paths.
    """
    out_dir = out_dir or data_root
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(data_root)):
        if not name.endswith(".tet.obj"):
            continue
        prefix = name[: -len(".tet.obj")]
        paths = resolve_model_dir(data_root, prefix)
        if relative:
            paths = ModelPaths(*(os.path.relpath(p, out_dir)
                                 for p in (paths.obj_file, paths.modes_file,
                                           paths.material_file,
                                           paths.ffat_dir)))
        meta_path = os.path.join(out_dir, f"{prefix}.meta")
        write_meta(meta_path, paths)
        written.append(meta_path)
    return written
