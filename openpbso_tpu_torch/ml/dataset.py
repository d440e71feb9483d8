"""Training-set generation for material classification.

Counterpart of openpbso_tpu/ml/dataset.py. The reference's
scripts/create_training_set.py drives an *external* ``simulator`` binary
over 6 materials x objects to produce impact-sound banks
(scripts/util.py:8-9; that binary is not in the repo). Here the training
clips are synthesized by the port's own session, batched on the device:
one render per (material, hit) of every object of the material at once.

Also provides readers and writers for the reference's binary training-set
bank format (scripts/util.py Read_Training_Set: int32 count then float64
rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SAMPLE_RATE
from ..io.material import ModalMaterial

# the reference studies 6 materials (scripts/create_training_set.py); these
# are representative parameter sets from the modal-sound literature
MATERIALS = {
    "ceramic": ModalMaterial(2700.0, 7.2e10, 0.19, 6.0, 1e-7),
    "glass": ModalMaterial(2600.0, 6.2e10, 0.20, 1.0, 1e-7),
    "wood": ModalMaterial(750.0, 1.1e10, 0.25, 60.0, 2e-6),
    "plastic": ModalMaterial(1070.0, 1.4e9, 0.35, 30.0, 1e-6),
    "iron": ModalMaterial(7700.0, 2.1e11, 0.28, 5.0, 1e-8),
    "steel": ModalMaterial(7850.0, 2.0e11, 0.29, 5.0, 3e-8),
}


@dataclasses.dataclass
class TrainingClip:
    material: str
    object_id: int
    hit_id: int
    audio: np.ndarray  # [T] mono float


def material_bank(mat: ModalMaterial, objects: int, num_modes: int,
                  block: int, seed: int, device=None):
    """The heterogeneous bank of one material: object i gets its own random
    mode set (the JAX package's seeds and bands)."""
    from ..ops.coeffs import build_modal_bank, lambda_from_modes
    from ..utils.synth import synth_mode_data
    rows = [lambda_from_modes(mat.density, synth_mode_data(
        num_modes, 16, f_low=80.0 + 40.0 * i, f_high=9000.0 + 800.0 * i,
        seed=seed + 13 * i).omega_squared, mat.alpha, mat.beta)
        for i in range(objects)]
    lam, b, valid = (np.stack(x) for x in zip(*rows))
    return build_modal_bank(lam, b, valid, block_size=block, shared=False,
                            dtype=torch.float32, device=device)


def synthesize_dataset(
    *,
    materials: dict[str, ModalMaterial] | None = None,
    objects_per_material: int = 4,
    hits_per_object: int = 4,
    num_modes: int = 48,
    seconds: float = 0.5,
    block: int = 512,
    seed: int = 0,
    backend: str = "blocked",
    device: torch.device | str | None = None,
) -> list[TrainingClip]:
    """Render impact clips with the port's session, one batch per material
    and hit. ``backend`` is the session's: "blocked", or "auto" (the JAX
    package's "pallas" alike), which takes the fused kernel for these
    heterogeneous banks on the card. ``device`` None is the CUDA device
    (device.resolve_device)."""
    from ..runtime.session import ModalSession
    from ..runtime.solver import SolverConfig

    materials = materials or MATERIALS
    rng = np.random.default_rng(seed)
    n_blocks = int(seconds * SAMPLE_RATE) // block
    clips: list[TrainingClip] = []
    for mat_name, mat in materials.items():
        o = objects_per_material
        bank = material_bank(mat, o, num_modes, block, seed, device)
        for hit in range(hits_per_object):
            sess = ModalSession(bank, config=SolverConfig(
                block_size=block, backend=backend))
            for oo in range(o):
                sess.hit(oo, rng.standard_normal(num_modes),
                         kind="gaussian",
                         width_us=float(rng.uniform(60.0, 300.0)))
            raw = sess.render_raw(n_blocks)        # [O, T]
            for oo in range(o):
                clips.append(TrainingClip(mat_name, oo, hit,
                                          raw[oo].astype(np.float64)))
    return clips


def write_bank(path: str, rows: np.ndarray) -> None:
    """Reference bank format: int32 row count, then float64 rows
    (scripts/util.py Read_Training_Set layout)."""
    rows = np.asarray(rows, np.float64)
    with open(path, "wb") as f:
        np.asarray([rows.shape[0]], "<i4").tofile(f)
        rows.tofile(f)


def read_bank(path: str, row_len: int) -> np.ndarray:
    with open(path, "rb") as f:
        n = int(np.fromfile(f, "<i4", 1)[0])
        data = np.fromfile(f, "<f8", n * row_len)
    return data.reshape(n, row_len)


def features_matrix(clips: list[TrainingClip]) -> tuple[np.ndarray,
                                                        np.ndarray,
                                                        list[str]]:
    """(X [n, 68], y [n], label names) from clips (NaN rows filtered like
    scripts/util.py:88-114)."""
    from .features import clip_features
    labels = sorted({c.material for c in clips})
    xs, ys = [], []
    for c in clips:
        v = clip_features(c.audio)
        if np.isfinite(v).all():
            xs.append(v)
            ys.append(labels.index(c.material))
    return np.asarray(xs), np.asarray(ys), labels
