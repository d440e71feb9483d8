"""Whether the timed path's audio is correct: the plain reference replays
the events the program's session applied, from the same scene arrays,
and each compared number is held to its cell's limit.

``rel_err`` is ||program - reference|| / ||reference|| over the audio the
window produced (a live stream: every block from the first; a bake: each
sampled bake, the largest), both output channels against the reference's
one mix. The reference runs once the window has closed and the program's
state is freed.
"""
from __future__ import annotations

import numpy as np

from .reference import replay


def rel_err(audio: np.ndarray, ref: np.ndarray) -> float:
    audio = np.asarray(audio, np.float64).reshape(ref.shape[0], -1)
    err = np.sqrt(sum(np.sum((audio[:, c] - ref) ** 2)
                      for c in range(audio.shape[1])))
    norm = np.sqrt(audio.shape[1] * np.sum(ref ** 2))
    return float(err / norm) if norm > 0 else float("inf")


def reference_audio(cfg, ref_scene, item, device, control=False):
    """The reference's mix of one compared item (a stream or a bake); with
    ``control`` computed in the control's precision (float32, every
    matrix product's operands rounded to TF32)."""
    import torch
    n = item["audio"].shape[0] // cfg["block_size"]
    return replay.render(
        ref_scene, item["events"], n, ar_seed=item["ar_seed"],
        smooth=cfg["smooth_transfer"],
        dtype=torch.float32 if control else torch.float64, device=device,
        tf32_products=control)


def items(cell: dict, run: dict) -> list:
    """The compared items of a run, as its entry gives them: a live stream
    whole, or its sampled bakes."""
    return run["items"]


def compare(cell: dict, ref_scene: dict, run: dict, device) -> dict:
    """{name: {"value", "limit"}} of the cell's compared numbers."""
    errs = [rel_err(it["audio"], reference_audio(cell["config"], ref_scene,
                                                 it, device))
            for it in items(cell, run)]
    value = max(errs) if errs else float("inf")
    limit = cell["limits"]["rel_err"]["limit"]
    return {"rel_err": {"value": value, "limit": limit}}


def correct(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
