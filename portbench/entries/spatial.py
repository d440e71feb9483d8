"""The spatial entry: the live entry's stream (entries/live.py: the
program's StreamingEngine played open loop into the paced audio device,
``run`` and ``host_spans`` unchanged) over a binaural scene, compared with
a reference of its own.

An entry with its own reference gives ``compare(cell, ref_scene, run,
device)`` in place of check.compare: here each ear's channel of the
stream against the two channels of reference/binaural.py, replaying the
events the program's session applied (the head's world positions, the
hits, drags and retunes), as ``rel_err`` over both channels. The readings
its limit is set from come from its own control script,
portbench/control_spatial.py, which runs the same reference in the
control's precision (control.py calls check.reference_audio, the mono
reference, directly).
"""
from __future__ import annotations

import numpy as np

from ..reference import binaural
from .live import host_spans, run  # noqa: F401  (the entry's run)


def reference_audio(cfg: dict, ref_scene: dict, item: dict, device,
                    control: bool = False) -> np.ndarray:
    """The reference's channels [N, L] of one compared stream; with
    ``control`` in the control's precision (float32, every matrix
    product's operands rounded to TF32)."""
    import torch
    n = item["audio"].shape[0] // cfg["block_size"]
    return binaural.render(
        ref_scene, item["events"], n, ar_seed=item["ar_seed"],
        smooth=cfg["smooth_transfer"],
        dtype=torch.float32 if control else torch.float64, device=device,
        tf32_products=control)


def compare(cell: dict, ref_scene: dict, run: dict, device) -> dict:
    """{"rel_err": {"value", "limit"}}: the largest over the run's
    streams of ||program - reference|| / ||reference|| over both ears."""
    errs = [binaural.rel_err(it["audio"], reference_audio(
        cell["config"], ref_scene, it, device)) for it in run["items"]]
    return {"rel_err": {"value": max(errs) if errs else float("inf"),
                        "limit": cell["limits"]["rel_err"]["limit"]}}
