"""The 95th percentile of the engine's event application a dispatch: the
program's span ``engine.apply`` (the queued hits, drags, listener move
and AR retunes applied to the session) over the traced window's
dispatches, on the program's own clock."""
import numpy as np


def _spans(record):
    """The program's span names and its spans inside the traced window;
    None from a program without a span log, or when the log's ring
    overwrote spans of the window."""
    from openpbso_tpu_torch.runtime import profiling
    read = getattr(profiling, "spans", None)
    s = read and read(record["t0_ns"], record["t1_ns"])
    return None if s is None else (profiling.NAMES, s)


def read(record):
    if record["kind"] != "live" or (got := _spans(record)) is None:
        return None
    names, s = got
    apply = s["name"] == names.index("engine.apply")
    if not apply.any():
        return None
    return float(np.percentile((s["t1"] - s["t0"])[apply] / 1e6, 95))
