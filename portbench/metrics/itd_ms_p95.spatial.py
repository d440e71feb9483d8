"""The 95th percentile of a listener move's interaural phase: the
program's span ``session.itd`` (the delays from both ears' rows, the host
float64 phase, its cast and copy to the card, the cos and sin) over the
traced window, on the program's own clock."""
import numpy as np

NAME = "session.itd"


def read(record):
    """None outside the spatial entry, from a program without the span
    (or without a span log), or when the log's ring overwrote spans of
    the window."""
    if record["kind"] != "spatial":
        return None
    from openpbso_tpu_torch.runtime import profiling
    if NAME not in getattr(profiling, "NAMES", ()):
        return None
    s = profiling.spans(record["t0_ns"], record["t1_ns"])
    if s is None:
        return None
    mine = s["name"] == profiling.NAMES.index(NAME)
    if not mine.any():
        return None
    return float(np.percentile((s["t1"] - s["t0"])[mine] / 1e6, 95))
