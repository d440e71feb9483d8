"""The span tables a bake builds: the program's spans ``session.tables``
(a build of a chunk size's span tables and planes, or of an AR impulse
table, on a cache miss) inside the traced window's ``bake`` spans,
summed, over those bakes."""
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
    if record["kind"] != "bake" or (got := _spans(record)) is None:
        return None
    names, s = got
    bakes = s["name"] == names.index("bake")
    if not bakes.any():
        return None
    tables = ((s["name"] == names.index("session.tables"))
              & np.isin(s["trace"], s["trace"][bakes]))
    return float((s["t1"] - s["t0"])[tables].sum()) / 1e6 / int(bakes.sum())
