"""The share of the span's slot table that produces: over the traced
window's bakes, the program's spans ``session.span`` that ran over K > 0
slots, the (object, slot) pairs live inside each (counter ``live``)
summed, over K x objects summed."""
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
    spans = ((s["name"] == names.index("session.span")) & (s["c0"] > 0)
             & np.isin(s["trace"], s["trace"][bakes]))
    table = int(s["c0"][spans].sum()) * record["config"]["objects"]
    if not table:
        return None
    return 100.0 * float(s["c1"][spans].sum()) / table
