"""The host's wait for the card a block: the program's spans
``engine.copy`` (each device-to-host copy of a dispatch's audio, which
waits for the dispatch's device work) under the traced window's
``engine.synth`` spans, summed and divided by their blocks."""
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
    synth = s["name"] == names.index("engine.synth")
    copy = ((s["name"] == names.index("engine.copy"))
            & np.isin(s["parent"], s["index"][synth]))
    blocks = int(s["c0"][synth].sum())
    if not blocks:
        return None
    return float((s["t1"] - s["t0"])[copy].sum()) / 1e6 / blocks
