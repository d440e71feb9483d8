"""The bake's scheduling a timeline event: the program's spans
``bake.schedule`` (the hit waves and sustained actions applied at one
block) in the traced window, summed, over the events they counted."""


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
    sched = s["name"] == names.index("bake.schedule")
    events = int(s["c0"][sched].sum())
    if not events:
        return None
    return float((s["t1"] - s["t0"])[sched].sum()) / 1e3 / events
