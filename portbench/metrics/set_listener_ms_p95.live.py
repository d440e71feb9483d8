"""The 95th percentile of a listener move's time: the benchmark's clock
around each session.set_listener (the FFAT lookup of every object's
transfer row) in the traced window, closed by a device synchronise."""
import numpy as np


def read(record):
    ms = record.get("listener_ms") or []
    if record["kind"] != "live" or not ms:
        return None
    return float(np.percentile(ms, 95))
