"""The host's share of a live block: 1 minus the union of the kernels'
intervals inside the engine's dispatches (events applied, block
synthesised, copied to the host) over the dispatches' summed wall time.
The paced waits between dispatches are left out."""
from portbench.trace import busy_in


def read(record):
    if record["kind"] != "live" or not record["dispatches"]:
        return None
    windows = [(a, b) for a, b, _ in record["dispatches"]]
    wall = sum(b - a for a, b in windows)
    busy = busy_in(record["kernels"], windows)
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
