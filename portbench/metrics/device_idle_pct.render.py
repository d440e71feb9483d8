"""The device's idle share of the bakes: 1 minus the union of the
kernels' intervals inside the bakes over the bakes' summed wall time."""
from portbench.trace import busy_in


def read(record):
    if record["kind"] != "bake" or not record["bakes"]:
        return None
    windows = [(a, b) for a, b, _ in record["bakes"]]
    wall = sum(b - a for a, b in windows)
    busy = busy_in(record["kernels"], windows)
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
