"""The bakes' span work's share of its roofline: the least time an H100
could take for the traced window's span work (portbench/roofline.py,
reckoned from the bakes' own events: the excited (object, chunk) pairs
and the ringing objects of each dispatch) over the device busy time of
the bakes' renders (each traced render starts and ends in a device
synchronise, so the kernels inside its window are its own).

A render of n blocks at b blocks a dispatch is reckoned as its dispatches
of b blocks and the remainder; the one block a session's first render
steps alone to settle a listener ramp is reckoned as span work too."""
import numpy as np

from portbench import roofline
from portbench.reference.replay import host_pass
from portbench.trace import busy_in


def _dispatches(renders):
    """(first block, blocks) of every dispatch of the renders."""
    for _, _, _, clock, n, per, *_ in renders:
        for k in range(0, n, per):
            yield clock, k, min(per, n - k)


def read(record):
    if record["kind"] != "bake" or not record.get("renders"):
        return None
    cfg = record["config"]
    s, o, m = cfg["block_size"], cfg["objects"], cfg["modes"]
    og = 1 if cfg["shared_bank"] else o
    scene = dict(block=s, objects=o, slots=cfg["slots"],
                 rate=cfg["sample_rate"])
    by_bake = {}
    for r in record["renders"]:
        by_bake.setdefault(r[2], []).append(r)
    least = 0.0
    for i, renders in by_bake.items():
        events = record["bakes"][i][2]
        n_blocks = max(r[3] // s + r[4] for r in renders)
        blocks, _ = host_pass(scene, events, n_blocks, smooth=False)
        excited = [set(imp) | {d[0] for d in drg}
                   for imp, drg, _, _ in blocks]
        ever = np.zeros(n_blocks, np.int64)
        seen = set()
        for b, ex in enumerate(excited):
            seen |= ex
            ever[b] = len(seen)
        for clock, k, n in _dispatches(renders):
            b0 = clock // s + k
            c = roofline.chunk_size(n * s)
            pairs = sum(len(excited[b]) for b in range(b0, b0 + n))
            least += roofline.span_bound(
                excited=pairs * (s // c), ringing=int(ever[b0 + n - 1]),
                x=n * s // c, c=c, m=m, og=og)["seconds"]
    busy = busy_in(record["kernels"], [(a, b) for a, b, *_ in
                                       record["renders"]])
    if busy <= 0 or least <= 0:
        return None
    return 100.0 * least / (busy / 1e9)
