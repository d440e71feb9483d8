"""A/B of the live stream's span paths between two checkouts, on one GPU.

    python -m openpbso_tpu_torch.bench.stream_ab \\
        --tree A=PATH --tree B=PATH [--out stream_ab.json]

Each turn runs, in a process of its own started in that checkout (its own
``openpbso_tpu_torch`` and ``chip_smoke.py``, its kernels built there at
first use), phase 7d's unpaced one-block and four-block span streams of
``chip_smoke.engine_stream`` (a lam64 session over phase 4's hetero 256 x
1024 scene, ``lookahead`` 1 and 4, with its hits, listener moves and
drags; every launch gate of the phase) from one seed, so each turn drives
the same stream; then the same two streams with a rattle on top
(``rattle_schedule``: soft hits on a few objects every block, so the
spans take the session's full slot table, K = 16 and 17 with the drags).
Turns go A B .. B A. Each stream's span contractions are counted by
shape and variant (``count_variants``) over the stream, its warmup left
out. Prints each turn's p50/p99 ms a block, blocks, dispatches and
variant counts as one JSON line and writes all of them to --out. Fails
without a CUDA device or when a turn fails.

Compare the parent commit with this checkout:

    git archive HEAD~ | tar -x -C _scratch/parent
    python -m openpbso_tpu_torch.bench.stream_ab \\
        --tree parent=_scratch/parent --tree change=.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import subprocess
import sys

RATTLED = 4               # objects that rattle, in turn
RATTLE_BLOCKS = (1, 150)  # the first block of the rattle and the one after
RATTLE_HITS = 2           # hits a block on the rattling object
RATTLE_WIDTH_US = 2500.0  # a soft gaussian hit: 10 widths, 2.3 blocks live


def rattle_schedule(engine, num_objects, num_modes, seed=0):
    """The events of a rattle as [(block, fn)] for chip_smoke.drive: at
    every block of RATTLE_BLOCKS, RATTLE_HITS soft gaussian hits on one of
    RATTLED objects in turn, each live for more than two blocks, so at
    every span dispatch an object holds more than one live force slot and
    the span takes the session's full slot table."""
    import numpy as np
    objects = list(range(1, num_objects, num_objects // RATTLED))[:RATTLED]
    spaces = np.random.default_rng(seed).standard_normal(
        (RATTLED, RATTLE_HITS, num_modes))

    def strike(b):
        i = b % len(objects)
        for space in spaces[i]:
            engine.hit(objects[i], space, kind="gaussian",
                       width_us=RATTLE_WIDTH_US, amp=0.5)
    return [(b, lambda b=b: strike(b)) for b in range(*RATTLE_BLOCKS)]


@contextlib.contextmanager
def count_variants():
    """While open, every launch of span_inject and span_reduce on a CUDA
    tensor is counted by its shape and the variant it takes (the wrappers'
    ``variant_for``): yields a dict {"span_inject K=.. X=.. C=..: variant"
    or "span_reduce rows=.. C=..: variant" (rows L R: K for g, X for hom):
    count}."""
    from openpbso_tpu_torch.ops import span_inject as k3
    from openpbso_tpu_torch.ops import span_reduce as k4
    counts = {}
    inject, reduce = k3.variant_for, k4.variant_for

    def add(key):
        counts[key] = counts.get(key, 0) + 1

    def inject_for(o, k, x, c, m, og):
        v = inject(o, k, x, c, m, og)
        add(f"span_inject K={k} X={x} C={c}: {v}")
        return v

    def reduce_for(o, nl, r, c, m, og):
        v = reduce(o, nl, r, c, m, og)
        add(f"span_reduce rows={nl * r} C={c}: {v}")
        return v
    k3.variant_for, k4.variant_for = inject_for, reduce_for
    try:
        yield counts
    finally:
        k3.variant_for, k4.variant_for = inject, reduce


# the turn's process: phase 4's scene and phase 7d's span streams from
# the checkout's own chip_smoke.py, the rattle and the count added around
# its drive() (the functions above, sent along as source)
TURN = r"""
import json, sys
import numpy as np
import torch
import chip_smoke as cs
seed = int(sys.argv[1])
rng = np.random.default_rng(seed)
modes = cs.hetero_modes(cs.O, cs.M)
scene = cs.session_scene(cs.hetero_bank(cs.O, cs.M, cs.S, None, modes), rng)
scene["engine_hits"] = [dict(h, when=None)
                        for h in scene["hits"][:cs.ENGINE_HITS]]
drive, rattle, seen = cs.drive, [False], []


def counted_drive(engine, n_blocks, schedule):
    if rattle[0]:
        schedule = sorted(schedule + rattle_schedule(engine, cs.O, cs.M),
                          key=lambda e: e[0])
    with count_variants() as counts:
        qnorm = drive(engine, n_blocks, schedule)
    seen.append(dict(counts))
    return qnorm


cs.drive = counted_drive
out = {"device": torch.cuda.get_device_name(0)}
for label, lookahead, rattled in (
        ("one-block spans", 1, False), ("four-block spans", 4, False),
        ("one-block spans, rattle", 1, True),
        ("four-block spans, rattle", 4, True)):
    rattle[0] = rattled
    e = cs.engine_stream(f"(ii) {label}", scene, modes[0], lookahead, rng)
    out[label] = dict({k: e["stats"][k] for k in (
        "p50_ms", "p95_ms", "p99_ms", "max_ms")}, blocks=e["blocks"],
        dispatches=e["dispatches"], launches=e["launches_of_stream"],
        variants=seen[-1])
print("stream turn:", json.dumps(out), flush=True)
"""


def turn(name: str, tree: str, seed: int) -> dict:
    tree = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=tree)
    code = "\n\n".join([
        "import contextlib",
        f"RATTLED, RATTLE_BLOCKS = {RATTLED}, {RATTLE_BLOCKS}",
        f"RATTLE_HITS, RATTLE_WIDTH_US = {RATTLE_HITS}, {RATTLE_WIDTH_US}",
        inspect.getsource(rattle_schedule), inspect.getsource(count_variants),
        TURN])
    proc = subprocess.run([sys.executable, "-c", code, str(seed)], cwd=tree,
                          env=env, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("stream turn:")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"turn {name} ({tree}) failed "
                           f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return dict(json.loads(lines[-1].split(":", 1)[1]), tree=name)


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=PATH of a checkout (repeatable)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="stream_ab.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stream_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = [t.split("=", 1) for t in args.tree]
    if not trees:
        parser.error("give at least one --tree NAME=PATH")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for name, tree in trees + trees[::-1]:
        turns.append(turn(name, tree, args.seed))
        print(json.dumps(turns[-1]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": smi, "turns": turns}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
