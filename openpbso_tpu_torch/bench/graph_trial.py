"""What a CUDA graph of the per-block step could save: a trial, not a path.

    python3 -m openpbso_tpu_torch.bench.graph_trial [--objects 256]

One busy block of a heterogeneous bank (every object with a live gaussian
slot, the fused backend) is stepped eagerly and by replaying a CUDA graph
captured from the same call, each followed by the copy of its mix to the
host, as the streaming engine does. The graph bakes the block clock in
(``SolverState.block_start`` is a Python int that ``force_block`` folds into
its arithmetic), so its replays compute one block over and over: the same
work as a stream's block, not a stream. It measures the host's share of a
synced block; a graph that could be kept needs the clock on the device and
one capture per (slot bucket, sustained) variant.

Prints the card's name and power limit, then one JSON line: the median and
p95 of the synced ms per block, eager and replayed, in turns A B B A, for
the one-slot bucket and the full slot table, with and without the sustained
channel, and the largest difference between the two outputs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..ops.coeffs import build_modal_bank, lambda_from_modes
from ..ops.forces import FORCE_GAUSSIAN
from ..runtime.solver import default_gains, step_block
from ..runtime.state import make_solver_state
from ..utils.synth import CERAMIC, synth_mode_data

S = 512
CALLS = 200


def _bank(o, n_modes):
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n_modes, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(o)]
    lam, b, valid = (np.stack(x) for x in zip(*parts))
    return build_modal_bank(lam, b, valid, block_size=S, shared=False)


def _state(bank, seed, dragging):
    o, m = bank.num_objects, bank.num_modes
    gen = torch.Generator(device=bank.device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=bank.device)
    state = make_solver_state(o, m, num_slots=16, device=bank.device)
    state.slots.ftype[:, 0] = FORCE_GAUSSIAN
    state.slots.width[:, 0] = 40.0
    state.slots.space[:, 0] = randn(o, m)
    if dragging:
        state.sustained.active[::8] = True
        state.sustained.space[:] = randn(o, m)
    return dataclasses.replace(
        state, z_re=randn(o, m) * bank.mask, z_im=randn(o, m) * bank.mask,
        transfer=torch.rand((o, m), generator=gen, device=bank.device) + 0.5)


def _synced_ms(fn, calls=CALLS):
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn().cpu()
        out.append(1e3 * (time.perf_counter() - t))
    return out


def trial(bank, gains, num_slots, dragging, seed):
    state = _state(bank, seed, dragging)
    kw = dict(block_size=S, backend="auto", num_slots=num_slots,
              with_sustained=dragging)

    def eager():
        return step_block(state, bank, gains, **kw)[2]

    for _ in range(3):      # first-use work stays outside the capture
        eager()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step_block(state, bank, gains, **kw)[2]

    def replay():
        graph.replay()
        return captured

    diff = float((replay().cpu() - eager().cpu()).abs().max())
    turns = {"eager": [], "graph": []}
    for name, fn in (("eager", eager), ("graph", replay), ("graph", replay),
                     ("eager", eager)):
        turns[name] += _synced_ms(fn)
    return {name: {"median_ms": statistics.median(ms),
                   "p95_ms": float(np.percentile(ms, 95))}
            for name, ms in turns.items()} | {"max_abs_diff": diff}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--objects", type=int, default=256)
    parser.add_argument("--modes", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    bank = _bank(args.objects, args.modes)
    gains = default_gains(args.objects)
    out = {"objects": args.objects, "modes": bank.num_modes, "block": S,
           "calls_per_turn": CALLS}
    for label, num_slots, dragging in (("one_slot", 1, False),
                                       ("full_table", None, False),
                                       ("full_table_drag", None, True)):
        out[label] = trial(bank, gains, num_slots, dragging, args.seed)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
