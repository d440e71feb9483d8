#!/usr/bin/env python3
"""The readings that a cell's limit is set from, on the card, at the
cell's own size: the program's ``rel_err`` on each seed, and the
control's, the plain reference put in the program's place and computed
in the precision below the configuration's (float32 with every matrix
product's operands rounded to TF32), on the same recorded events.

    python3 portbench/control.py --workload NAME --seeds 1,2,3 --seconds S

One process builds each seed's scene in turn; a JSON line a seed. The
benchmark's own runs never run the control.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import cells, check, harness
    from portbench.run import set_environment
    set_environment()
    cell = cells.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.measure(cell, seed, args.seconds, False, args.device,
                              t, keep_run=True)
        run = out.pop("run")
        control = []
        for it in check.items(cell, run):
            ref = check.reference_audio(cell["config"], run["ref_scene"], it,
                                        args.device)
            low = check.reference_audio(cell["config"], run["ref_scene"], it,
                                        args.device, control=True)
            control.append(check.rel_err(low, ref))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": out["checks"]["rel_err"]["value"],
                          "control": max(control), "correct": out["correct"],
                          "metrics": out["metrics"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
