#!/usr/bin/env python3
"""The readings that a spatial cell's limit is set from, on the card, at
the cell's own size, as control.py takes them for the other cells but
through the binaural reference (entries/spatial.py): the program's
``rel_err`` on each seed; the control's, the reference put in the
program's place and computed in the precision below the configuration's
(float32 with every matrix product's operands rounded to TF32), on the
same recorded events; and two readings that show what the comparison
sees: the program against the reference with the interaural phase left
out (``no_itd``), and against the reference reading the raw texture in
place of the compressed one (``raw_texture``).

    python3 portbench/control_spatial.py --workload NAME --seeds 1,2,3 --seconds S

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
    from portbench import cells, harness
    from portbench.entries.spatial import reference_audio
    from portbench.reference.binaural import rel_err
    from portbench.run import set_environment
    set_environment()
    cell = cells.load(args.workload)
    cfg = cell["config"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.measure(cell, seed, args.seconds, False, args.device,
                              t, keep_run=True)
        run = out.pop("run")
        ref_scene = run["ref_scene"]
        variants = {
            "no_itd": dict(ref_scene, itd=False),
            "raw_texture": dict(ref_scene, maps=[
                dict(mp, psi=raw) for mp, raw in zip(ref_scene["maps"],
                                                     ref_scene["raw_psi"])]),
        }
        read = {"control": [], "no_itd": [], "raw_texture": []}
        for it in run["items"]:
            ref = reference_audio(cfg, ref_scene, it, args.device)
            low = reference_audio(cfg, ref_scene, it, args.device,
                                  control=True)
            read["control"].append(rel_err(low, ref))
            for name, scene in variants.items():
                read[name].append(rel_err(it["audio"], reference_audio(
                    cfg, scene, it, args.device)))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": out["checks"]["rel_err"]["value"],
                          **{k: max(v) for k, v in read.items()},
                          "correct": out["correct"],
                          "metrics": out["metrics"],
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
