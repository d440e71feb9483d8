#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout on a machine with an NVIDIA GPU. Builds the
cell's scene on the card from the seed, warms up, measures for the given
seconds and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit (also the last
lines of standard error). Exits non-zero with no result without a CUDA
device, when the cell needs more devices than there are, or when JAX or
the JAX package was loaded.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "openpbso_tpu")
CACHE = os.path.join(ROOT, ".portbench_cache")


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the port's benchmark may not
    load: each name's part before the first dot, compared whole (the port,
    openpbso_tpu_torch, is not openpbso_tpu)."""
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def set_environment() -> None:
    """Caches at fixed places inside the checkout; no library may load JAX
    on its own."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    sys.path.insert(0, ROOT)
    import torch
    from portbench import cells, harness
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    if torch.cuda.device_count() < cell["workload"]["chips"]:
        print(f"portbench: {args.workload} needs {cell['workload']['chips']} "
              f"devices, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    seed = args.seed % (1 << 63)
    out = harness.measure(cell, seed, args.seconds, bool(args.trace),
                          "cuda", T_PROC)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the port's benchmark may "
              "not load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
