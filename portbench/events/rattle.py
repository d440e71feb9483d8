"""Soft strikes at every block from ``first_block`` on: ``hits_per_block``
of ``kind``, ``width_us`` wide, of amplitude ``amp``, on one of
``objects`` objects (drawn from the seed) in turn (a frozen copy of
openpbso_tpu_torch/bench/stream_ab.py::rattle_schedule: the load that
keeps an object's slot table full)."""
from portbench.generator import contact


def live(p: dict, ctx: dict) -> list:
    objs = ctx["rng"].choice(ctx["cfg"]["objects"], p["objects"],
                             replace=False)
    calls = []
    for b in range(p["first_block"], ctx["n_blocks"]):
        for _ in range(p["hits_per_block"]):
            calls.append((b, ("hit", (int(objs[b % len(objs)]), contact(ctx)),
                              dict(kind=p["kind"],
                                   width_us=float(p["width_us"]),
                                   amp=float(p["amp"])))))
    return calls
