"""``count`` strikes at block ``block`` on distinct objects drawn from the
seed, point, gaussian and hertz in turn, widths and amps drawn from
``width_us`` and ``amp`` (chip_smoke.py phase 7d's opening strikes)."""
from portbench.generator import KIND_NAMES, hit_call


def live(p: dict, ctx: dict) -> list:
    objs = ctx["rng"].choice(ctx["cfg"]["objects"], p["count"],
                             replace=False)
    return [(p["block"], hit_call(ctx, p, obj, KIND_NAMES[i % 3]))
            for i, obj in enumerate(objs)]
