"""A bake's strikes: every object struck ``per_object`` times at blocks
drawn uniformly over the timeline, point, gaussian and hertz in turn,
widths and amps drawn from ``width_us`` and ``amp``."""
from portbench.generator import KIND_NAMES, contact


def bake(p: dict, ctx: dict) -> dict:
    cfg, rng = ctx["cfg"], ctx["rng"]
    o, per = cfg["objects"], p["per_object"]
    s, rate = cfg["block_size"], cfg["sample_rate"]
    blocks = rng.integers(0, ctx["n_blocks"], size=(o, per))
    events = []
    for n in range(o * per):
        obj = n // per
        events.append({
            "t": float(blocks[obj, n % per]) * s / rate, "obj": obj,
            "space": contact(ctx), "kind": KIND_NAMES[n % 3],
            "width_us": float(rng.uniform(*p["width_us"])),
            "amp": float(rng.uniform(*p["amp"]))})
    return {"events": events}
