"""Sustained contacts (AR(2) drags under the session's one tuning).

Live: ``objects`` objects drawn from the seed start at ``start_block``
and take a new contact every ``update_every_blocks`` (chip_smoke.py phase
7d's drags). Bake: ``objects`` objects start in ``start_waves`` waves
``wave_blocks`` apart, take a new contact at each of ``update_s`` and end
at ``end_s``."""
from portbench.generator import contact


def live(p: dict, ctx: dict) -> list:
    dragged = ctx["rng"].choice(ctx["cfg"]["objects"], p["objects"],
                                replace=False)
    calls = []
    for b in range(p["start_block"], ctx["n_blocks"],
                   p["update_every_blocks"]):
        method = ("sustained_start" if b == p["start_block"]
                  else "sustained_update")
        for obj in dragged:
            calls.append((b, (method, (int(obj), contact(ctx)), {})))
    return calls


def bake(p: dict, ctx: dict) -> dict:
    import numpy as np
    cfg, rng = ctx["cfg"], ctx["rng"]
    s, rate = cfg["block_size"], cfg["sample_rate"]
    order = rng.permutation(cfg["objects"])[: p["objects"]]
    sustained = []
    for w, objs in enumerate(np.array_split(order, p["start_waves"])):
        t = w * p["wave_blocks"] * s / rate
        sustained += [{"t": t, "obj": int(obj), "action": "start",
                       "space": contact(ctx)} for obj in objs]
    for t in p["update_s"]:
        t = round(t * rate / s) * s / rate
        sustained += [{"t": t, "obj": int(obj), "action": "update",
                       "space": contact(ctx)} for obj in order]
    t_end = round(p["end_s"] * rate / s) * s / rate
    sustained += [{"t": t_end, "obj": int(obj), "action": "end"}
                  for obj in order]
    return {"sustained": sustained}
