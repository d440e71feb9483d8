"""A strike every ``every_s`` seconds on an object drawn from the seed, of
a kind, width (``width_us``) and amplitude (``amp``) drawn from it."""
import numpy as np

from portbench.generator import hit_call


def live(p: dict, ctx: dict) -> list:
    cfg = ctx["cfg"]
    every = p["every_s"] * cfg["sample_rate"] / cfg["block_size"]
    objects = np.arange(cfg["objects"])
    return [(int(round(k * every)), hit_call(ctx, p, objects))
            for k in range(1, int(ctx["n_blocks"] / every) + 1)]
