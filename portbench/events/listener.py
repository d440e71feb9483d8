"""The listener walking over the floor of objects (generator.walk: speed
``speed_m_s`` at ``height_m``, a new heading every ``turn_every_s``): the
stream starts at the walk's first position and moves to where the walk
is every ``move_every_blocks`` blocks."""
from portbench.generator import floor_bound, listener_rows, walk


def live(p: dict, ctx: dict) -> list:
    cfg, inputs, n = ctx["cfg"], ctx["inputs"], ctx["n_blocks"]
    path = walk(ctx["rng"], n + 1, cfg["block_size"] / cfg["sample_rate"],
                floor_bound(cfg, inputs), p)
    ctx["first_rows"] = listener_rows(path[0], inputs["centers"])
    every = p["move_every_blocks"]
    return [(b, ("set_listener", (listener_rows(path[b], inputs["centers"]),),
                 {})) for b in range(every, n, every)]
