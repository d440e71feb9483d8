"""A head walking over the floor of objects (generator.walk: speed
``speed_m_s`` at ``height_m``, a new heading every ``turn_every_s``), put
to the engine as a world position [3], so that the program's scene places
the two ears: the stream starts at the walk's first position
(``ctx["first_rows"]``, a world position) and moves to where the walk is
every ``move_every_blocks`` blocks.

Each position is nudged (by a fraction of a millimetre) until every ear's
row to every object is clear of the maps' shell edges, as the listener
family's rows are (generator.clear_of_edges)."""
import numpy as np

from portbench.generator import clear_of_edges, floor_bound, walk
from portbench.scenes.spatial_scene import ear_offsets

# the nudge: 0.2 mm along x, 0.4 mm along y (both differences between the
# row components that can tie change), more than twice the margin's width
NUDGE_M = np.asarray((2e-4, 4e-4, 0.0))


def clear_world(world: np.ndarray, centers: np.ndarray,
                ears: np.ndarray) -> np.ndarray:
    """``world`` [3], nudged until every ear's relative row is clear of the
    shell edges."""
    world = np.array(world, np.float64)
    for _ in range(100):
        rel = world[None, None, :] + ears[:, None, :] - centers[None]
        if np.array_equal(clear_of_edges(rel), rel):
            return world
        world += NUDGE_M
    raise RuntimeError(f"no head position near {world} clears the edges")


def live(p: dict, ctx: dict) -> list:
    cfg, inputs, n = ctx["cfg"], ctx["inputs"], ctx["n_blocks"]
    path = walk(ctx["rng"], n + 1, cfg["block_size"] / cfg["sample_rate"],
                floor_bound(cfg, inputs), p)
    ears = ear_offsets(cfg)

    def at(b):
        return clear_world(path[b], inputs["centers"], ears)
    ctx["first_rows"] = at(0)
    every = p["move_every_blocks"]
    return [(b, ("set_listener", (at(b),), {}))
            for b in range(every, n, every)]
