"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and draws the mix's events from the seed.

A mix names its entry (``"entry"``: a module of ``entries/``) and lists
its event families under ``"events"``, each ``{"family": NAME, ...}`` with
its parameters. A family is a file ``events/<NAME>.py`` with a ``live``
and/or a ``bake`` function, found by name, so a new kind of event is a new
file. The families draw in the order the mix lists them, from one
generator seeded by the run's seed:

- a live mix becomes a schedule of the engine's public calls by block:
  ``(block, (method, args, kwargs))``; the family that places the
  listener sets the stream's first listener rows (``ctx["first_rows"]``);
- a bake mix becomes a sequence of timelines in render_timeline's schema,
  one per bake: each family returns the timeline keys it adds to
  (``events``, ``sustained``); the listener is fixed for a bake and drawn
  last, from the mix's ``listener`` walk.

The same seed gives the same events; the program and the reference are
handed the same arrays. Every seed gets the same number of events of each
kind: the seed changes the objects, times, directions and values, not the
amount of work.

Listener rows are each object's offset from a listener walking over the
floor of objects (``walk``). The FFAT lookup picks the face of the
object's cubemap shell that the listener's ray enters by the nearest
plane, which is discontinuous where two faces meet; float32 and float64
cannot agree on a ray within ~1e-8 of such an edge, so every row is kept
``EDGE_MARGIN`` (relative) clear of the shell's edges (``clear_of_edges``:
about one row in 30 000 moves by less than 0.1 mm).
"""
from __future__ import annotations

import importlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
EDGE_MARGIN = 1e-5
KIND_NAMES = ("point", "gaussian", "hertz")


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def family(name: str):
    """The event family ``events/<name>.py``."""
    return importlib.import_module(f"portbench.events.{name}")


def clear_of_edges(rel: np.ndarray) -> np.ndarray:
    """Rows [..., 3] whose largest component exceeds the second largest by
    at least EDGE_MARGIN of itself (the ray from the row to the origin then
    enters a cube around the origin well inside one face)."""
    rel = np.array(rel, np.float64)
    flat = rel.reshape(-1, 3)
    mag = np.abs(flat)
    order = np.argsort(-mag, axis=1)
    rows = np.arange(flat.shape[0])
    top, second = mag[rows, order[:, 0]], mag[rows, order[:, 1]]
    bad = np.nonzero(top - second < EDGE_MARGIN * top)[0]
    ax = order[bad, 0]
    flat[bad, ax] += np.sign(flat[bad, ax]) * 2 * EDGE_MARGIN * top[bad]
    return flat.reshape(rel.shape)


def walk(rng, n: int, dt: float, bound: float, p: dict) -> np.ndarray:
    """A listener's world positions [n, 3] at steps of dt seconds: speed
    ``speed_m_s`` at height ``height_m``, turning towards a new heading
    (up to +-90 degrees) every ``turn_every_s``, reflected at the floor's
    edge ``bound``."""
    pos = np.zeros((n, 3))
    xy = rng.uniform(-bound, bound, 2)
    heading = rng.uniform(0, 2 * np.pi)
    target = heading
    turn_steps = max(1, int(round(p["turn_every_s"] / dt)))
    for i in range(n):
        if i % turn_steps == 0:
            target = heading + rng.uniform(-np.pi / 2, np.pi / 2)
        heading += (target - heading) * min(1.0, 4 * dt)
        xy = xy + p["speed_m_s"] * dt * np.array([np.cos(heading),
                                                   np.sin(heading)])
        for a in range(2):
            if abs(xy[a]) > bound:
                xy[a] = np.sign(xy[a]) * 2 * bound - xy[a]
                heading = (np.pi - heading) if a == 0 else -heading
                target = heading
        pos[i] = (xy[0], xy[1], p["height_m"])
    return pos


def listener_rows(world: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Each object's relative row [O, 3] of a world position [3]."""
    return clear_of_edges(world[None, :] - centers)


def floor_bound(cfg: dict, inputs: dict) -> float:
    return float(np.abs(inputs["centers"][:, :2]).max()
                 + cfg["layout"]["spacing_m"] / 2)


def contact(ctx: dict) -> np.ndarray:
    """A contact row drawn from the scene's pool."""
    pool = ctx["inputs"]["contacts"]
    return pool[ctx["rng"].integers(len(pool))]


def hit_call(ctx: dict, p: dict, objects, kind=None) -> tuple:
    """The engine's ``hit`` call of one strike with a family's ``width_us``
    and ``amp`` ranges: on ``objects`` (one object, or a pool to draw
    from), of ``kind`` (or one drawn)."""
    rng = ctx["rng"]
    obj = int(rng.choice(objects)) if np.ndim(objects) else int(objects)
    kind = kind or KIND_NAMES[rng.integers(len(KIND_NAMES))]
    width = float(rng.uniform(*p["width_us"]))
    amp = float(rng.uniform(*p["amp"]))
    row = contact(ctx)
    return ("hit", (obj, row), dict(kind=kind, width_us=width, amp=amp))


def live_schedule(mix: dict, cfg: dict, inputs: dict, seed: int,
                  n_blocks: int):
    """(first listener rows [O, 3], [(block, call)] ascending) of a live
    mix over n_blocks blocks; a call is (engine method, args, kwargs)."""
    ctx = dict(rng=np.random.default_rng([int(seed), 0x11FE]), cfg=cfg,
               inputs=inputs, n_blocks=n_blocks, first_rows=None)
    calls = []
    for p in mix["events"]:
        calls += family(p["family"]).live(p, ctx)
    if ctx["first_rows"] is None:
        raise ValueError("a live mix needs a family that places the "
                         "listener (such as 'listener')")
    calls.sort(key=lambda c: c[0])
    return ctx["first_rows"], calls


def bake_timeline(mix: dict, cfg: dict, inputs: dict, seed: int,
                  index: int):
    """(listener rows [O, 3], timeline) of bake ``index`` of a bake mix:
    render_timeline's schema, without listener keyframes (the listener is
    the session's, fixed for the bake) and with the drags' noise seed."""
    rng = np.random.default_rng([int(seed), 0xBA4E, int(index)])
    s, rate = cfg["block_size"], cfg["sample_rate"]
    duration = float(mix["duration_s"])
    ctx = dict(rng=rng, cfg=cfg, inputs=inputs,
               n_blocks=int(np.ceil(duration * rate / s)))
    parts = {}
    for p in mix["events"]:
        for key, items in family(p["family"]).bake(p, ctx).items():
            parts.setdefault(key, []).extend(items)
    timeline = {"duration_s": duration, "events": parts.pop("events", []),
                "smooth": bool(cfg["smooth_transfer"]),
                "seed": int(rng.integers(0, 2 ** 31))}
    timeline.update(parts)
    world = walk(rng, 1, s / rate, floor_bound(cfg, inputs), mix["listener"])
    return listener_rows(world[0], inputs["centers"]), timeline

