"""Contact forces of the plain reference: the impact slots and the drag.

The upstream's force semantics (openpbso forces.h, modal_solver.h):

- an object holds ``slots`` impact records; a hit takes the first slot
  whose force has run out, else overwrites the one that started first;
- a record starts at a block boundary (now, or a later block for a
  future-dated hit) and produces while its block starts before its end:
  a point force for one block, a gaussian of width w samples for 10 w
  samples, a Hertz contact of w samples for w samples;
- within a block, an object's excitation is rank one: the sum of the
  time profiles of its producing records times the sum of their modal
  amplitudes;
- a drag (the sustained AR(2) contact) replaces the impacts of its object
  while it lasts, with profile mu + m[n], m[n] = a1 m[n-1] + a2 m[n-2] +
  sigma N(0, 1), the noise of block b of object o drawn from
  fold_in(key_o, b) (ar.py); a start or a retune zeroes the history.
"""
from __future__ import annotations

import math

import numpy as np

POINT, GAUSSIAN, HERTZ = 1, 2, 3
KINDS = {"point": POINT, "gaussian": GAUSSIAN, "hertz": HERTZ}
GAUSSIAN_CUTOFF = 5


def width_samples(kind: str, width_us: float, rate: float) -> float:
    if kind == "point":
        return 1.0
    return float(max(1, int(width_us / 1e6 * rate)))


def duration(ftype: int, width: float, block: int) -> int:
    """Samples during which a record can start a producing block, as the
    slot recycling counts them (a point force: its one block)."""
    if ftype == POINT:
        return block
    if ftype == GAUSSIAN:
        return int(GAUSSIAN_CUTOFF * 2 * max(width, 1.0))
    if ftype == HERTZ:
        return int(max(width, 1.0))
    return 0


def profile(ftype: int, width: float, local: np.ndarray) -> np.ndarray:
    """One record's force at local sample times ``local`` (float64)."""
    w = max(width, 1.0)
    t = local.astype(np.float64)
    if ftype == POINT:
        return (local == 0).astype(np.float64)
    if ftype == GAUSSIAN:
        center = math.floor((GAUSSIAN_CUTOFF - 0.5) * w)
        return np.exp(-0.5 * ((t - center) / w) ** 2)
    if ftype == HERTZ:
        ph = np.clip(t / w, 0.0, 1.0)
        return np.where((local >= 0) & (t < w),
                        np.sin(np.pi * ph) ** 1.5, 0.0)
    return np.zeros_like(t)


class Slots:
    """The impact records of every object and the drag channel, stepped
    block by block on the host."""

    def __init__(self, objects: int, slots: int, block: int, rate: float):
        self.block, self.rate = block, rate
        self.ftype = np.zeros((objects, slots), np.int64)
        self.t0 = np.zeros((objects, slots), np.int64)
        self.width = np.ones((objects, slots))
        self.amp = np.ones((objects, slots))
        self.expiry = np.zeros((objects, slots), np.int64)
        self.space = [[None] * slots for _ in range(objects)]
        # the drag channel
        self.active = np.zeros(objects, bool)
        self.sus_space = [None] * objects
        self.ar = [((0.783, 0.116), 0.00148, 0.142)] * objects
        self.reset = np.zeros(objects, bool)

    def hit(self, obj, space, kind, width_us, amp, when, now) -> None:
        ftype = KINDS[kind]
        width = width_samples(kind, width_us, self.rate)
        free = np.nonzero(self.expiry[obj] <= now)[0]
        slot = int(free[0]) if free.size else int(np.argmin(self.t0[obj]))
        t0 = now if when is None else int(when)
        self.ftype[obj, slot] = ftype
        self.t0[obj, slot] = t0
        self.width[obj, slot] = width
        self.amp[obj, slot] = amp
        self.space[obj][slot] = space
        self.expiry[obj, slot] = t0 + duration(ftype, width, self.block)

    def clear(self, obj) -> None:
        objs = range(len(self.active)) if obj is None else [obj]
        for o in objs:
            self.ftype[o] = 0
            self.expiry[o] = 0
            self.active[o] = False

    def drag(self, op: str, obj: int, space=None, a=None, sigma=None,
             mu=None) -> None:
        if op == "start":
            self.sus_space[obj] = space
            self.active[obj] = True
            self.reset[obj] = True
        elif op == "update":
            self.sus_space[obj] = space
        elif op == "end":
            self.active[obj] = False
        elif op == "tune":
            self.ar[obj] = (tuple(float(v) for v in a), float(sigma),
                            float(mu))
            self.reset[obj] = True

    def impacts(self, start: int):
        """The impact excitation of the block at ``start``: {object: (space
        rows, their sum's time profile [S])} for every object with a
        producing record and no drag."""
        local0 = start - self.t0
        w = np.maximum(self.width, 1.0)
        dur = np.where(self.ftype == POINT, 1,
                       np.where(self.ftype == GAUSSIAN,
                                (2 * GAUSSIAN_CUTOFF * w).astype(np.int64),
                                np.where(self.ftype == HERTZ,
                                         w.astype(np.int64), 0)))
        producing = (self.ftype > 0) & (local0 >= 0) & (local0 < dur)
        producing &= ~self.active[:, None]
        out = {}
        steps = np.arange(self.block)
        for o in np.nonzero(producing.any(axis=1))[0]:
            prof = np.zeros(self.block)
            rows = []
            for k in np.nonzero(producing[o])[0]:
                prof += self.amp[o, k] * profile(
                    int(self.ftype[o, k]), float(self.width[o, k]),
                    local0[o, k] + steps)
                rows.append(self.space[o][k])
            out[int(o)] = (rows, prof)
        return out
