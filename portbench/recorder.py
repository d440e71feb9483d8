"""The session's applied events, kept for the plain reference to replay.

``Recorder`` wraps a session's public event methods on the instance: every
call made while ``on`` is kept as (sample clock, op, arguments), so that
the reference replays each event at the sample clock at which it applied.
"""
from __future__ import annotations

import time

import numpy as np


class Recorder:
    """Wraps a session's event methods on the instance: every call made
    while ``on`` is kept as (sample clock, op, arguments); with
    ``listener_timing`` each set_listener is also timed on the host clock,
    closed by a device synchronise."""

    def __init__(self, sess, listener_timing: bool = False):
        self.events, self.on = [], False
        self.listener_ms = []
        hit, setl = sess.hit, sess.set_listener
        start, update, end = (sess.sustained_start, sess.sustained_update,
                              sess.sustained_end)
        tune, clear = sess.set_ar_params, sess.clear_forces

        def keep(name, **kw):
            if self.on:
                self.events.append((sess.sample_clock, name, kw))

        def r_hit(obj, space, *, kind="point", width_us=100.0, amp=1.0,
                  when=None):
            keep("hit", obj=obj, space=space, kind=kind, width_us=width_us,
                 amp=amp, when=when)
            return hit(obj, space, kind=kind, width_us=width_us, amp=amp,
                       when=when)

        def r_listener(pos):
            keep("listener", rows=np.asarray(pos, np.float64))
            if not (listener_timing and self.on):
                return setl(pos)
            import torch
            t = time.perf_counter()
            setl(pos)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.listener_ms.append(1e3 * (time.perf_counter() - t))

        def r_start(obj, space):
            keep("drag", op="start", obj=obj, space=space)
            return start(obj, space)

        def r_update(obj, space):
            keep("drag", op="update", obj=obj, space=space)
            return update(obj, space)

        def r_end(obj):
            keep("drag", op="end", obj=obj)
            return end(obj)

        def r_tune(obj, a=(0.783, 0.116), sigma=0.00148, mu=0.142):
            keep("tune", obj=obj, a=tuple(a), sigma=sigma, mu=mu)
            return tune(obj, a, sigma, mu)

        def r_clear(obj=None):
            keep("clear", obj=obj)
            return clear(obj)

        sess.hit, sess.set_listener = r_hit, r_listener
        sess.sustained_start, sess.sustained_update = r_start, r_update
        sess.sustained_end, sess.set_ar_params = r_end, r_tune
        sess.clear_forces = r_clear
        self._session = sess

    NAMES = ("hit", "set_listener", "sustained_start", "sustained_update",
             "sustained_end", "set_ar_params", "clear_forces")

    def close(self) -> None:
        """Take the wrappers off the session: its own methods answer
        again, and nothing the recorder holds keeps the session alive."""
        sess, self._session = self._session, None
        if sess is not None:
            for name in self.NAMES:
                sess.__dict__.pop(name, None)
