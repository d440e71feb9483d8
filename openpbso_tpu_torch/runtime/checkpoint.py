"""State persistence + live model hot-swap.

Counterpart of openpbso_tpu/runtime/checkpoint.py. The reference's
persistent-state story (SURVEY.md section 5) is FFAT/mode file
serialization plus a runtime model hot-swap that parks the sim thread
(LoadNewModel, real_time_modal_sound.cpp:347-474). Here:

- :func:`save_state` / :func:`load_state` — full SolverState snapshot to one
  ``.npz`` (every oscillator, force slot, sustained channel, and the sample
  clock), so a long render or live session can pause and resume exactly.
- :func:`save_session` / :func:`load_session` — the same with the session's
  host mirrors, which gate slot recycling and the idle fast path.
- :func:`swap_model` — pause the StreamingEngine, swap the session object,
  restart: the analog of the reference's mutex+condvar sim-thread parking.

The keys are ``leaf_<i>`` over the state's dataclass fields in declaration
order (``None`` fields skipped) plus the ``_session_*`` mirrors, the layout
of the JAX package's snapshots; the sustained channel's noise keys are
stored as this package's int64 words, so a file written here need not load
in the JAX package. A snapshot is device-free: one saved from a CUDA
session loads into a CPU session and back.
"""
from __future__ import annotations

import queue

import numpy as np
import torch

from ..config import SAMPLE_RATE
from .state import SolverState, map_state, state_leaves


def _flatten(state: SolverState) -> dict[str, np.ndarray]:
    return {f"leaf_{i}": (x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else np.asarray(x))
            for i, x in enumerate(state_leaves(state))}


def save_state(path: str, state: SolverState) -> None:
    np.savez_compressed(path, **_flatten(state))


def load_state(path: str, template: SolverState,
               _allow_session: bool = False) -> SolverState:
    """Restore a snapshot into the dtype and device of ``template``.

    Shapes must match (same scene dimensions); dtypes are cast to the
    template's. When restoring INTO a ModalSession, use load_session
    instead — it also refreshes the session's host mirrors (sample
    clock, slot expiry, sustained activity), which gate the decay fast
    path and slot recycling. Loading a *session* snapshot here is
    therefore refused: it would silently desync those mirrors (the next
    hit() could overwrite a slot that is still producing).
    """
    data = np.load(path)
    if "_session_expiry" in data and not _allow_session:
        raise ValueError(
            "this file is a save_session snapshot (it carries host "
            "slot/clock mirrors); restore it with load_session(path, "
            "session) so the mirrors stay in sync with the device state")
    leaves = state_leaves(template)
    n_data = len([k for k in data.files if k.startswith("leaf_")])
    if n_data != len(leaves):
        # e.g. a snapshot saved with a complex transfer (transfer_im is
        # an extra leaf) restored into a real-transfer template, or vice
        # versa: enumerating the template's leaves would silently drop
        # the phase leaf / die with a bare KeyError — fail structurally
        raise ValueError(
            f"checkpoint has {n_data} state leaves but the template has "
            f"{len(leaves)} — the state STRUCTURES differ (a snapshot "
            f"with a complex transfer installed must be restored into "
            f"a session with a complex transfer installed, and vice "
            f"versa)")
    restored = []
    for i, leaf in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if arr.shape != np.shape(leaf):
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != "
                f"template {tuple(np.shape(leaf))}")
        if isinstance(leaf, torch.Tensor):
            restored.append(torch.as_tensor(arr).to(leaf.dtype)
                            .to(leaf.device))
        else:
            restored.append(type(leaf)(arr))   # the integer block clock
    it = iter(restored)
    return map_state(lambda _: next(it), template)


def save_session(path: str, session) -> None:
    """Snapshot a ModalSession: device state + host slot-recycling mirrors.

    load_state alone restores the device arrays but not the session's
    _expiry/_t0 mirrors, which would let the next hit() overwrite a slot
    that is still producing; this pair keeps them in sync.
    """
    data = _flatten(session.state)
    data["_session_expiry"] = session._expiry
    data["_session_t0"] = session._t0
    # absolute host clock + device-time origin (the device block_start is
    # origin-rebased so its int32 never wraps; see session._maybe_rebase)
    data["_session_clock"] = np.asarray(session._clock, np.int64)
    data["_session_clock_base"] = np.asarray(session._clock_base, np.int64)
    # the float64 AR(2) host mirror: the span path builds its impulse
    # tables from THIS, not from the f32 device copy — restoring only
    # the device state would render retuned drags with default tables
    data["_session_ar_host"] = session._ar_host
    np.savez_compressed(path, **data)


def load_session(path: str, session) -> None:
    """Restore a save_session snapshot into ``session`` (shapes must match)."""
    data = np.load(path)
    if ("_session_expiry" in data
            and data["_session_expiry"].shape != session._expiry.shape):
        raise ValueError("checkpoint slot mirrors do not match the "
                         "session's slot table shape")
    session.state = load_state(path, session.state, _allow_session=True)
    if "_session_expiry" in data:
        session._expiry[...] = data["_session_expiry"]
        session._t0[...] = data["_session_t0"]
    # refresh the host clock + sustained-activity mirrors from the restored
    # state (they gate the idle decay fast path). Snapshots without the
    # clock keys hold absolute device time.
    if "_session_clock" in data:
        session._clock = int(data["_session_clock"])
        session._clock_base = int(data["_session_clock_base"])
    else:
        session._clock = int(session.state.block_start)
        session._clock_base = 0
    session._sus_active[...] = session.state.sustained.active.cpu().numpy()
    # AR(2) retunes live in a float64 host mirror (the span impulse
    # tables are built from it; session.py _ar_host). Without the key,
    # fall back to the f32 device copy (a hair of rounding vs the original
    # tuning, but consistent tables).
    if "_session_ar_host" in data:
        session._ar_host[...] = data["_session_ar_host"]
    else:
        session._ar_host[...] = (session.state.sustained.a.cpu().numpy()
                                 .astype(np.float64))
    session._ar_g = {}   # length-keyed cache of tables built from _ar_host
    session._xfade_from = None  # any pending smooth move predates the load


def swap_model(engine, new_session, prepare=None) -> None:
    """Hot-swap the engine's model mid-stream (LoadNewModel equivalent).

    Pauses synthesis, replaces the session (new bank/FFAT/state),
    restarts. ``prepare(old_session, new_session)``, when given, runs
    while the stream is parked, between the old session's last block and
    the new one's warmup (the listener-bucket grow carries the ring-down
    there, runtime/server.py). In-flight old-model blocks are DROPPED (not drained): the
    consume loop exits on the stop flag, and replaying stale blocks from
    a different model — possibly a different block size — through the
    new stream would be worse than a short gap. The stale-replay buffer
    is cleared for the same reason.
    """
    was_running = engine._synth_thread is not None and \
        engine._synth_thread.is_alive()
    if was_running:
        engine._stop.set()
        for t in (engine._synth_thread, engine._consume_thread):
            if t is None:
                continue
            # wait as long as it takes (see engine.stop): abandoning a
            # thread inside a device call leaves TWO synth threads racing
            # once start() clears the stop flag
            while t.is_alive():
                t.join(timeout=5.0)
    while True:
        try:
            engine._sound.get_nowait()
        except queue.Empty:
            break
    # drop pending COMMAND events too: they were validated against the
    # OLD model (a hit on object 200 of a 256-object bank would raise on
    # the synth thread after a swap to a 16-object model and kill the
    # new stream). Listener rows are re-seeded by the callers that swap.
    try:
        while True:
            engine._events.get_nowait()
    except queue.Empty:
        pass
    engine._arprm.take()
    engine._transfer.take()
    engine._last_block = None
    if prepare is not None:
        prepare(engine.session, new_session)
    engine.session = new_session
    engine.profiler = type(engine.profiler)(
        new_session.config.block_size, SAMPLE_RATE)
    if was_running:
        engine.start()
