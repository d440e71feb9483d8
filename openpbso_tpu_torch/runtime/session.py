"""ModalSession — host-side control surface over the device solver.

Counterpart of openpbso_tpu/runtime/session.py: hits become force-slot
writes, sustained contacts (drags) become writes to the AR(2) channel,
listener moves become transfer recomputes (ramped across the next block
when ``SolverConfig.smooth_transfer`` is on), ``step``/``render`` advance
the stream block by block, ``render_multi`` advances it many blocks per
dispatch, through the chunked span when the session holds the float64
eigenvalues (``lam64``), and ``render_moving`` renders a listener path with
one transfer row per block, and ``render_doppler`` adds each object's
propagation delay to such a render. All take the cheaper homogeneous-only
step while the scene is provably idle. ``warmup`` runs every variant the
live loop can take once, so that no first-use cost lands inside a stream.

A session may carry L listeners over one oscillator state
(``num_listeners``): [L, O, M] transfer rows and one output channel per
listener; with the float64 eigenvalues it can derive each listener's
interaural time difference as a per-mode phase (``auto_itd``: complex
transfer rows). Scene (models/scene.py) builds such sessions and installs
a ``listener_frame`` that maps world positions into the session's
per-object relative frame.

Slot lifecycle is tracked on the host (a slot's productive lifetime is a
pure function of its start sample, ops/forces.py), mirroring the
reference's erase-on-exhaustion (modal_solver.h:210-221); when every slot
of an object is busy the oldest is overwritten (the reference's force
queue drops sends when full, modal_solver.h:330-333).

Slot and channel writes are deliberately in place: the session owns its
state, and an indexed write into the existing tensors is the PyTorch form
of the JAX package's donated scatter (openpbso_tpu/runtime/session.py:33-43),
which also reused the buffers. Inside ``batched_writes`` the event methods
stage their writes on the host, and the batch applies them as one indexed
write a state leaf when it ends.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib

import numpy as np
import torch

from ..config import REBASE_PERIOD, SAMPLE_RATE, SOUND_SPEED, UNIT_TRANSFER
from ..ops.coeffs import ModalBank
from ..ops.doppler import delay_indices, delay_resample, sample_distances
from ..ops.ffat import FFATMaps, compute_transfer
from ..ops.forces import (FORCE_GAUSSIAN, FORCE_HERTZ, FORCE_POINT,
                          ar_impulse_g, ar_stability_radius, slot_duration,
                          span_group)
from ..ops.integrator import resolve_backend_name
from ..ops.span import build_span_tables, choose_radix, with_planes
from ..ops.integrator import decay_block_blocked
from . import profiling
from .solver import (SolverConfig, decay_block, decay_span_step,
                     default_gains, step_block, step_block_xfade, step_multi,
                     step_multi_transfers, step_multi_transfers_sound,
                     step_span, step_span_sound)
from .state import clone_state, make_solver_state


def _index(i, n: int) -> int:
    """``i`` as a row of an axis of ``n``: negative counts from the end,
    out of range raises IndexError, as indexing the axis does."""
    i = int(i)
    if not -n <= i < n:
        raise IndexError(f"index {i} is out of bounds for an axis of {n}")
    return i % n


def _row_each(value: torch.Tensor, ndim: int) -> torch.Tensor:
    """``value`` [n, ...] as one row each of an ``ndim``-axis indexed
    result: trailing axes of one element added, to broadcast."""
    return value.reshape(tuple(value.shape)
                         + (1,) * (ndim - value.dim()))


class ModalSession:
    """A batch of sounding objects driven block by block.

    ``bank`` holds O objects x M modes on its device; ``ffat`` is optional
    (unit transfer when absent or when ``use_transfer`` is off,
    modal_solver.h:249-255). Every tensor the session creates lives on the
    bank's device.
    """

    def __init__(
        self,
        bank: ModalBank,
        ffat: FFATMaps | None = None,
        config: SolverConfig | None = None,
        num_slots: int = 16,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        lam64: np.ndarray | None = None,
        num_listeners: int = 1,
    ):
        """``lam64``: the float64 complex eigenvalues the bank was built
        from (lambda_from_modes), [M] or [O, M]. Optional; with it the
        session builds span tables (ops/span.py) and render_multi takes the
        chunked span instead of the block-by-block loop.

        ``num_listeners`` > 1 switches to shared-state multi-listener
        rendering: one [O, M] oscillator state with [L, O, M] transfer rows
        and one output channel per listener (sound is linear in the
        transfer, so each extra listener costs a mode-reduce, not an L-fold
        copy of the state and forces). Listener moves pass [3], [L, 3] or
        [L, O, 3] positions. 0 and 1 both mean one listener."""
        # read at every step, never cached: the engine swaps it
        # (dataclasses.replace) to turn qnorm on for single blocks
        self.config = config or SolverConfig()
        self.bank = bank
        self.ffat = ffat
        self.device = bank.device
        self._lam64 = (None if lam64 is None
                       else np.atleast_2d(np.asarray(lam64, np.complex128)))
        # what the bank's table cache knows these eigenvalues by: their
        # bytes, so that sessions on one bank from other eigenvalues never
        # share span tables
        self._lam_key = (None if self._lam64 is None else (
            self._lam64.shape,
            hashlib.blake2b(self._lam64.tobytes(), digest_size=16).digest()))
        self._span_cache: dict[int, object] = {}   # chunk size -> tables
        o, m = bank.num_objects, bank.num_modes
        # the sustained channel's noise is a pure function of (per-object
        # keys from this seed, block index): a session seeded alike replays
        # its drags exactly
        self.seed = int(seed)
        self.num_listeners = int(num_listeners)
        self.state = make_solver_state(o, m, num_slots=num_slots,
                                       seed=self.seed, dtype=dtype,
                                       num_listeners=self.num_listeners,
                                       device=self.device)
        self.gains = (torch.ones((o, self.num_listeners), dtype=dtype,
                                 device=self.device)
                      if self.num_listeners > 1
                      else default_gains(o, dtype, self.device))
        self.use_transfer = ffat is not None
        # which Psi texture transfer queries sample (the compressed one:
        # GetMapVal(pos, useCompressed), ffat_solver.h:1180-1214)
        self.use_compressed = False
        self._dtype = dtype
        # host mirror for slot recycling: absolute expiry sample per slot
        self._expiry = np.zeros((o, num_slots), np.int64)
        self._t0 = np.zeros((o, num_slots), np.int64)
        self._last_listener: np.ndarray | None = None
        # host mirror of the sample clock, so the idle test never syncs
        self._clock = 0
        # device time origin: state.block_start == _clock - _clock_base
        # (rebased periodically so the int32 slot clock never wraps)
        self._clock_base = 0
        # host mirror of sustained activity, so the idle test never syncs
        self._sus_active = np.zeros((o,), bool)
        # host mirror of the per-object AR(2) coefficients (the default of
        # make_sustained_state): the source of the span's impulse tables;
        # _ar_g caches the device tables, keyed by (length, shared), until
        # a retune of ``a``
        self._ar_host = np.tile(np.asarray([[0.783, 0.116]]), (o, 1))
        self._ar_g: dict[tuple[int, bool], torch.Tensor] = {}
        # (re, im) transfer rows before the latest listener move, pending
        # one interpolated block (smooth_transfer)
        self._xfade_from: tuple | None = None
        # an optional world-to-session map applied to every listener
        # position set_listener receives (Scene installs one, so that the
        # engine's listener events land in the per-object relative frame)
        self.listener_frame = None
        # multi-listener sessions with lam64: derive per-mode interaural
        # time differences from the geometry on every move
        self.auto_itd = False
        # the event writes staged by an open batched_writes, by leaf: [the
        # rows' kind (whole object or one slot), {row key: value}]; None
        # while no batch is open
        self._staged: dict[str, list] | None = None
        # the device writes the session's events have made (one a
        # _write_rows call, or one a leaf when a batch applies)
        self.event_writes = 0

    @property
    def devices(self) -> tuple:
        """The devices the session's dispatches run on: the bank's."""
        return (self.device,)

    # ------------------------------------------------------------ events

    @property
    def sample_clock(self) -> int:
        """Host mirror of the absolute block clock (no device sync)."""
        return self._clock

    def _alloc_slot(self, obj: int) -> int:
        now = self.sample_clock
        free = np.nonzero(self._expiry[obj] <= now)[0]
        if free.size:
            return int(free[0])
        return int(np.argmin(self._t0[obj]))  # overwrite the oldest

    def _modal_vector(self, space: np.ndarray) -> np.ndarray:
        """[M] float64 host row from modal amplitudes [M_audible]
        (zero-padded or cut to the bank's modes); the write rounds it to
        the state's dtype."""
        m = self.bank.num_modes
        vec = np.zeros((m,), np.float64)
        space = np.asarray(space, np.float64).ravel()
        vec[: min(space.size, m)] = space[: m]
        return vec

    def hit(self, obj: int, space: np.ndarray, *,
            kind: str = "point", width_us: float = 100.0,
            amp: float = 1.0, when: int | None = None) -> None:
        """Strike object ``obj`` with modal amplitudes ``space`` [M_audible].

        ``kind``: 'point' (unit impulse), 'gaussian' (width in microseconds,
        converted to samples as in forces.h:42-46), or 'hertz' (width =
        contact duration in microseconds). The profile starts at the next
        block, like a dequeued ForceMessage; ``when`` (an absolute,
        block-aligned sample >= the current clock) schedules it later.
        """
        vec = self._modal_vector(space)
        if kind == "point":
            ftype, width = FORCE_POINT, 1.0
        elif kind == "gaussian":
            ftype = FORCE_GAUSSIAN
            width = max(1, int(width_us / 1e6 * SAMPLE_RATE))
        elif kind == "hertz":
            ftype = FORCE_HERTZ
            width = max(1, int(width_us / 1e6 * SAMPLE_RATE))
        else:
            raise ValueError(f"unknown force kind {kind!r}")
        dur = slot_duration(ftype, width, self.config.block_size)
        slot = self._alloc_slot(obj)
        t0 = self.sample_clock
        if when is not None:
            if when < t0 or when % self.config.block_size:
                raise ValueError(
                    f"when={when} must be a block-aligned sample >= the "
                    f"current clock {t0}")
            t0 = int(when)
        self._write_rows("slots.ftype", obj, ftype, slot)
        self._write_rows("slots.t0", obj, t0 - self._clock_base,
                         slot)   # origin-rebased
        self._write_rows("slots.width", obj, float(width), slot)
        self._write_rows("slots.amp", obj, amp, slot)
        self._write_rows("slots.space", obj, vec, slot)
        self._t0[obj, slot] = t0
        self._expiry[obj, slot] = t0 + dur

    def clear_forces(self, obj: int | None = None) -> None:
        """Drop all active forces, sustained contacts included
        (clearAllForces, modal_solver.h:186-189)."""
        objs = np.arange(self.bank.num_objects) if obj is None else [obj]
        objs = np.asarray(objs)
        self._write_rows("slots.ftype", objs, 0)
        self._write_rows("sustained.active", objs, False)
        self._expiry[objs] = 0
        self._sus_active[objs] = False

    def sustained_start(self, obj: int, space: np.ndarray) -> None:
        """Begin a sustained AR contact on ``obj`` with modal amplitudes
        ``space`` (modal_solver.h:190-194); the AR history restarts."""
        self._write_rows("sustained.space", obj, self._modal_vector(space))
        self._write_rows("sustained.ar_hist", obj, 0.0)
        self._write_rows("sustained.active", obj, True)
        self._sus_active[obj] = True

    def sustained_update(self, obj: int, space: np.ndarray) -> None:
        """Live-update the sustained force direction
        (modal_solver.h:197-199)."""
        self._write_rows("sustained.space", obj, self._modal_vector(space))

    def sustained_end(self, obj: int) -> None:
        self._write_rows("sustained.active", obj, False)
        self._sus_active[obj] = False

    def set_ar_params(self, obj: int, a=(0.783, 0.116), sigma=0.00148,
                      mu=0.142) -> None:
        """Retune the AR(2) model of ``obj`` live (forces.h:130-137); resets
        its history. An unstable or non-finite ``a`` (characteristic root
        magnitude >= 1, ops/forces.py::ar_stability_radius) is rejected
        before any state changes: its impulse tables would overflow."""
        radius = ar_stability_radius(a)
        if not radius < 1.0:      # NaN-safe: rejects radius >= 1 and NaN
            raise ValueError(
                f"unstable AR(2) tuning a={tuple(float(v) for v in a)}: "
                f"characteristic root magnitude {radius:.4f} >= 1 (the "
                f"impulse tables would overflow)")
        a64 = np.array(a, np.float64)    # a copy: a batch may hold it
        self._write_rows("sustained.a", obj, a64)
        self._write_rows("sustained.sigma", obj, sigma)
        self._write_rows("sustained.mu", obj, mu)
        self._write_rows("sustained.ar_hist", obj, 0.0)
        # the cached span tables depend on ``a`` alone: a sigma/mu retune
        # keeps them
        if not np.array_equal(self._ar_host[obj], a64):
            self._ar_host[obj] = a64
            self._ar_g = {}

    @contextlib.contextmanager
    def batched_writes(self):
        """Apply the enclosed events' device writes together, on leaving:
        one index write a state leaf, from one host-to-device copy of its
        rows, in place of a write (and for a modal row a synchronising
        copy) an event call. The event methods still validate, allocate
        slots and update the host mirrors at once; only their device
        writes wait. Of several writes to one row the last wins, as in
        the calls made one by one, and the state after the batch is
        bitwise theirs. Nested batches act as one: the outermost applies.
        An exception inside applies the writes staged before it, then
        propagates. Until the batch ends the device state lags the host
        mirrors, so it holds event calls only: a dispatch inside it
        raises."""
        if self._staged is not None:
            yield
            return
        self._staged = {}
        try:
            yield
        finally:
            staged, self._staged = self._staged, None
            for leaf, (per_slot, rows) in staged.items():
                self._apply_staged(leaf, per_slot, rows)

    def _write_rows(self, leaf: str, obj, value, slot: int | None = None
                    ) -> None:
        """Write ``value`` in place into the rows ``obj`` (an object index
        or an array of them; with ``slot``, that slot of each) of the state
        leaf named ``leaf`` ("slots.space", "sustained.active", ...): a
        scalar, or a host row (float64 numpy, rounded to the leaf's dtype)
        that each row takes. Every in-place event write goes through here:
        at once, or staged while a batched_writes is open."""
        if self._staged is None:
            self._put_rows(leaf, obj, value, slot)
            self.event_writes += 1
            return
        if isinstance(obj, (int, np.integer)):
            objs = (_index(obj, self.bank.num_objects),)
        else:
            objs = np.arange(self.bank.num_objects)[np.asarray(obj)]
            objs = objs.reshape(-1).tolist()
        per_slot = slot is not None
        run = self._staged.get(leaf)
        if run is not None and run[0] != per_slot:
            # whole-object rows and slot rows of one leaf overlap: apply
            # the earlier kind before staging the other
            self._apply_staged(leaf, *self._staged.pop(leaf))
            run = None
        if run is None:
            run = self._staged[leaf] = [per_slot, {}]
        rows = run[1]
        if per_slot:
            s = _index(slot, self._expiry.shape[1])
            for o in objs:
                rows[(o, s)] = value
        else:
            for o in objs:
                rows[(o,)] = value

    def _apply_staged(self, leaf: str, per_slot: bool, rows: dict) -> None:
        """One leaf's staged rows (each key its last value) as one write:
        the values stacked on the host as the calls gave them (float64
        rows, or Python scalars: one kind a leaf), so that the write rounds
        them to the leaf's dtype as it rounds a value written alone."""
        keys = np.asarray(list(rows), np.int64)
        self._put_rows(leaf, keys[:, 0], np.array(list(rows.values())),
                       keys[:, 1] if per_slot else None)
        self.event_writes += 1

    def _put_rows(self, leaf: str, obj, value, slot=None) -> None:
        """The device write of _write_rows. ``obj`` is an index or an
        array of them, ``slot`` None, an index or an array beside ``obj``;
        ``value`` a scalar or a host row, or with an array of rows a host
        array of one row each (its trailing axes broadcast over a row's).
        A sharded session (parallel/session.py) routes each row to the
        shards that own it."""
        group, name = leaf.split(".")
        t = getattr(getattr(self.state, group), name)
        if isinstance(value, np.ndarray):
            value = torch.as_tensor(value).to(t.dtype).to(t.device)
        if isinstance(obj, np.ndarray):
            if isinstance(value, torch.Tensor):
                value = _row_each(value, t.dim() - (slot is not None))
            # the indices in one copy
            idx = tuple(torch.from_numpy(np.stack(
                [obj] if slot is None else [obj, slot]).astype(np.int64))
                .to(t.device))
        else:
            idx = obj if slot is None else (obj, slot)
        t[idx] = value

    def _current_transfer(self) -> tuple:
        """The (re, im) transfer rows in use, im None for a real row."""
        return self.state.transfer, self.state.transfer_im

    def _install_transfer(self, transfer: torch.Tensor,
                          transfer_im: torch.Tensor | None) -> None:
        """Replace the transfer rows ([(L,) O, M] on the bank's device);
        a sharded session scatters them to its shards."""
        self.state = dataclasses.replace(self.state, transfer=transfer,
                                         transfer_im=transfer_im)

    def set_listener(self, pos: np.ndarray) -> None:
        """Update the acoustic transfer for a listener at ``pos``: [3]
        (shared) or [O, 3] per object, relative to each object's frame
        (computeTransfer + the latest-wins trans queue,
        modal_solver.h:286-300); multi-listener sessions take [3], [L, 3]
        or [L, O, 3]. An installed ``listener_frame`` maps world positions
        into the session's relative frame first; callers that already hold
        relative positions use set_listener_relative."""
        if self.listener_frame is not None:
            pos = self.listener_frame(np.asarray(pos, np.float64))
        self.set_listener_relative(pos)

    def _listener_rows(self, pos: np.ndarray) -> np.ndarray:
        """A listener position as the session's relative rows: [O, 3], or
        [L, O, 3] with listeners ([3] puts every listener at one spot,
        [L, 3] gives each its own; a single listener also takes its one
        row, [1, 3] or [1, O, 3]); a shape that fits neither raises."""
        o, nl = self.bank.num_objects, self.num_listeners
        if nl > 1:
            if pos.shape == (3,):
                pos = np.broadcast_to(pos, (nl, 3))
            if pos.shape == (nl, 3):
                pos = np.broadcast_to(pos[:, None, :], (nl, o, 3))
            if pos.shape != (nl, o, 3):
                raise ValueError(
                    f"expected a [3], [{nl}, 3] or [{nl}, {o}, 3] listener "
                    f"position, got {pos.shape}")
            return pos
        # one listener row, [1, 3] or [1, O, 3] (a per-client bucket of
        # one), is that listener's position, as the JAX package reads it
        if pos.shape == (1, o, 3):
            pos = pos[0]
        if pos.shape in ((3,), (1, 3)):
            return np.broadcast_to(pos.reshape(3), (o, 3))
        if pos.shape != (o, 3):
            raise ValueError(f"expected a [3] or [{o}, 3] listener "
                             f"position, got {pos.shape}")
        return pos

    def _lookup(self, rows: torch.Tensor) -> torch.Tensor:
        """FFAT transfer rows of device positions [..., O, 3] -> [..., O,
        M] from the selected texture: one compute_transfer call per [O, 3]
        or [L, O, 3] row (all listeners at once: each listener's row equals
        a single-listener call bitwise), so a path block's rows equal
        set_listener's."""
        if rows.dim() <= 2 + (self.num_listeners > 1):
            return compute_transfer(self.ffat, rows,
                                    compressed=self.use_compressed
                                    ).to(self._dtype)
        return torch.stack([self._lookup(r) for r in rows.unbind(dim=0)])

    def itd_delays(self, rows: np.ndarray) -> np.ndarray:
        """Interaural delays [L, O] in samples for relative rows [L, O, 3]:
        listener l hears object o (r_lo - min_l r_lo) / c after the nearest
        listener. The distances are taken in host float64 from the rows as
        the device holds them (cast to the session dtype)."""
        dt = torch.empty((), dtype=self._dtype).numpy().dtype
        r = np.linalg.norm(np.asarray(rows, dt).astype(np.float64), axis=-1)
        return ((r - r.min(axis=0, keepdims=True))
                * (SAMPLE_RATE / SOUND_SPEED))

    def set_listener_relative(self, pos: np.ndarray) -> None:
        """set_listener in the session's native per-object frame: the
        lookup is the span ``session.lookup`` (listener rows, compressed
        texture read), the interaural phase ``session.itd`` (listener
        rows, modes)."""
        rows = self._listener_rows(np.asarray(pos, np.float64))
        self._last_listener = np.asarray(pos, np.float64)
        if self.ffat is None or not self.use_transfer:
            return
        tok = profiling.begin(profiling.LOOKUP)
        transfer = self._lookup(torch.as_tensor(
            np.ascontiguousarray(rows)).to(self._dtype).to(self.device))
        profiling.end(tok, self.num_listeners, int(self.use_compressed))
        if self.config.smooth_transfer and self._xfade_from is None:
            # remember the outgoing rows (re and im: a complex row ramps
            # both); the next block ramps to the new one (repeated moves
            # within one block keep the oldest start)
            self._xfade_from = self._current_transfer()
        if (self.auto_itd and self.num_listeners > 1
                and self._lam64 is not None):
            # interaural time differences from the geometry: a per-mode
            # phase e^{-i theta_m d} is a delay of d samples for a
            # narrowband mode (theta = omega_d h); the phase is formed in
            # host float64 and cast, and cos and sin run on the device
            tok = profiling.begin(profiling.ITD)
            o, m = self.bank.num_objects, self.bank.num_modes
            theta = np.zeros((o, m))
            lam = np.broadcast_to(self._lam64, (o, self._lam64.shape[-1]))
            theta[:, : lam.shape[-1]] = np.angle(lam)
            phase = torch.as_tensor(
                theta[None] * self.itd_delays(rows)[:, :, None]).to(
                    self._dtype).to(self.device)
            self._install_transfer(transfer * torch.cos(phase),
                                   -transfer * torch.sin(phase))
            profiling.end(tok, self.num_listeners, m)
            return
        # FFAT lookups are magnitude-only: a complex row's phase does not
        # survive the move
        self._install_transfer(transfer, None)

    def set_complex_transfer(self, t: np.ndarray) -> None:
        """Install a complex transfer ([O, M] or [L, O, M]): the imaginary
        part applies a per-mode phase, which for a narrowband mode is a
        time shift at that mode's frequency (exact interaural time
        differences) on the blocked, scan and span forms; the fused kernel
        takes real rows only, so such a session steps through the blocked
        form (solver._step_block_impl). A later set_listener (a
        magnitude-only FFAT lookup) clears the phase; with smooth_transfer
        a mid-stream install ramps both channels across the next block."""
        t = np.asarray(t)
        if self.config.smooth_transfer and self._xfade_from is None:
            self._xfade_from = self._current_transfer()

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x)).to(
                self._dtype).to(self.device)
        self._install_transfer(dev(t.real), dev(t.imag))

    def set_use_compressed(self, use: bool) -> None:
        """Runtime compressed-vs-raw FFAT toggle: which Psi texture transfer
        queries sample (TransMessage.useCompressed, modal_solver.h:84-98;
        the ImGui toggle, real_time_modal_sound.cpp:835-853). Takes effect
        at once by recomputing the transfer from the last listener
        position; both textures are resident (DeviceFFAT.psi_c), so nothing
        is rebuilt."""
        use = bool(use)
        if use and (self.ffat is None or self.ffat.geom.psi_c is None):
            raise ValueError(
                "FFAT maps carry no compressed Psi set (build with "
                "build_ffat(compressed_maps=...))")
        if use == self.use_compressed:
            return
        self.use_compressed = use
        if (self.ffat is not None and self.use_transfer
                and self._last_listener is not None):
            self.set_listener_relative(self._last_listener)

    def set_use_transfer(self, use: bool) -> None:
        """Toggle FFAT transfer vs the 1E7 unit transfer
        (modal_solver.h:249-255); re-enabling recomputes from the last
        listener position at once."""
        self.use_transfer = use and self.ffat is not None
        if not use:
            self._install_transfer(
                torch.full_like(self._current_transfer()[0], UNIT_TRANSFER),
                None)
        elif self._last_listener is not None:
            self.set_listener_relative(self._last_listener)

    # ----------------------------------------------------------- gating

    def _maybe_rebase(self) -> None:
        """Before a dispatch: refuse one inside a batch of event writes,
        and re-zero the device clock origin before int32 wrap of the slot
        clock. The subtraction is quantized to whole multiples of
        REBASE_PERIOD, so the device clock is always ``absolute clock mod
        REBASE_PERIOD`` at a step, however the stream was chunked. Expired
        slots' t0 is clamped (their producing predicate is false forever,
        so the clamp changes no output)."""
        if self._staged is not None:
            raise RuntimeError("a dispatch inside batched_writes: the "
                               "staged event writes are not applied yet")
        delta = self._clock - self._clock_base
        if delta >= REBASE_PERIOD:
            sub = (delta // REBASE_PERIOD) * REBASE_PERIOD
            self._shift_clock(sub)
            self._clock_base += sub

    def _shift_clock(self, sub: int) -> None:
        """Move the device clock origin ``sub`` samples later: every
        slot's t0 and the block clock drop by ``sub`` (in place)."""
        self.state.slots.t0.sub_(sub).clamp_(min=-(1 << 30))
        self.state = dataclasses.replace(
            self.state, block_start=self.state.block_start - sub)

    def decay_eligible(self) -> bool:
        """Whether this session can take the idle fast path: it needs the
        lam-power tables of the block size and a table-form backend, so a
        decay block is numerically the full step with zero excitation."""
        if not self.config.decay_fast_path:
            return False
        if (self.bank.pow_re is None
                or self.bank.pow_re.shape[-1] != self.config.block_size + 1):
            return False
        return resolve_backend_name(self.config.backend,
                                    self.bank) in ("blocked", "fused")

    def _idle(self) -> bool:
        """True when the host mirrors prove the excitation is exactly zero:
        every force slot has expired and no sustained channel is active."""
        return (not self._sus_active.any()
                and bool((self._expiry <= self._clock).all()))

    def _with_sustained(self) -> bool:
        """Whether any sustained channel is active (host mirror): when none
        is, the AR(2) channel's terms are exact zeros and the step skips
        it."""
        return bool(self._sus_active.any())

    def _slot_bucket(self, ignore_sustained: bool = False) -> int | None:
        """The smallest configured slot bucket covering every live slot
        index (the host expiry mirror knows which slots can still
        produce), or None for the full table. The per-block path of a
        session with an active sustained channel takes the full table, as
        the JAX session does; the span passes ``ignore_sustained``, since
        an unpruned table on a long span is gigabytes of [O, K, N]
        intermediates."""
        if self._sus_active.any() and not ignore_sustained:
            return None
        k = self._expiry.shape[1]
        live = self._expiry > self._clock
        need = (int(np.max(np.nonzero(live.any(axis=0))[0])) + 1
                if live.any() else 1)
        for b in sorted(set(self.config.slot_buckets)):
            if need <= b < k:
                return b
        return None

    # ------------------------------------------------------------- span

    def span_tables_for(self, n_blocks: int):
        """ChunkSpanTables for n_blocks*block_size samples, or None when
        the session was built without lam64. The device table depends only
        on the chunk size, so spans of different lengths with one chunk
        size (a render's remainder dispatch) share one cached build.

        Cached tables carry their SpanPlanes (ops/span.py::with_planes),
        the layout the contraction kernels read, made once per cached
        table: tables put in the cache without them get them at their
        first use here. A chunk size missing from the session's cache is
        taken from the bank's table cache, which every session on the bank
        shares, and built there only when the bank has none. Each miss of
        the session's cache is the span ``session.tables``, its counter 1
        when the bank's cache served the tables."""
        if self._lam64 is None:
            return None
        span = n_blocks * self.config.block_size
        chunk = choose_radix(span)
        tables = self._span_cache.get(chunk)
        if tables is None or (tables.planes is None
                              and tables.b_re.dtype == torch.float32):
            tok = profiling.begin(profiling.TABLES)
            hit = False
            if tables is None:
                key = ("span", self._lam_key, chunk, self._dtype,
                       self.device)
                tables = self.bank.table_cache.get(key)
                hit = tables is not None
                if not hit:
                    tables = with_planes(build_span_tables(
                        self._lam64, chunk, radix=chunk,
                        num_modes=self.bank.num_modes, dtype=self._dtype,
                        device=self.device))
                    self._share_table(key, tables)
            else:
                tables = with_planes(tables)
            self._span_cache[chunk] = tables
            profiling.end(tok, int(hit))
        return dataclasses.replace(tables, n_chunks=span // chunk)

    def _span_bucket(self, with_sustained: bool) -> int | None:
        """The slot bucket of a span dispatch: 0 while a drag is the only
        live excitation (every impact slot expired), so the AR channel is
        the span's single slot (solver._span_channels)."""
        if with_sustained and not (self._expiry > self._clock).any():
            return 0
        return self._slot_bucket(ignore_sustained=with_sustained)

    def span_eligible(self) -> bool:
        """The span path needs the lam64 eigenvalues. Sustained scenes take
        it too (ops/forces.py::sustained_span), with one carve-out kept
        from the JAX session: while a retuned (per-object) AR table meets
        a live impact slot, the blocks go per block."""
        if self._lam64 is None:
            return False
        if self._with_sustained():
            a = self._ar_host
            if not (a == a[:1]).all() and (self._expiry > self._clock).any():
                return False
        return True

    # AR-table length policy of sustained_span's group propagation
    # (ops/forces.py::_companion_states): the table covers grp blocks, so
    # the companion scan takes n_blocks/grp steps. A shared tuning covers
    # the whole span ([1, L] tables, no scan); per-object tunings stop at
    # 32 blocks ([O, 32*S + 1], ~16 MB at 256 objects and S = 512).
    AR_GROUP_CAP_SHARED = 512
    AR_GROUP_CAP_PER_OBJECT = 32

    def ar_span_table(self, n_blocks: int = 1,
                      force_per_object: bool = False) -> torch.Tensor:
        """The device AR impulse table [Og, grp*S + 1] for a span of
        ``n_blocks`` (grp the largest divisor of n_blocks under the cap),
        from the host AR mirror: Og = 1 while every object shares one
        tuning. Cached until a retune of ``a``. ``force_per_object`` builds
        the [O, ...] layout even for uniform tunings: warmup runs the
        retuned-drag span with it before any retune happens. A miss of the
        session's cache is taken from the bank's table cache, keyed on the
        tuning's rows, and built there only when the bank has none: the
        span ``session.tables``, its counter 1 when the bank's cache
        served the table."""
        a = self._ar_host
        shared = bool((a == a[:1]).all()) and not force_per_object
        cap = (self.AR_GROUP_CAP_SHARED if shared
               else self.AR_GROUP_CAP_PER_OBJECT)
        length = span_group(n_blocks, cap) * self.config.block_size
        tbl = self._ar_g.get((length, shared))
        if tbl is None:
            tok = profiling.begin(profiling.TABLES)
            rows = a[:1] if shared else a
            key = ("ar", rows.shape, rows.tobytes(), length, shared,
                   self._dtype, self.device)
            tbl = self.bank.table_cache.get(key)
            hit = tbl is not None
            if not hit:
                tbl = torch.as_tensor(ar_impulse_g(rows, length)).to(
                    self._dtype).to(self.device)
                self._share_table(key, tbl)
            self._ar_g[(length, shared)] = tbl
            profiling.end(tok, int(hit))
        return tbl

    # what the bank's table cache may hold, across the sessions on it: a
    # table outlives its session there so that the next session on the
    # bank (a bake's, a served scene's grown bucket) takes it in place of
    # a host float64 build. A shared scene's whole set, every chunk size
    # and AR length a bake or warmup takes, is ~0.11 GB at 1024 modes; a
    # per-object scene's tables with their planes are ~0.54 GB (one-block
    # chunks) to ~4.3 GB (512-sample chunks) at 256 objects, so those of
    # longer chunks stay with their session, as before, and do not pile
    # up on the card across chunk sizes after it has gone.
    TABLE_CACHE_BYTES = 1 << 30

    def _share_table(self, key, table) -> None:
        """Put a table this session built into the bank's cache."""
        if isinstance(table, torch.Tensor):
            tensors = (table,)
        else:
            tensors = (table.b_re, table.b_im) + (
                () if table.planes is None else
                tuple(vars(table.planes).values()))
        self.bank.table_cache.put(key, table,
                                  sum(t.nbytes for t in tensors),
                                  self.TABLE_CACHE_BYTES)

    # force_span materialises [O, K, N]-shaped intermediates (per-slot
    # profiles, membership, f_k): cap K*N*O so a full 16-slot table on a
    # long offline span cannot demand many GB of device memory at once
    # (256 objects x 16 slots x a 512-block span = 4.3 GB for f_k alone).
    # Spans above the cap fall back to step_multi for that dispatch.
    SPAN_FORCE_BUDGET = 1 << 28

    def _step_span(self, n_blocks: int, num_slots: int | None | str = "auto",
                   idle: bool | None = None,
                   with_sustained: bool | None = None,
                   ar_per_object: bool = False):
        """Advance n_blocks via one span dispatch; returns the device mix
        [n_blocks*S, C] (not synced). Caller checked span_eligible. The
        slot bucket is the live one (_span_bucket: 0 for a drag alone);
        ``num_slots``/``idle``/``with_sustained``/``ar_per_object``
        override the host gating (warmup). The span ``session.span``."""
        tok = profiling.begin(profiling.SPAN)
        self._maybe_rebase()
        if idle is None:
            idle = self._idle() and self.config.decay_fast_path
        if with_sustained is None:
            with_sustained = self._with_sustained()
        if num_slots == "auto":
            num_slots = self._span_bucket(with_sustained)
        k = self._expiry.shape[1] if num_slots is None else num_slots
        live = self._live_pairs(n_blocks) if tok >= 0 else 0
        if (not idle and k * n_blocks * self.config.block_size
                * self.bank.num_objects > self.SPAN_FORCE_BUDGET):
            mix = self._step_multi(n_blocks, with_sustained, num_slots)
        else:
            mix = self._span_mix(n_blocks, num_slots, idle, with_sustained,
                                 ar_per_object)
        self._clock += n_blocks * self.config.block_size
        profiling.end(tok, 0 if idle else k, live)
        return mix

    def _live_pairs(self, n_blocks: int) -> int:
        """The (object, slot) pairs whose force produces inside the next
        n_blocks: started before the span ends, not expired when it
        starts (the host mirrors; the counter ``live`` of
        ``session.span``, beside the slot bucket K it ran over)."""
        end = self._clock + n_blocks * self.config.block_size
        return int(((self._t0 < end) & (self._expiry > self._clock)).sum())

    def _span_mix(self, n_blocks: int, num_slots: int | None, idle: bool,
                  with_sustained: bool, ar_per_object: bool):
        """One span dispatch with the gating resolved: the device mix."""
        if idle:
            self.state, mix = decay_span_step(
                self.state, self.bank, self.span_tables_for(n_blocks),
                self.gains, n_blocks=n_blocks,
                block_size=self.config.block_size)
        else:
            self.state, mix = step_span(
                self.state, self.bank, self.span_tables_for(n_blocks),
                self.gains, n_blocks=n_blocks,
                block_size=self.config.block_size, num_slots=num_slots,
                with_sustained=with_sustained,
                ar_g=(self.ar_span_table(n_blocks, ar_per_object)
                      if with_sustained else None))
        return mix

    def _step_multi(self, n_blocks: int, with_sustained: bool,
                    num_slots: int | None):
        """n_blocks block by block in one call (solver.step_multi): the
        device mix. The caller advances the host clock."""
        self.state, mix = step_multi(
            self.state, self.bank, self.gains, n_blocks=n_blocks,
            block_size=self.config.block_size,
            backend=self.config.backend, with_sustained=with_sustained,
            num_slots=num_slots)
        return mix

    def _step_span_sound(self, n_blocks: int,
                         num_slots: int | None | str = "auto",
                         idle: bool | None = None,
                         with_sustained: bool | None = None,
                         ar_per_object: bool = False):
        """_step_span returning the raw per-object sound [O, N] (device,
        not synced) for span-shaped post-mix stages. No SPAN_FORCE_BUDGET
        fallback: it serves lookahead-sized spans far below the budget.
        The span ``session.span``."""
        tok = profiling.begin(profiling.SPAN)
        self._maybe_rebase()
        if idle is None:
            idle = self._idle() and self.config.decay_fast_path
        if with_sustained is None:
            with_sustained = self._with_sustained()
        if num_slots == "auto":
            num_slots = self._span_bucket(with_sustained)
        live = self._live_pairs(n_blocks) if tok >= 0 else 0
        sound = self._span_sound(n_blocks, num_slots, idle,
                                 with_sustained and not idle, ar_per_object)
        self._clock += n_blocks * self.config.block_size
        k = self._expiry.shape[1] if num_slots is None else num_slots
        profiling.end(tok, 0 if idle else k, live)
        return sound

    def _span_sound(self, n_blocks: int, num_slots: int | None, idle: bool,
                    with_sustained: bool, ar_per_object: bool):
        """One sound span dispatch with the gating resolved: the device
        sound [O, N] or [O, L, N]."""
        self.state, sound = step_span_sound(
            self.state, self.bank, self.span_tables_for(n_blocks),
            n_blocks=n_blocks, block_size=self.config.block_size,
            num_slots=num_slots, with_sustained=with_sustained,
            ar_g=(self.ar_span_table(n_blocks, ar_per_object)
                  if with_sustained else None),
            idle=idle)
        return sound

    def qnorm_probe_eligible(self) -> bool:
        """The probe runs decay_block_blocked, which needs the lam-power
        tables; table-less (scan-only) banks cannot probe."""
        return self.bank.pow_re is not None

    def qnorm_probe(self) -> torch.Tensor:
        """Per-mode energy telemetry [O, M] of the current state over one
        ring-down block, without advancing the stream.

        Lets the engine keep qnorm flowing while the audio itself rides
        span dispatches, instead of breaking the span for an exact
        per-block qnorm step. The probe omits the in-flight force
        contribution of the probed block; the reference's qnorm channel is
        best-effort drop telemetry (modal_solver.h:272-273), so a reader
        sees the ring-down energy one dispatch late."""
        return decay_block_blocked(
            self.state.z_re, self.state.z_im, self.bank,
            self.state.transfer, True)[3]

    # ------------------------------------------------------------ warmup

    def warmup(self, *, qnorm: bool = False, post_mix=None,
               sustained: bool = True, span_blocks: tuple[int, ...] = (),
               ) -> None:
        """Run once every variant the steady-state loop can take.

        Nothing is compiled per variant here, but much is built at first
        use, and none of it may land inside a live stream: the CUDA
        library (nvcc on a cold cache, then its load), the fused kernel's
        launch plan and tile-major tables, the span tables of each chunk
        size (host float64), both AR table layouts, this thread's cuBLAS
        handle and the cuFFT plans, the FFAT lookup, and the caching
        allocator's first blocks of each size (the engine's synthesis
        thread makes its own cuBLAS handle, engine._thread_first_use). The
        variants are those that can fire for this session:

        - the full step for every slot bucket (sustained off), and the
          sustained-on variant (full slot table) when ``sustained``: pass
          False for sessions that will never receive sustained events;
        - the decay step when the session is decay-eligible;
        - the transfer-ramp (xfade) step only when smooth_transfer is on
          and an FFAT is present (without one the transfer never changes);
        - each of the above with compute_qnorm=True when ``qnorm``;
        - span dispatches for each length in ``span_blocks`` (the engine's
          lookahead) when the session has span tables;
        - the FFAT lookup of a listener move ([L, O, 3] rows with
          listeners), from both textures when a compressed one is resident
          (set_use_compressed switches live);
        - the hit and clear slot writes;
        - ``post_mix(sound, mix)`` when given (its ``reset()`` is called
          afterwards, so that the stream starts clean).

        Warmup works on a clone of the state, since slots and the sustained
        channel are written in place, and puts the state it found and every
        host mirror back: it synthesizes no observable audio and leaves
        the sample clock untouched.
        """
        saved_state = self.state
        self.state = clone_state(saved_state)
        saved_clock = self._clock
        saved_base = self._clock_base
        saved_expiry = self._expiry.copy()
        saved_t0 = self._t0.copy()
        saved_sus = self._sus_active.copy()
        saved_xfade = self._xfade_from
        saved_config = self.config
        saved_listener = self._last_listener

        def sync(x):
            # the device-to-host copy the live loop makes of every block
            return x.cpu() if isinstance(x, torch.Tensor) else x

        try:
            xfade = self.config.smooth_transfer and self.ffat is not None
            if self.ffat is not None and self.use_transfer:
                # a live listener move runs compute_transfer on the
                # synthesis thread (state.transfer is restored below)
                o = self.bank.num_objects
                shape = ((o, 3) if self.num_listeners <= 1
                         else (self.num_listeners, o, 3))
                self.set_listener_relative(np.ones(shape))
                if self.ffat.geom.psi_c is not None:
                    # the other texture is one toggle away
                    saved_comp = self.use_compressed
                    self.use_compressed = not saved_comp
                    try:
                        self.set_listener_relative(np.ones(shape))
                    finally:
                        self.use_compressed = saved_comp
            self.hit(0, np.zeros(self.bank.num_modes), amp=0.0)
            self.clear_forces()
            k = self._expiry.shape[1]
            buckets = sorted({b for b in self.config.slot_buckets
                              if b < k}) + [None]
            variants = [(False, b) for b in buckets]
            if sustained:
                variants.append((True, None))
            pm_span = post_mix is not None and hasattr(post_mix,
                                                       "process_span")
            for q in [False] + ([True] if qnorm else []):
                self.config = dataclasses.replace(self.config,
                                                  compute_qnorm=q)
                for ws, b in variants:
                    sound, mix, _ = self._step_full(with_sustained=ws,
                                                    num_slots=b)
                    if (post_mix is not None and not q and not ws
                            and b is buckets[0]):
                        sync(post_mix(sound, mix))
                    sync(mix)
                    if xfade:
                        # a listener move can meet any (sustained, bucket)
                        # variant; a ramp from the current row to itself
                        # runs each without changing the output
                        _, mix, _ = self._step_xfade(
                            self._current_transfer(),
                            with_sustained=ws, num_slots=b)
                        sync(mix)
                if self.decay_eligible():
                    sync(self._step_decay()[1])
                for n_blocks in span_blocks:
                    if q or not self.span_eligible():
                        continue

                    def span_once(**kw):
                        # with a span-capable post-mix the engine takes
                        # the sound span and process_span
                        if pm_span:
                            return sync(post_mix.process_span(
                                self._step_span_sound(n_blocks, **kw)))
                        return sync(self._step_span(n_blocks, **kw))

                    for b in buckets:
                        span_once(num_slots=b, idle=False,
                                  with_sustained=False)
                    if sustained:
                        # a drag rides the span too; bucket 0 is the drag
                        # alone (_span_bucket), and the last is the
                        # retuned drag with its per-object AR table
                        for b in [0] + buckets:
                            span_once(num_slots=b, idle=False,
                                      with_sustained=True)
                        span_once(num_slots=0, idle=False,
                                  with_sustained=True, ar_per_object=True)
                    if self.config.decay_fast_path:
                        span_once(idle=True)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.config = saved_config
            self.state = saved_state
            self._clock = saved_clock
            self._clock_base = saved_base
            self._expiry[...] = saved_expiry
            self._t0[...] = saved_t0
            self._sus_active[...] = saved_sus
            self._xfade_from = saved_xfade
            self._last_listener = saved_listener
            if post_mix is not None and hasattr(post_mix, "reset"):
                post_mix.reset()

    # ------------------------------------------------------------- audio

    def _step_decay(self):
        """The homogeneous-only block (see solver.decay_block)."""
        self.state, sound, mix, qnorm = decay_block(
            self.state, self.bank, self.gains,
            block_size=self.config.block_size,
            compute_qnorm=self.config.compute_qnorm)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def _step_full(self, with_sustained: bool | None = None,
                   num_slots: int | None | str = "auto"):
        """The host-gated full block step; warmup passes the variant flags
        itself, so that every variant runs once up front."""
        if with_sustained is None:
            with_sustained = self._with_sustained()
        if num_slots == "auto":
            num_slots = self._slot_bucket()
        self.state, sound, mix, qnorm = step_block(
            self.state, self.bank, self.gains,
            block_size=self.config.block_size,
            backend=self.config.backend,
            compute_qnorm=self.config.compute_qnorm,
            with_sustained=with_sustained,
            num_slots=num_slots)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def _step_xfade(self, prev, with_sustained: bool | None = None,
                    num_slots: int | None | str = "auto"):
        """The transfer-ramp block (see step()); ``prev`` is the outgoing
        (re, im) row pair, im None for a real row. A fused backend takes
        the blocked form for this one block (solver._step_block_impl)."""
        prev_re, prev_im = prev
        if with_sustained is None:
            with_sustained = self._with_sustained()
        if num_slots == "auto":
            num_slots = self._slot_bucket()
        self.state, sound, mix, qnorm = step_block_xfade(
            self.state, self.bank, self.gains, prev_re,
            block_size=self.config.block_size,
            backend=self.config.backend,
            compute_qnorm=self.config.compute_qnorm,
            with_sustained=with_sustained,
            num_slots=num_slots,
            transfer_prev_im=prev_im)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def step(self):
        """Synthesize one block: (sound [O, S] raw, mix [S, 2] output-scaled
        stereo, qnorm [O, M] or None), as device tensors.

        While the scene is provably idle (all slots expired, no sustained
        contact) and the backend is table-form, the cheaper
        homogeneous-only decay step runs instead: the same output at about
        half the device work. A pending smooth listener move
        (smooth_transfer) takes the transfer-ramping step for one block,
        ahead of the decay path.
        """
        self._maybe_rebase()
        if self._xfade_from is not None:
            prev, self._xfade_from = self._xfade_from, None
            return self._step_xfade(prev)
        if self._idle() and self.decay_eligible():
            return self._step_decay()
        return self._step_full()

    def render(self, num_blocks: int) -> np.ndarray:
        """Offline render: [num_blocks * S, 2] stereo float32 (each block
        is copied to the host as it completes)."""
        out = []
        for _ in range(num_blocks):
            _, mix, _ = self.step()
            out.append(mix.cpu().numpy())
        return np.concatenate(out, axis=0)

    def render_multi(self, num_blocks: int,
                     blocks_per_dispatch: int = 16) -> np.ndarray:
        """Offline render, ``blocks_per_dispatch`` blocks per dispatch:
        [num_blocks * S, 2] stereo float32. Hits already scheduled (future
        ``when``) fire at the right sample inside a dispatch. Sessions
        built with lam64 take the chunked span (_step_span); the others
        step block by block (step_multi)."""
        self._maybe_rebase()
        out = []
        done = 0
        if self._xfade_from is not None and num_blocks > 0:
            # flush the pending smooth listener move as a single step, so
            # that the span starts from a settled transfer row
            _, mix, _ = self.step()
            out.append(mix.cpu().numpy())
            done += 1
        use_span = self.span_eligible()
        while done < num_blocks:
            n = min(blocks_per_dispatch, num_blocks - done)
            if use_span:
                mix = self._step_span(n)
            else:
                mix = self._step_multi(n, self._with_sustained(),
                                       self._slot_bucket())
                self._clock += n * self.config.block_size
            out.append(mix.cpu().numpy())
            done += n
        return np.concatenate(out, axis=0)

    def render_moving(self, positions: np.ndarray,
                      blocks_per_dispatch: int = 64,
                      smooth: bool | None = None) -> np.ndarray:
        """Offline render along a listener path, one transfer row per block
        (solver.step_multi_transfers).

        ``positions``: [T, 3] (shared listener) or [T, O, 3]; row t is the
        listener for block t (hold rows to move slower). Multi-listener
        sessions take [T, 3], [T, L, 3] or [T, L, O, 3] and return one
        channel per listener. ``smooth`` ramps
        each block from the previous row (the default is
        config.smooth_transfer). The reference's flow costs one transfer
        recompute and one block per move (modal_solver.h:286-300). The
        transfer rows are computed per chunk of ``blocks_per_dispatch``
        blocks, so the working set is [bpd, (L,) O, M] however long the
        path is,
        and each chunk's audio is copied to the host once. Returns
        [T * S, C] float32.
        """
        if self.ffat is None or not self.use_transfer:
            raise ValueError("render_moving needs an FFAT transfer "
                             "(build the session with ffat=...)")
        self._maybe_rebase()
        if smooth is None:
            smooth = self.config.smooth_transfer
        positions = self._moving_path(positions)
        t_total = positions.shape[0]
        if self._xfade_from is not None and smooth:
            # the pending move's outgoing row becomes the loop's carry
            # (the real row only: FFAT lookups are magnitude-only)
            self._install_transfer(self._xfade_from[0],
                                   self._current_transfer()[1])
        self._xfade_from = None
        out = []
        done = 0
        while done < t_total:
            n = min(blocks_per_dispatch, t_total - done)
            rows = self._transfer_rows(positions[done:done + n])
            mix = self._moving(rows, smooth, want_sound=False)
            self._clock += n * self.config.block_size
            out.append(mix.cpu().numpy())
            done += n
        self._last_listener = positions[-1]
        return np.concatenate(out, axis=0)

    def _moving(self, rows: torch.Tensor, smooth: bool, want_sound: bool):
        """One chunk of a listener path, one transfer row per block
        (``rows`` [n, (L,) O, M]): the device mix [n*S, C], or with
        ``want_sound`` the raw sound [(L,) O, n*S]. The caller advances
        the host clock."""
        kw = dict(n_blocks=rows.shape[0], block_size=self.config.block_size,
                  backend=self.config.backend, smooth=smooth,
                  with_sustained=self._with_sustained(),
                  num_slots=self._slot_bucket())
        if want_sound:
            self.state, out = step_multi_transfers_sound(
                self.state, self.bank, rows, **kw)
        else:
            self.state, out = step_multi_transfers(
                self.state, self.bank, self.gains, rows, **kw)
        return out

    def _moving_path(self, positions: np.ndarray) -> np.ndarray:
        """A moving-listener path as [T, O, 3], or [T, L, O, 3] with
        listeners ([T, 3] and [T, L, 3] broadcast: views, no copies)."""
        positions = np.asarray(positions, np.float64)
        t_total = positions.shape[0]
        o, nl = self.bank.num_objects, self.num_listeners
        if nl > 1:
            if positions.ndim == 2 and positions.shape[1:] == (3,):
                positions = np.broadcast_to(positions[:, None, :],
                                            (t_total, nl, 3))
            if positions.ndim == 3 and positions.shape[1:] == (nl, 3):
                positions = np.broadcast_to(positions[:, :, None, :],
                                            (t_total, nl, o, 3))
            if positions.ndim != 4 or positions.shape[1:] != (nl, o, 3):
                raise ValueError(
                    f"expected a [T, 3], [T, {nl}, 3] or [T, {nl}, {o}, 3] "
                    f"listener path, got {positions.shape}")
            return positions
        if positions.ndim == 2 and positions.shape[1:] == (3,):
            return np.broadcast_to(positions[:, None, :], (t_total, o, 3))
        if positions.ndim != 3 or positions.shape[1:] != (o, 3):
            raise ValueError(f"expected a [T, 3] or [T, {o}, 3] listener "
                             f"path, got {positions.shape}")
        return positions

    def _transfer_rows(self, positions_chunk: np.ndarray) -> torch.Tensor:
        """FFAT transfer rows of one chunk of a moving path: [n, O, 3] ->
        [n, O, M], or [n, L, O, 3] -> [n, L, O, M]. Each block's rows are
        their own compute_transfer call, so they equal set_listener's for
        that position bitwise, however the path is chunked."""
        return self._lookup(torch.as_tensor(
            np.ascontiguousarray(positions_chunk)).to(self._dtype).to(
                self.device))

    def render_doppler(self, positions: np.ndarray,
                       blocks_per_dispatch: int = 64,
                       smooth: bool | None = None,
                       c: float | None = None,
                       state_events=None,
                       object_centers=None) -> np.ndarray:
        """render_moving with physical Doppler: each object's signal
        reaches the listener delayed by its time-varying propagation time
        r(t)/c, which is the Doppler effect (a radial approach speed v
        compresses the received phase by 1 + v/c). The reference applies
        no propagation delay (modal_solver.h:286-300 evaluates amplitude
        only); amplitude falloff stays with the per-block FFAT transfer, as
        in render_moving (ops/doppler.py).

        ``positions``: as render_moving ([T, 3] or [T, O, 3]; [T, 3],
        [T, L, 3] or [T, L, O, 3] with listeners), listener positions
        relative to each object, row t = block t; with listeners, one
        Doppler-delayed channel each, following its own distances. Returns
        [T * S, C] float32. Samples whose emission time precedes the render
        start are silent (the wavefront has not arrived).

        The per-object sound of the whole render is held on the host
        ([(L,) O, T*S]: the resample needs it whole); transfer rows are
        computed per chunk as in render_moving.

        ``state_events``: optional [(block_index, fn)] sorted ascending;
        ``fn(session)`` runs when generation reaches that block (the
        generation loop splits its chunks there), as a timeline bake
        replays drags under Doppler. ``object_centers`` [O, 3] is
        subtracted from the path for the delay distances only: the frame of
        a live DopplerPostMix(positions=...) whose centers are not the
        origin, while the transfer keeps the session frame.
        """
        self._maybe_rebase()
        if smooth is None:
            smooth = self.config.smooth_transfer
        if c is None:
            c = SOUND_SPEED
        positions = self._moving_path(positions)
        delay_pos = positions
        if object_centers is not None:
            centers = np.asarray(object_centers, np.float64)
            if centers.shape != (self.bank.num_objects, 3):
                raise ValueError(
                    f"object_centers must be [{self.bank.num_objects}, 3],"
                    f" got {centers.shape}")
            delay_pos = positions - centers   # broadcasts over T (and L)
        t_total = positions.shape[0]
        has_ffat = self.ffat is not None and self.use_transfer
        if self._xfade_from is not None and smooth:
            self._install_transfer(self._xfade_from[0],
                                   self._current_transfer()[1])
        self._xfade_from = None
        pending = list(state_events or [])
        sounds = []
        done = 0
        while done < t_total:
            while pending and pending[0][0] <= done:
                pending.pop(0)[1](self)
            n = min(blocks_per_dispatch, t_total - done)
            if pending:
                n = min(n, pending[0][0] - done)
            if has_ffat:
                rows = self._transfer_rows(positions[done:done + n])
            else:
                held = self._current_transfer()[0]
                rows = held.expand((n,) + tuple(held.shape))
            snd = self._moving(rows, smooth, want_sound=True)
            self._clock += n * self.config.block_size
            sounds.append(snd.cpu().numpy())
            done += n
        for _, fn in pending:
            # events at or past the end change no audio, but the session
            # (host mirrors included) must end where a live run would
            fn(self)
        sound = np.concatenate(sounds, axis=-1)        # [(L,) O, N]
        self._last_listener = positions[-1]

        def resample(snd, pos, gains):
            dist = sample_distances(pos, self.config.block_size)
            i0, frac = delay_indices(dist, c)   # the float64 host split
            return delay_resample(
                torch.as_tensor(snd).to(self._dtype).to(self.device),
                torch.as_tensor(i0).to(self.device),
                torch.as_tensor(frac).to(self.device), gains).cpu().numpy()
        if self.num_listeners > 1:
            # listener l resamples its own transfer-weighted sound by its
            # own distances
            return np.concatenate(
                [resample(sound[li], delay_pos[:, li],
                          self.gains[:, li: li + 1])
                 for li in range(self.num_listeners)], axis=-1)
        return resample(sound, delay_pos, self.gains)

    def render_raw(self, num_blocks: int) -> np.ndarray:
        """Offline render of the per-object raw sound, block by block:
        [O, num_blocks * S] float32 (the training clips of ml/dataset.py)."""
        out = []
        for _ in range(num_blocks):
            sound, _, _ = self.step()
            out.append(sound.cpu().numpy())
        return np.concatenate(out, axis=-1)
