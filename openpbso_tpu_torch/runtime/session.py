"""ModalSession — host-side control surface over the device solver.

Counterpart of openpbso_tpu/runtime/session.py: hits become force-slot
writes, sustained contacts (drags) become writes to the AR(2) channel,
listener moves become transfer recomputes, ``step``/``render`` advance the
stream block by block, and ``render_multi`` advances it many blocks per
dispatch, through the chunked span when the session holds the float64
eigenvalues (``lam64``). Both take the cheaper homogeneous-only step while
the scene is provably idle.

Slot lifecycle is tracked on the host (a slot's productive lifetime is a
pure function of its start sample, ops/forces.py), mirroring the
reference's erase-on-exhaustion (modal_solver.h:210-221); when every slot
of an object is busy the oldest is overwritten (the reference's force
queue drops sends when full, modal_solver.h:330-333).

Slot and channel writes are deliberately in place: the session owns its
state, and an indexed write into the existing tensors is the PyTorch form
of the JAX package's donated scatter (openpbso_tpu/runtime/session.py:33-43),
which also reused the buffers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import REBASE_PERIOD, SAMPLE_RATE, UNIT_TRANSFER
from ..ops.coeffs import ModalBank
from ..ops.ffat import FFATMaps, compute_transfer
from ..ops.forces import (FORCE_GAUSSIAN, FORCE_HERTZ, FORCE_POINT,
                          ar_impulse_g, ar_stability_radius, slot_duration,
                          span_group)
from ..ops.integrator import resolve_backend_name
from ..ops.span import build_span_tables, choose_radix
from .solver import (SolverConfig, decay_block, decay_span_step,
                     default_gains, step_block, step_multi, step_span,
                     step_span_sound)
from .state import make_solver_state

# ROADMAP.md Queue 1 items that carry what this session does not do yet
_XFADE_QNORM = "ROADMAP.md Queue 1 item 3: xfade and qnorm"
_SCENE = "ROADMAP.md Queue 1 item 4: Scene"


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


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

        ``num_listeners`` > 1 (shared-state listener rows) is the JAX
        session's argument for a path this port does not have yet; it
        raises rather than being ignored."""
        if num_listeners != 1:
            _not_ported("multi-listener sessions", _SCENE)
        self.config = config or SolverConfig()
        if self.config.smooth_transfer:
            _not_ported("SolverConfig.smooth_transfer", _XFADE_QNORM)
        if self.config.compute_qnorm:
            _not_ported("SolverConfig.compute_qnorm", _XFADE_QNORM)
        self.bank = bank
        self.ffat = ffat
        self.device = bank.device
        self._lam64 = (None if lam64 is None
                       else np.atleast_2d(np.asarray(lam64, np.complex128)))
        self._span_cache: dict[int, object] = {}   # chunk size -> tables
        o, m = bank.num_objects, bank.num_modes
        # the sustained channel's noise is a pure function of (per-object
        # keys from this seed, block index): a session seeded alike replays
        # its drags exactly
        self.seed = int(seed)
        self.state = make_solver_state(o, m, num_slots=num_slots,
                                       seed=self.seed, dtype=dtype,
                                       device=self.device)
        self.gains = default_gains(o, dtype, self.device)
        self.use_transfer = ffat is not None
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

    def _modal_vector(self, space: np.ndarray) -> torch.Tensor:
        """[M] device row from modal amplitudes [M_audible] (zero-padded
        or cut to the bank's modes)."""
        m = self.bank.num_modes
        vec = np.zeros((m,), np.float64)
        space = np.asarray(space, np.float64).ravel()
        vec[: min(space.size, m)] = space[: m]
        return torch.as_tensor(vec).to(self._dtype).to(self.device)

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
        slots = self.state.slots
        slots.ftype[obj, slot] = ftype
        slots.t0[obj, slot] = t0 - self._clock_base  # origin-rebased
        slots.width[obj, slot] = float(width)
        slots.amp[obj, slot] = amp
        slots.space[obj, slot] = vec
        self._t0[obj, slot] = t0
        self._expiry[obj, slot] = t0 + dur

    def clear_forces(self, obj: int | None = None) -> None:
        """Drop all active forces, sustained contacts included
        (clearAllForces, modal_solver.h:186-189)."""
        objs = np.arange(self.bank.num_objects) if obj is None else [obj]
        objs = np.asarray(objs)
        rows = torch.as_tensor(objs, device=self.device)
        self.state.slots.ftype[rows] = 0
        self.state.sustained.active[rows] = False
        self._expiry[objs] = 0
        self._sus_active[objs] = False

    def sustained_start(self, obj: int, space: np.ndarray) -> None:
        """Begin a sustained AR contact on ``obj`` with modal amplitudes
        ``space`` (modal_solver.h:190-194); the AR history restarts."""
        sus = self.state.sustained
        sus.space[obj] = self._modal_vector(space)
        sus.ar_hist[obj] = 0.0
        sus.active[obj] = True
        self._sus_active[obj] = True

    def sustained_update(self, obj: int, space: np.ndarray) -> None:
        """Live-update the sustained force direction
        (modal_solver.h:197-199)."""
        self.state.sustained.space[obj] = self._modal_vector(space)

    def sustained_end(self, obj: int) -> None:
        self.state.sustained.active[obj] = False
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
        a64 = np.asarray(a, np.float64)
        sus = self.state.sustained
        sus.a[obj] = torch.as_tensor(a64).to(self._dtype)
        sus.sigma[obj] = sigma
        sus.mu[obj] = mu
        sus.ar_hist[obj] = 0.0
        # the cached span tables depend on ``a`` alone: a sigma/mu retune
        # keeps them
        if not np.array_equal(self._ar_host[obj], a64):
            self._ar_host[obj] = a64
            self._ar_g = {}

    def set_listener(self, pos: np.ndarray) -> None:
        """Update the acoustic transfer for a listener at ``pos``: [3]
        (shared) or [O, 3] per object, relative to each object's frame
        (computeTransfer + the latest-wins trans queue,
        modal_solver.h:286-300). A world-to-session listener frame arrives
        with Scene."""
        self.set_listener_relative(pos)

    def set_listener_relative(self, pos: np.ndarray) -> None:
        """set_listener in the session's native per-object frame."""
        pos = np.asarray(pos, np.float64)
        if pos.ndim == 3:
            _not_ported("per-listener positions [L, O, 3]", _SCENE)
        if pos.shape not in ((3,), (self.bank.num_objects, 3)):
            raise ValueError(
                f"expected a [3] or [{self.bank.num_objects}, 3] listener "
                f"position, got {pos.shape}")
        self._last_listener = pos
        if self.ffat is None or not self.use_transfer:
            return
        p = torch.as_tensor(pos).to(self._dtype).to(self.device)
        if p.dim() == 1:
            p = p.expand(self.bank.num_objects, 3)
        transfer = compute_transfer(self.ffat, p).to(self._dtype)
        self.state = dataclasses.replace(self.state, transfer=transfer,
                                         transfer_im=None)

    def set_use_transfer(self, use: bool) -> None:
        """Toggle FFAT transfer vs the 1E7 unit transfer
        (modal_solver.h:249-255); re-enabling recomputes from the last
        listener position at once."""
        self.use_transfer = use and self.ffat is not None
        if not use:
            self.state = dataclasses.replace(
                self.state,
                transfer=torch.full_like(self.state.transfer, UNIT_TRANSFER),
                transfer_im=None)
        elif self._last_listener is not None:
            self.set_listener_relative(self._last_listener)

    # ------------------------------------------------- not ported (named)

    def qnorm_probe(self):
        _not_ported("qnorm_probe", _XFADE_QNORM)

    def set_complex_transfer(self, t: np.ndarray) -> None:
        _not_ported("complex transfer rows", _SCENE)

    # ----------------------------------------------------------- gating

    def _maybe_rebase(self) -> None:
        """Re-zero the device clock origin before int32 wrap of the slot
        clock. The subtraction is quantized to whole multiples of
        REBASE_PERIOD, so the device clock is always ``absolute clock mod
        REBASE_PERIOD`` at a step, however the stream was chunked. Expired
        slots' t0 is clamped (their producing predicate is false forever,
        so the clamp changes no output)."""
        delta = self._clock - self._clock_base
        if delta >= REBASE_PERIOD:
            sub = (delta // REBASE_PERIOD) * REBASE_PERIOD
            t0 = self.state.slots.t0
            t0.sub_(sub).clamp_(min=-(1 << 30))
            self.state = dataclasses.replace(
                self.state, block_start=self.state.block_start - sub)
            self._clock_base += sub

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
        k = self.state.slots.num_slots
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
        size (a render's remainder dispatch) share one cached build."""
        if self._lam64 is None:
            return None
        span = n_blocks * self.config.block_size
        chunk = choose_radix(span)
        tables = self._span_cache.get(chunk)
        if tables is None:
            tables = build_span_tables(
                self._lam64, chunk, radix=chunk,
                num_modes=self.bank.num_modes, dtype=self._dtype,
                device=self.device)
            self._span_cache[chunk] = tables
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

    def ar_span_table(self, n_blocks: int = 1) -> torch.Tensor:
        """The device AR impulse table [Og, grp*S + 1] for a span of
        ``n_blocks`` (grp the largest divisor of n_blocks under the cap),
        from the host AR mirror: Og = 1 while every object shares one
        tuning. Cached until a retune of ``a``."""
        a = self._ar_host
        shared = bool((a == a[:1]).all())
        cap = (self.AR_GROUP_CAP_SHARED if shared
               else self.AR_GROUP_CAP_PER_OBJECT)
        length = span_group(n_blocks, cap) * self.config.block_size
        tbl = self._ar_g.get((length, shared))
        if tbl is None:
            tbl = torch.as_tensor(
                ar_impulse_g(a[:1] if shared else a, length)).to(
                    self._dtype).to(self.device)
            self._ar_g[(length, shared)] = tbl
        return tbl

    # force_span materialises [O, K, N]-shaped intermediates (per-slot
    # profiles, membership, f_k): cap K*N*O so a full 16-slot table on a
    # long offline span cannot demand many GB of device memory at once
    # (256 objects x 16 slots x a 512-block span = 4.3 GB for f_k alone).
    # Spans above the cap fall back to step_multi for that dispatch.
    SPAN_FORCE_BUDGET = 1 << 28

    def _step_span(self, n_blocks: int):
        """Advance n_blocks via one span dispatch; returns the device mix
        [n_blocks*S, C] (not synced). Caller checked span_eligible. The
        slot bucket is the live one (_span_bucket: 0 for a drag alone)."""
        self._maybe_rebase()
        idle = self._idle() and self.config.decay_fast_path
        with_sustained = self._with_sustained()
        num_slots = self._span_bucket(with_sustained)
        k = self.state.slots.num_slots if num_slots is None else num_slots
        if (not idle and k * n_blocks * self.config.block_size
                * self.bank.num_objects > self.SPAN_FORCE_BUDGET):
            self.state, mix = step_multi(
                self.state, self.bank, self.gains, n_blocks=n_blocks,
                block_size=self.config.block_size,
                backend=self.config.backend, with_sustained=with_sustained,
                num_slots=num_slots)
        elif idle:
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
                ar_g=self.ar_span_table(n_blocks) if with_sustained else None)
        self._clock += n_blocks * self.config.block_size
        return mix

    def _step_span_sound(self, n_blocks: int):
        """_step_span returning the raw per-object sound [O, N] (device,
        not synced) for span-shaped post-mix stages. No SPAN_FORCE_BUDGET
        fallback: it serves lookahead-sized spans far below the budget."""
        self._maybe_rebase()
        with_sustained = self._with_sustained()
        self.state, sound = step_span_sound(
            self.state, self.bank, self.span_tables_for(n_blocks),
            n_blocks=n_blocks, block_size=self.config.block_size,
            num_slots=self._span_bucket(with_sustained),
            with_sustained=with_sustained,
            ar_g=self.ar_span_table(n_blocks) if with_sustained else None,
            idle=self._idle() and self.config.decay_fast_path)
        self._clock += n_blocks * self.config.block_size
        return sound

    # ------------------------------------------------------------- audio

    def _step_decay(self):
        """The homogeneous-only block (see solver.decay_block)."""
        self.state, sound, mix, qnorm = decay_block(
            self.state, self.bank, self.gains,
            block_size=self.config.block_size)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def _step_full(self):
        """The host-gated full block step."""
        self.state, sound, mix, qnorm = step_block(
            self.state, self.bank, self.gains,
            block_size=self.config.block_size,
            backend=self.config.backend,
            with_sustained=self._with_sustained(),
            num_slots=self._slot_bucket())
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def step(self):
        """Synthesize one block: (sound [O, S] raw, mix [S, 2] output-scaled
        stereo, qnorm None), as device tensors.

        While the scene is provably idle (all slots expired, no sustained
        contact) and the backend is table-form, the cheaper
        homogeneous-only decay step runs instead: the same output at about
        half the device work.
        """
        self._maybe_rebase()
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
        use_span = self.span_eligible()
        while done < num_blocks:
            n = min(blocks_per_dispatch, num_blocks - done)
            if use_span:
                mix = self._step_span(n)
            else:
                self.state, mix = step_multi(
                    self.state, self.bank, self.gains, n_blocks=n,
                    block_size=self.config.block_size,
                    backend=self.config.backend,
                    with_sustained=self._with_sustained(),
                    num_slots=self._slot_bucket())
                self._clock += n * self.config.block_size
            out.append(mix.cpu().numpy())
            done += n
        return np.concatenate(out, axis=0)
