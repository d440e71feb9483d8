"""Physical Doppler for moving listeners: a time-varying propagation delay.

Counterpart of openpbso_tpu/ops/doppler.py. The reference recomputes the
acoustic transfer when the listener moves but applies no propagation delay
(modal_solver.h:286-300, ffat_solver.h:1180-1214 evaluate amplitude only).
For a listener at distance r(t) from a source the received signal is

    y(t) = s(t - r(t)/c)

and the time-varying delay is the Doppler effect: a radial approach speed v
compresses the received phase by the factor (1 + v/c). The amplitude part
stays with the per-block FFAT transfer.

Offline (``ModalSession.render_doppler``): the session renders each
object's raw signal over the whole path, the host interpolates per-sample
distances between the per-block positions in float64, and
``delay_resample`` gathers each signal at the fractional index
n - r_o[n] * SR / c (linear interpolation). Live (``DopplerPostMix``): a
per-object delay line fed by the engine's listener events ramps each
object's delay across every dispatch. Samples emitted before the render or
stream started are silence.

Every index computation keeps the dtype the JAX package gives it: the
offline absolute index is split on the host in float64, the live
buffer-relative index is formed in float32 on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import OUTPUT_SCALE, SAMPLE_RATE, SOUND_SPEED
from ..device import resolve_device


def delay_resample(
    sound: torch.Tensor,      # [O, N] raw per-object signal (emission time)
    i0: torch.Tensor,         # [O, N] int32 floor(n - delay_n) source index
    frac: torch.Tensor,       # [O, N] fractional part of (n - delay_n)
    gains: torch.Tensor,      # [O, C] channel gains
) -> torch.Tensor:
    """Fractional-delay gather and channel mixdown -> mix [N, C] float32.

    y_o[n] = s_o[n - delay_o[n]] by linear interpolation; n - delay < 0
    reads silence (a signal emitted before the render started). The mixdown
    applies the reference's 1/1E10 output scale as solver._mixdown does.
    (i0, frac) come from :func:`delay_indices`: the absolute index must be
    split in float64 on the host, since a float32 index grid loses its
    fractional resolution past ~2^23/8 samples (~24 s of audio)."""
    n = sound.shape[-1]
    frac = frac.to(sound.dtype)
    i0 = i0.long()

    def take(i):
        return torch.gather(sound, -1, i.clamp(0, n - 1))
    y = (take(i0) * (1.0 - frac) * (i0 >= 0)
         + take(i0 + 1) * frac * (i0 + 1 >= 0))
    mix = torch.einsum("on,oc->nc", y, gains)
    return (mix / OUTPUT_SCALE).to(torch.float32)


def delay_indices(dist, c: float = SOUND_SPEED,
                  sample_rate: int = SAMPLE_RATE):
    """Host (float64) split of the fractional source index.

    ``dist``: [O, N] float64 distances -> (i0 int32, frac float32) with
    i0 + frac == n - dist * SR / c at full double precision (see
    delay_resample)."""
    dist = np.asarray(dist, np.float64)
    n = dist.shape[-1]
    idx = np.arange(n, dtype=np.float64)[None, :] - dist * (sample_rate / c)
    i0 = np.floor(idx)
    frac = (idx - i0).astype(np.float32)
    return i0.astype(np.int32), frac


def _delay_line(buf, h, d0, d1):
    """The live delay line's gather: ``buf`` [..., H+N] holds the history
    and the new samples; each row's delay ramps d0 -> d1 samples across
    the N outputs. Index math in the sound's float32, as the JAX package
    forms it (buffer-relative indices stay below ~10^4, where float32
    resolves ~1e-3 of a sample). Returns y [..., N]."""
    n = buf.shape[-1] - h
    t = torch.arange(n, dtype=buf.dtype, device=buf.device)
    # d0 + (d1 - d0) r with one rounding, as XLA contracts it into a fused
    # multiply-add: floor() below turns a last-bit difference in the delay
    # into a different interpolation weight
    d = torch.addcmul(d0[..., None], (d1 - d0)[..., None], (t + 1.0) / n)
    idx = h + t - d
    i0 = torch.floor(idx).to(torch.int32)
    frac = (idx - i0.to(idx.dtype)).to(buf.dtype)
    i0 = i0.long()

    def take(i):
        return torch.gather(buf, -1, i.clamp(0, h + n - 1))
    return take(i0) * (1.0 - frac) + take(i0 + 1) * frac


def _doppler_mix(hist, sound, d0, d1, gains):
    """One dispatch of the live fractional delay line (DopplerPostMix):
    ``hist`` [O, H] is the tail of earlier samples, ``sound`` [O, N] the
    new span or block, each object's delay ramping from d0 to d1 samples
    across the N outputs (the ramp is the Doppler shift: d(delay)/dt =
    -v/c). Returns (mix [N, C], new hist [O, H])."""
    h = hist.shape[-1]
    buf = torch.cat([hist, sound], dim=-1)                # [O, H+N]
    y = _delay_line(buf, h, d0, d1)
    mix = torch.einsum("on,oc->nc", y, gains)
    return (mix / OUTPUT_SCALE).to(torch.float32), buf[:, -h:]


def _doppler_mix_multi(hist, sound, d0, d1, gains):
    """Per-listener live delay lines (per-client serving with live
    Doppler): ``hist`` [O, L, H], ``sound`` [O, L, N] (the span's
    multi-listener layout, listener axis inside). Listener l's channel
    gathers each object's signal as heard by l at l's own retarded time;
    delays ramp d0 -> d1 per (object, listener). Returns (mix [N, L], one
    mono column per listener, and the new hist)."""
    h = hist.shape[-1]
    buf = torch.cat([hist, sound], dim=-1)                # [O, L, H+N]
    y = _delay_line(buf, h, d0, d1)
    mix = torch.einsum("oln,ol->nl", y, gains)
    return (mix / OUTPUT_SCALE).to(torch.float32), buf[..., -h:]


class DopplerPostMix:
    """StreamingEngine ``post_mix`` hook: live physical Doppler.

    A per-object fractional delay line fed by listener events makes
    render_doppler's physics available in a stream. Each applied listener
    event retargets every object's propagation delay r_o/c; the next
    dispatch ramps the delay there across its samples, which is the
    Doppler shift of the move's radial velocity. Amplitude against
    distance stays with the session's FFAT transfer, as offline.

    It has both post-mix entries (per-block ``__call__`` and
    ``process_span``), so Doppler streams ride the engine's span
    dispatches. The delay line starts at zero: samples emitted before the
    stream started are silent.
    """

    def __init__(self, positions: np.ndarray, *, gains=None,
                 c: float = SOUND_SPEED, max_distance: float = 20.0,
                 sample_rate: int = SAMPLE_RATE,
                 dtype: torch.dtype = torch.float32,
                 num_listeners: int = 1,
                 device: torch.device | str | None = None):
        """``positions``: [O, 3] object centers (world frame);
        ``max_distance`` bounds the delay line (meters). ``device`` None
        is the CUDA device (device.resolve_device).

        ``num_listeners`` = L > 1 is per-client serving: the span feeds
        per-listener sound [O, L, N] and each (object, listener) pair has
        its own delay line; listener events carry [L, 3] world rows, the
        mix is [N, L] (one column per client) and ``gains`` is [O, L]."""
        device = resolve_device(device)
        # a copy: _run and set_position move these positions in place (the
        # live audio-clock positions), which must not drift the caller's
        # array
        self.positions = np.array(positions, np.float64)
        o = self.positions.shape[0]
        ll = int(num_listeners)
        self._nl = ll
        self._sr = float(sample_rate)
        self._scale = sample_rate / float(c)
        h = int(np.ceil(max_distance * self._scale)) + 2
        self._hist = torch.zeros((o, h) if ll == 1 else (o, ll, h),
                                 dtype=dtype, device=device)
        self._h_max = float(h - 2)
        # per-object world velocities (object_vel events), integrated on
        # the audio clock, one position step per dispatch: a constant
        # radial velocity gives an exactly constant delay ramp rate
        self.velocities = np.zeros((o, 3))
        if gains is not None:
            self.gains = torch.as_tensor(gains).to(dtype=dtype,
                                                   device=device)
        else:
            self.gains = torch.ones((o, 2) if ll == 1 else (o, ll),
                                    dtype=dtype, device=device)
        self._carried = None    # carry_from's state, for one reset()
        self._d_cur = np.zeros(o if ll == 1 else (o, ll))
        self._d_tgt = np.zeros_like(self._d_cur)
        self.on_listener(np.zeros(3) if ll == 1 else np.zeros((ll, 3)))
        self._d_cur = self._d_tgt.copy()   # start settled (no first chirp)

    def on_listener(self, pos: np.ndarray) -> None:
        """One world listener [3], or in per-client mode the merged [L, 3]
        rows (a [3] event moves every listener there)."""
        pos = np.asarray(pos, np.float64)
        if self._nl > 1 and pos.ndim == 1:
            pos = np.broadcast_to(pos, (self._nl, 3))
        self._last_listener = pos.copy()
        if self._nl > 1:
            # [O, L] per-(object, listener) propagation delays
            r = np.linalg.norm(self.positions[:, None, :]
                               - pos[None, :, :], axis=-1)
        else:
            r = np.linalg.norm(self.positions - pos, axis=-1)
        self._d_tgt = np.minimum(r * self._scale, self._h_max)

    def set_velocity(self, obj: int, vel: np.ndarray) -> None:
        """Give one object a constant world velocity: every later dispatch
        advances its position by v * (N / sample_rate) before retargeting
        its delay, so each dispatch's ramp carries the motion's Doppler
        shift with no per-frame traffic. Zero stops the motion."""
        self.velocities[int(obj)] = np.asarray(vel, np.float64).reshape(3)

    def set_position(self, obj: int, world_pos: np.ndarray) -> None:
        """Move one object (live object motion): retargets its delay from
        the last listener, so the next dispatch's ramp carries the
        object's own Doppler shift."""
        self.positions[obj] = np.asarray(world_pos, np.float64)
        self.on_listener(self._last_listener)

    def carry_from(self, old: "DopplerPostMix", listener: np.ndarray) -> None:
        """Continue ``old``, a post-mix of the same objects with fewer
        listener columns (a listener-bucket grow): its columns keep their
        delay lines, delays and listener rows bitwise, the objects their
        live positions and velocities; the added columns start settled at
        ``listener``'s rows ([L, 3]) with empty delay lines. The carried
        state, positions included, is also what the next ``reset()``
        returns to, once: the engine's start() runs the post-mix in its
        warmup and then resets it."""
        o, k = self.positions.shape[0], old._nl
        if (self._nl <= 1 or k > self._nl or old.positions.shape[0] != o
                or old._hist.shape[-1] != self._hist.shape[-1]):
            raise ValueError(
                f"cannot carry a post-mix of {old.positions.shape[0]} "
                f"objects x {k} listeners into {o} x {self._nl}")
        self.positions[...] = old.positions
        self.velocities[...] = old.velocities
        self.on_listener(np.asarray(listener, np.float64).reshape(
            self._nl, 3))
        self._d_cur = self._d_tgt.copy()
        self._d_cur[:, :k] = old._d_cur.reshape(o, k)
        self._d_tgt[:, :k] = old._d_tgt.reshape(o, k)
        self._last_listener[:k] = np.asarray(old._last_listener,
                                             np.float64).reshape(k, 3)
        self._hist[:, :k] = old._hist.reshape(o, k, -1)
        self._carried = (self._hist.clone(), self._d_cur.copy(),
                         self._d_tgt.copy(), self._last_listener.copy(),
                         self.positions.copy())

    def reset(self) -> None:
        carried, self._carried = self._carried, None
        if carried is not None:
            hist, d_cur, d_tgt, listener, positions = carried
            self._hist = hist.clone()
            self._d_cur, self._d_tgt = d_cur.copy(), d_tgt.copy()
            self._last_listener = listener.copy()
            self.positions[...] = positions
            return
        self._hist = torch.zeros_like(self._hist)
        self._d_cur = self._d_tgt.copy()

    def _run(self, sound):
        if self.velocities.any():
            # audio-clock kinematics: this dispatch covers N samples of
            # stream time; move first, then retarget, so the delay ramps
            # from r(t)/c to r(t + N/SR)/c across exactly those samples
            self.positions += self.velocities * (sound.shape[-1] / self._sr)
            self.on_listener(self._last_listener)

        def dev(d):
            return torch.as_tensor(d).to(sound.dtype).to(sound.device)
        d0, d1 = dev(self._d_cur), dev(self._d_tgt)
        if self._nl > 1:
            if sound.dim() != 3:
                raise ValueError(
                    f"per-client Doppler needs multi-listener per-object "
                    f"sound ([O, L, N] span / [L, O, S] block), got "
                    f"{tuple(sound.shape)}")
            mix, self._hist = _doppler_mix_multi(self._hist, sound, d0, d1,
                                                 self.gains)
        else:
            mix, self._hist = _doppler_mix(self._hist, sound, d0, d1,
                                           self.gains)
        self._d_cur = self._d_tgt.copy()
        return mix

    def __call__(self, sound, mix):
        # the per-block entry: the multi-listener block step emits
        # [L, O, S] (listener axis outside), the span [O, L, N]; the delay
        # lines carry the span's layout
        if self._nl > 1 and sound.dim() == 3:
            sound = sound.transpose(0, 1)
        return self._run(sound)

    def process_span(self, sound):
        return self._run(sound)


def sample_distances(
    positions,             # [T, O, 3] per-block listener-relative positions
    block_size: int,
):
    """Per-sample listener-object distances [O, T*S] (host, float64).

    Block t's row is the listener at that block's first sample; distances
    are linearly interpolated between consecutive block starts and held
    through the final block (the block-constant tail of the transfer
    schedule)."""
    positions = np.asarray(positions, np.float64)
    t, o, _ = positions.shape
    r = np.linalg.norm(positions, axis=-1)        # [T, O]
    n = t * block_size
    starts = np.arange(t) * block_size
    grid = np.arange(n)
    out = np.empty((o, n))
    for i in range(o):
        out[i] = np.interp(grid, starts, r[:, i])  # holds past the last row
    return out
