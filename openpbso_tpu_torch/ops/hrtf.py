"""Parametric spherical-head HRTF rendering.

Counterpart of openpbso_tpu/ops/hrtf.py. The reference renders mono
duplicated to both ears (real_time_modal_sound.cpp:207-210); the Scene's
binaural mode adds interaural level cues through per-ear FFAT lookups. This
module adds the head itself, from the classic spherical-head model (Brown &
Duda, "A structural model for binaural sound synthesis", IEEE TSAP 1998):

- head shadow: the first-order filter H(s) = (alpha(theta) s + w0) /
  (s + w0), w0 = c / a, alpha(theta) = 1 + cos(theta): a gentle high shelf
  on the near side, a 6 dB/oct roll-off on the far side;
- ITD: Woodworth's delay tau(theta) = (a / c) (1 - cos(theta)) toward the
  far ear (theta is the angle between the source direction and the ear).

Each (object, ear) filter is a short FIR built on the host (a windowed-sinc
fractional delay convolved with the bilinear-transformed shadow filter),
and a block of O objects is mixed in one frequency-domain pass on the
device, mix_c = sum_o h_{o,c} (*) sound_o: an rfft over the block, one
[O, F] x [O, C, F] reduce, one irfft (torch.fft, as the JAX package uses
jnp.fft), with the (T-1)-sample tail of the convolution carried across
blocks and spans as explicit state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import OUTPUT_SCALE, SAMPLE_RATE, SOUND_SPEED
from ..device import resolve_device

DEFAULT_HEAD_RADIUS = 0.0875   # meters (average adult)
DEFAULT_TAPS = 128


def _shadow_coeffs(alpha: np.ndarray, w0: float, fs: float):
    """Bilinear transform of H(s) = (alpha s + w0) / (s + w0).

    Returns (b0, b1, a1) for y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1].
    """
    k = 2.0 * fs
    b0 = (w0 + alpha * k) / (w0 + k)
    b1 = (w0 - alpha * k) / (w0 + k)
    a1 = (w0 - k) / (w0 + k)
    return b0, b1, a1


def _fractional_delay(tau_samples: np.ndarray, n_taps: int) -> np.ndarray:
    """Windowed-sinc fractional delay FIRs, shape [..., n_taps]."""
    n = np.arange(n_taps)
    x = n - tau_samples[..., None]
    h = np.sinc(x)
    # a Hann window centered on the delay keeps the kernel compact
    w = 0.5 + 0.5 * np.cos(np.clip(x / (n_taps / 2), -1.0, 1.0) * np.pi)
    return h * w


def spherical_hrtf_fir(
    directions: np.ndarray,            # [O, 3] source dir in listener frame
    *,
    ear_axis=(1.0, 0.0, 0.0),          # left ear at -axis, right at +axis
    head_radius: float = DEFAULT_HEAD_RADIUS,
    n_taps: int = DEFAULT_TAPS,
    sample_rate: float = SAMPLE_RATE,
    base_delay_taps: float = 4.0,
) -> np.ndarray:
    """Per-(object, ear) FIRs [O, 2, n_taps] (float64, host).

    ``directions`` need not be normalized (zero vectors fall back to a
    frontal source). Ear order is (left, right). ``base_delay_taps`` is a
    common lead-in that keeps the near ear's fractional delay causal.
    """
    d = np.asarray(directions, np.float64)
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(norm > 1e-12, d / np.maximum(norm, 1e-12),
                 np.asarray([0.0, 0.0, 1.0]))
    ear = np.asarray(ear_axis, np.float64)
    ear = ear / np.linalg.norm(ear)
    cos_t = np.stack([-d @ ear, d @ ear], axis=-1)      # [O, 2], +1 = at ear

    a_over_c = head_radius / SOUND_SPEED
    tau = a_over_c * (1.0 - cos_t) * sample_rate + base_delay_taps  # samples
    alpha = 1.0 + cos_t                                  # [0, 2]
    w0 = SOUND_SPEED / head_radius

    delay = _fractional_delay(tau, n_taps)               # [O, 2, T]
    b0, b1, a1 = _shadow_coeffs(alpha, w0, sample_rate)

    # impulse response of the shadow IIR, then FIR = shadow (*) delay,
    # truncated back to n_taps (the one-pole tail decays in ~80 taps)
    t = delay.shape[-1]
    x = np.concatenate([delay, np.zeros_like(delay)], axis=-1)
    y = np.zeros_like(x)
    y[..., 0] = b0 * x[..., 0]
    for n in range(1, 2 * t):
        y[..., n] = (b0 * x[..., n] + b1 * x[..., n - 1]
                     - a1 * y[..., n - 1])
    return y[..., :t]


def _overlap_save(sound, hf, carry, n_samples):
    """One frequency-domain mix of N samples with a 2N-point FFT: (mix
    [N, C] float32 output-scaled, carry' [C, T-1])."""
    n2 = 2 * n_samples
    t1 = carry.shape[-1]
    sf = torch.fft.rfft(sound, n=n2, dim=-1)             # [O, F]
    yf = torch.einsum("of,ocf->cf", sf, hf)
    y = torch.fft.irfft(yf, n=n2, dim=-1)[:, : n_samples + t1]
    y = torch.cat([y[:, :t1] + carry, y[:, t1:]], dim=-1)
    mix = (y[:, :n_samples] / OUTPUT_SCALE).T.to(torch.float32)
    return mix, y[:, n_samples:].to(carry.dtype)


def hrtf_mix_block(
    sound: torch.Tensor,     # [O, S] raw per-object modal sound
    hf: torch.Tensor,        # [O, C, F] rfft of the FIRs at n = 2 * S
    carry: torch.Tensor,     # [C, T-1] convolution tail of the prior block
    *,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One block of frequency-domain HRTF mixdown: (mix [S, C] float32
    output-scaled, carry' [C, T-1]). Needs n_taps <= block_size + 1 (the
    rfft length is 2 * block_size)."""
    return _overlap_save(sound, hf, carry, block_size)


def fir_to_freq(fir: np.ndarray, block_size: int,
                dtype: torch.dtype = torch.complex64,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Host: rfft the [O, C, T] FIRs to the device layout [O, C, F].
    ``device`` None is the CUDA device (device.resolve_device)."""
    t = fir.shape[-1]
    if t > block_size + 1:
        raise ValueError(f"n_taps {t} > block_size+1 {block_size + 1}; "
                         f"the 2S-point FFT would wrap the tail")
    hf = np.fft.rfft(fir, n=2 * block_size, axis=-1)
    return torch.as_tensor(hf).to(dtype=dtype, device=resolve_device(device))


def hrtf_mix_span(
    sound: torch.Tensor,     # [O, N] raw per-object modal sound (whole span)
    hf: torch.Tensor,        # [O, C, F] rfft of the FIRs at n = 2 * N
    carry: torch.Tensor,     # [C, T-1] convolution tail of the prior span
    *,
    n_samples: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A whole span of HRTF mixdown in one frequency-domain pass.

    The mix is a plain causal convolution, so a span of N samples is the
    same overlap-save with a 2N-point FFT, block-exact, with the same
    carry: the (T-1)-sample tail hands over across spans and blocks, so a
    stream may mix span and per-block calls without a seam. This is what
    lets binaural streams ride the engine's span dispatches. Returns (mix
    [N, C], carry' [C, T-1]).
    """
    return _overlap_save(sound, hf, carry, n_samples)


class HRTFPostMix:
    """StreamingEngine ``post_mix`` hook: binaural HRTF mixdown per block.

    Replaces the session's plain gain mixdown inside a live stream::

        pm = HRTFPostMix(positions, block_size=sess.config.block_size)
        engine = StreamingEngine(sess, sink, post_mix=pm)

    The engine calls ``on_listener`` when a listener event applies (the
    direction-dependent filters track the move) and ``reset`` after warmup.
    Only the synthesis thread calls ``__call__``, ``process_span`` and
    ``on_listener``, so the carry needs no lock.
    """

    def __init__(self, positions: np.ndarray, *, block_size: int,
                 ear_axis=(1.0, 0.0, 0.0),
                 head_radius: float = DEFAULT_HEAD_RADIUS,
                 n_taps: int = DEFAULT_TAPS,
                 device: torch.device | str | None = None):
        """``positions``: [O, 3] object centers (world frame). ``device``
        None is the CUDA device (device.resolve_device)."""
        self.device = resolve_device(device)
        self.positions = np.asarray(positions, np.float64)
        self.block_size = block_size
        self.ear_axis = ear_axis
        self.head_radius = head_radius
        self.n_taps = min(n_taps, block_size + 1)
        self._carry = torch.zeros((2, self.n_taps - 1), dtype=torch.float32,
                                  device=self.device)
        # per-span-length frequency tables (process_span), rebuilt lazily
        # after each listener move
        self._hf_span: dict[int, torch.Tensor] = {}
        self.on_listener(np.zeros(3))

    def on_listener(self, pos: np.ndarray) -> None:
        self._fir = spherical_hrtf_fir(
            self.positions - np.asarray(pos, np.float64),
            ear_axis=self.ear_axis,
            head_radius=self.head_radius,
            n_taps=self.n_taps)
        self._hf = fir_to_freq(self._fir, self.block_size,
                               device=self.device)
        self._hf_span.clear()

    def reset(self) -> None:
        self._carry = torch.zeros_like(self._carry)

    def __call__(self, sound, mix):
        out, self._carry = hrtf_mix_block(sound, self._hf, self._carry,
                                          block_size=self.block_size)
        return out

    def process_span(self, sound) -> torch.Tensor:
        """[O, N] whole-span sound -> [N, C] binaural mix (hrtf_mix_span):
        the engine keeps the span dispatch for a post-mix with this method,
        one length-2N FFT mix instead of N/S per-block ones. The carry is
        the per-block path's, so a stream may interleave both (a qnorm
        block between spans) without a seam."""
        n = int(sound.shape[-1])
        hf = self._hf_span.get(n)
        if hf is None:
            hf = torch.as_tensor(np.fft.rfft(self._fir, n=2 * n, axis=-1)).to(
                dtype=torch.complex64, device=self.device)
            self._hf_span[n] = hf
        out, self._carry = hrtf_mix_span(sound, hf, self._carry,
                                         n_samples=n)
        return out


class HRTFRenderer:
    """Binaural post-renderer over a ModalSession.

    Wraps a session whose per-object ``sound`` is mono and applies the
    spherical-head HRTF of each object's direction from the listener, in
    place of the session's gain mixdown::

        r = HRTFRenderer(session, positions)   # [O, 3] object centers
        r.set_listener(np.array([1.0, 0.0, 0.5]))
        session.hit(0, space)
        stereo = r.render(num_blocks)          # [N*S, 2]

    The session's FFAT transfer still shapes each mode's magnitude (it is
    part of ``sound``); the HRTF adds the interaural time and shadow cues
    the transfer maps cannot express. One more device pass per block.
    """

    def __init__(self, session, positions: np.ndarray, *,
                 ear_axis=(1.0, 0.0, 0.0),
                 head_radius: float = DEFAULT_HEAD_RADIUS,
                 n_taps: int = DEFAULT_TAPS):
        self.session = session
        self.positions = np.asarray(positions, np.float64)
        if self.positions.shape != (session.bank.num_objects, 3):
            raise ValueError("positions must be [num_objects, 3]")
        self.ear_axis = ear_axis
        self.head_radius = head_radius
        self.n_taps = min(n_taps, session.config.block_size + 1)
        self._carry = torch.zeros((2, self.n_taps - 1), dtype=torch.float32,
                                  device=session.device)
        self._hf = None
        self.set_listener(np.zeros(3))

    def set_listener(self, pos: np.ndarray) -> None:
        """Move the listener: updates the session's FFAT transfer and the
        per-object HRTF filters (directions are listener-relative)."""
        pos = np.asarray(pos, np.float64)
        self.session.set_listener(pos)
        fir = spherical_hrtf_fir(self.positions - pos[None, :],
                                 ear_axis=self.ear_axis,
                                 head_radius=self.head_radius,
                                 n_taps=self.n_taps)
        self._hf = fir_to_freq(fir, self.session.config.block_size,
                               device=self.session.device)

    def step(self) -> torch.Tensor:
        """One block -> [S, 2] float32 binaural mix."""
        sound, _, _ = self.session.step()
        mix, self._carry = hrtf_mix_block(
            sound, self._hf, self._carry,
            block_size=self.session.config.block_size)
        return mix

    def render(self, num_blocks: int) -> np.ndarray:
        return np.concatenate([self.step().cpu().numpy()
                               for _ in range(num_blocks)], axis=0)
