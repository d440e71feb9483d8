"""Port parity: the spherical-head HRTF (openpbso_tpu_torch.ops.hrtf)
against the JAX package.

The host FIRs are bitwise the JAX package's; the frequency-domain mixes
(per block and per span, torch.fft in place of jnp.fft) agree to <= -100
dB and carry the same (T-1)-sample tail across blocks and spans; the
post-mix and the renderer agree end to end; and tests/test_hrtf.py's
physics and streaming relations hold on the port (the ITD and head shadow,
a direct convolution, span against block with seams, the engine riding its
span dispatches).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import hrtf as jh
from openpbso_tpu.ops.coeffs import bank_from_material as j_bank
from openpbso_tpu.ops.coeffs import lambda_from_modes
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.config import OUTPUT_SCALE, SAMPLE_RATE, SOUND_SPEED
from openpbso_tpu_torch.convert import bank_from_numpy
from openpbso_tpu_torch.ops import hrtf as th
from openpbso_tpu_torch.runtime.audio import RawCollectorSink
from openpbso_tpu_torch.runtime.engine import StreamingEngine
from openpbso_tpu_torch.runtime.session import ModalSession as TSession
from openpbso_tpu_torch.runtime.solver import SolverConfig as TConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BLOCK = 128


def test_fir_design_is_bitwise():
    rng = np.random.default_rng(1)
    dirs = rng.standard_normal((5, 3))
    dirs[0] = 0.0                                 # falls back to frontal
    for kw in ({}, dict(n_taps=96, ear_axis=(0.0, 1.0, 1.0)),
               dict(head_radius=0.1, base_delay_taps=6.0)):
        np.testing.assert_array_equal(th.spherical_hrtf_fir(dirs, **kw),
                                      jh.spherical_hrtf_fir(dirs, **kw))
    alpha = rng.uniform(0.0, 2.0, (4, 2))
    for a, b in zip(th._shadow_coeffs(alpha, 3900.0, 44100.0),
                    jh._shadow_coeffs(alpha, 3900.0, 44100.0)):
        np.testing.assert_array_equal(a, b)
    tau = rng.uniform(2.0, 30.0, (4, 2))
    np.testing.assert_array_equal(th._fractional_delay(tau, 64),
                                  jh._fractional_delay(tau, 64))


def test_itd_and_shadow_physics():
    """A source on the +x ear axis: the right ear leads by the head's
    diameter over c and is brighter; a frontal source is symmetric
    (tests/test_hrtf.py:14-30)."""
    fir = th.spherical_hrtf_fir(np.asarray([[1.0, 0.0, 0.0]]), n_taps=128)
    left, right = fir[0, 0], fir[0, 1]
    itd = 2 * th.DEFAULT_HEAD_RADIUS / SOUND_SPEED * SAMPLE_RATE
    lag = int(np.argmax(np.abs(left))) - int(np.argmax(np.abs(right)))
    assert abs(lag - itd) <= 2.0
    hi = np.fft.rfftfreq(128, 1.0 / SAMPLE_RATE) > 5000.0
    assert (np.abs(np.fft.rfft(right))[hi].mean()
            > 2.0 * np.abs(np.fft.rfft(left))[hi].mean())
    front = th.spherical_hrtf_fir(np.asarray([[0.0, 0.0, 1.0]]), n_taps=128)
    np.testing.assert_allclose(front[0, 0], front[0, 1], atol=1e-12)


def test_fir_to_freq_matches_jax_and_refuses_wrapping_taps():
    fir = th.spherical_hrtf_fir(np.eye(3), n_taps=96)
    got = th.fir_to_freq(fir, BLOCK, device="cpu")
    ref = np.asarray(jh.fir_to_freq(fir, BLOCK))
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="n_taps"):
        th.fir_to_freq(np.zeros((1, 2, BLOCK + 2)), BLOCK, device="cpu")


def _signal(o, n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((o, n)).astype(np.float32) * 1e9


def test_block_mix_matches_jax_and_direct_convolution(dberr):
    o, n_blocks, taps = 3, 4, 96
    fir = th.spherical_hrtf_fir(np.random.default_rng(3).standard_normal(
        (o, 3)), n_taps=taps)
    signal = _signal(o, n_blocks * BLOCK)
    t_hf = th.fir_to_freq(fir, BLOCK, device="cpu")
    j_hf = jh.fir_to_freq(fir, BLOCK)
    t_carry = torch.zeros((2, taps - 1))
    j_carry = jnp.zeros((2, taps - 1), jnp.float32)
    got, ref = [], []
    for b in range(n_blocks):
        blk = signal[:, b * BLOCK:(b + 1) * BLOCK]
        mix, t_carry = th.hrtf_mix_block(torch.from_numpy(blk), t_hf, t_carry,
                                         block_size=BLOCK)
        got.append(mix.numpy())
        jmix, j_carry = jh.hrtf_mix_block(jnp.asarray(blk), j_hf, j_carry,
                                          block_size=BLOCK)
        ref.append(np.asarray(jmix))
        assert dberr(t_carry.numpy(), np.asarray(j_carry)) <= -100
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert got.dtype == np.float32 and got.shape == (n_blocks * BLOCK, 2)
    assert dberr(got, ref) <= -100
    direct = np.zeros((2, n_blocks * BLOCK))
    for oo in range(o):
        for c in range(2):
            direct[c] += np.convolve(signal[oo].astype(np.float64),
                                     fir[oo, c])[: n_blocks * BLOCK]
    assert dberr(got, (direct / OUTPUT_SCALE).T) <= -100


def test_span_mix_matches_jax(dberr):
    o, taps, n = 3, 96, 5 * BLOCK
    fir = th.spherical_hrtf_fir(np.random.default_rng(4).standard_normal(
        (o, 3)), n_taps=taps)
    signal = _signal(o, n, seed=4)
    carry = np.random.default_rng(5).standard_normal((2, taps - 1)).astype(
        np.float32) * 1e9
    hf = np.fft.rfft(fir, n=2 * n, axis=-1)
    got, g_carry = th.hrtf_mix_span(
        torch.from_numpy(signal), torch.as_tensor(hf).to(torch.complex64),
        torch.from_numpy(carry), n_samples=n)
    ref, r_carry = jh.hrtf_mix_span(
        jnp.asarray(signal), jnp.asarray(hf, jnp.complex64),
        jnp.asarray(carry), n_samples=n)
    assert dberr(got.numpy(), np.asarray(ref)) <= -100
    assert dberr(g_carry.numpy(), np.asarray(r_carry)) <= -100


def test_span_matches_block_streaming_across_seams(dberr):
    """process_span (one 2N-point overlap-save) equals per-block chaining,
    with the tail handed over across a span, a block and a span
    (tests/test_hrtf.py:159-182)."""
    o, taps, s = 3, 96, BLOCK
    positions = np.random.default_rng(5).standard_normal((o, 3))
    sound = torch.from_numpy(_signal(o, 8 * s, seed=5))
    blk = th.HRTFPostMix(positions, block_size=s, n_taps=taps, device="cpu")
    ref = torch.cat([blk(sound[:, i * s:(i + 1) * s], None)
                     for i in range(8)])
    span = th.HRTFPostMix(positions, block_size=s, n_taps=taps, device="cpu")
    got = torch.cat([span.process_span(sound[:, :5 * s]),
                     span(sound[:, 5 * s:6 * s], None),
                     span.process_span(sound[:, 6 * s:])])
    assert dberr(got.numpy(), ref.numpy()) <= -100


def test_post_mix_matches_jax(dberr):
    """A post-mix sequence of blocks, a listener move, a span and a reset,
    in both packages."""
    o, taps = 3, 96
    positions = np.random.default_rng(6).standard_normal((o, 3))
    sound = _signal(o, 7 * BLOCK, seed=6)
    jp = jh.HRTFPostMix(positions, block_size=BLOCK, n_taps=taps)
    tp = th.HRTFPostMix(positions, block_size=BLOCK, n_taps=taps,
                        device="cpu")
    assert tp.n_taps == jp.n_taps
    got, ref = [], []
    for step, (a, b) in enumerate([(0, 1), (1, 2), (2, 5), (5, 6), (6, 7)]):
        if step == 2:
            for p in (jp, tp):
                p.on_listener(np.asarray([0.4, -0.3, 0.2]))
        if step == 4:
            for p in (jp, tp):
                p.reset()
        x = sound[:, a * BLOCK:b * BLOCK]
        if b - a == 1:
            got.append(tp(torch.from_numpy(x), None).numpy())
            ref.append(np.asarray(jp(jnp.asarray(x), None)))
        else:
            got.append(tp.process_span(torch.from_numpy(x)).numpy())
            ref.append(np.asarray(jp.process_span(jnp.asarray(x))))
    assert dberr(np.concatenate(got), np.concatenate(ref)) <= -100
    np.testing.assert_array_equal(tp._fir, jp._fir)
    assert set(tp._hf_span) == set(jp._hf_span) == {3 * BLOCK}


def _banks(o=2, n_modes=16, s=BLOCK, seed=2):
    md = synth_mode_data(n_modes, 8, seed=seed)
    jbank = j_bank(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                   CERAMIC.beta, num_objects=o, block_size=s,
                   dtype=jnp.float32)
    lam64 = lambda_from_modes(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta)[0]
    return jbank, bank_from_numpy(jax.tree.map(np.asarray, jbank),
                                  device="cpu"), lam64


def test_renderer_matches_jax(dberr):
    """HRTFRenderer end to end: the +x object loads and leads the right
    ear, and the port renders what the JAX renderer does."""
    jbank, tbank, _ = _banks()
    positions = np.asarray([[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]])
    out = []
    for sess, mod in ((JSession(jbank, config=JConfig(block_size=BLOCK,
                                                      backend="blocked")), jh),
                      (TSession(tbank, config=TConfig(block_size=BLOCK,
                                                      backend="blocked")), th)):
        r = mod.HRTFRenderer(sess, positions, n_taps=96)
        r.set_listener(np.zeros(3))
        sess.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
        out.append(r.render(8))
    ref, got = out
    assert got.shape == (8 * BLOCK, 2)
    assert dberr(got, ref) <= -100
    assert (got[:, 1] ** 2).sum() > (got[:, 0] ** 2).sum()
    xc = np.correlate(got[:, 1], got[:, 0], mode="full")
    assert int(np.argmax(np.abs(xc))) - (got.shape[0] - 1) < 0
    with pytest.raises(ValueError, match="positions"):
        th.HRTFRenderer(TSession(tbank, config=TConfig(block_size=BLOCK)),
                        np.zeros((3, 3)))


def _stream(lookahead, lam, n_blocks=24):
    _, tbank, lam64 = _banks()
    sess = TSession(tbank, config=TConfig(block_size=BLOCK,
                                          backend="blocked"),
                    lam64=np.broadcast_to(lam64, (2, lam64.shape[-1]))
                    if lam else None)
    pm = th.HRTFPostMix(np.asarray([[0.7, 0.0, 0.0], [-0.7, 0.0, 0.0]]),
                        block_size=BLOCK, n_taps=96, device="cpu")
    spans = []
    inner = sess._step_span_sound
    sess._step_span_sound = lambda *a, **k: spans.append(a) or inner(*a, **k)
    eng = StreamingEngine(sess, RawCollectorSink(), post_mix=pm,
                          lookahead=lookahead)
    produced = []
    synth = eng._synth_once

    def tapped():
        blocks = synth()
        produced.extend(np.array(b) for b in blocks)
        return blocks
    eng._synth_once = tapped
    eng.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
    eng.start()
    deadline = time.time() + 120.0
    while len(produced) < n_blocks and time.time() < deadline:
        time.sleep(0.01)
    eng.set_listener(np.asarray([0.0, 0.0, 0.2]))   # the on_listener hook
    eng.stop()
    assert eng.error is None
    return np.concatenate(produced[:n_blocks]), spans


@pytest.mark.parametrize("lookahead,lam", [(1, False), (4, False), (4, True)])
def test_engine_streams_through_the_post_mix(lookahead, lam, dberr):
    """The engine mixes through the HRTF per block, per lookahead batch,
    and on span sessions through process_span (the span dispatch kept);
    the +x object loads the right ear, and every form gives the same
    audio."""
    audio, spans = _stream(lookahead, lam)
    assert audio.shape == (24 * BLOCK, 2) and np.abs(audio).max() > 0
    assert (audio[:, 1] ** 2).sum() > (audio[:, 0] ** 2).sum()
    assert bool(spans) == lam
    if lam:
        assert all(a[0] == lookahead for a in spans)
    ref, _ = _stream(1, False)
    assert dberr(audio, ref) <= -90
