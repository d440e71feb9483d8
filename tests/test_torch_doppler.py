"""Port parity: physical Doppler (openpbso_tpu_torch.ops.doppler and
ModalSession.render_doppler) against the JAX package.

The host splits (delay_indices, sample_distances) are bitwise; the device
gathers (delay_resample, the live delay lines) and DopplerPostMix's
sequence of moves, velocities and resets agree to <= -100 dB with its
float64 host state bitwise; render_doppler agrees single- and
multi-listener, with object centers and state events. The physics of
tests/test_moving.py:156-272 and 403-520 hold on the port: the (1 + v/c)
frequency shift, the arrival delay, span/block parity of the live delay
line, per-client delay lines, audio-clock object velocity; and the engine
streams through the post-mix and exports a Doppler timeline as the JAX
engine does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import doppler as jd
from openpbso_tpu.ops.coeffs import bank_from_material as j_bank
from openpbso_tpu.ops.coeffs import lambda_from_modes
from openpbso_tpu.ops.ffat import build_ffat
from openpbso_tpu.runtime.audio import RawCollectorSink as JCollector
from openpbso_tpu.runtime.engine import StreamingEngine as JEngine
from openpbso_tpu.runtime.engine import TransferEvent as JTransfer
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube, synth_mode_data
from openpbso_tpu_torch.config import SAMPLE_RATE, SOUND_SPEED
from openpbso_tpu_torch.convert import bank_from_numpy, ffat_from_numpy
from openpbso_tpu_torch.ops import doppler as td
from openpbso_tpu_torch.ops.coeffs import bank_from_material
from openpbso_tpu_torch.runtime.audio import RawCollectorSink
from openpbso_tpu_torch.runtime.engine import StreamingEngine, TransferEvent
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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_host_splits_are_bitwise():
    rng = np.random.default_rng(1)
    positions = rng.uniform(-8.0, 8.0, (7, 3, 3))
    dist = td.sample_distances(positions, 128)
    np.testing.assert_array_equal(dist, jd.sample_distances(positions, 128))
    for c in (SOUND_SPEED, 200.0):
        i0, frac = td.delay_indices(dist, c)
        ri0, rfrac = jd.delay_indices(dist, c)
        assert i0.dtype == np.int32 and frac.dtype == np.float32
        np.testing.assert_array_equal(i0, ri0)
        np.testing.assert_array_equal(frac, rfrac)


def test_delay_resample_matches_jax(dberr):
    rng = np.random.default_rng(2)
    o, n = 3, 2048
    sound = rng.standard_normal((o, n)).astype(np.float32) * 1e9
    dist = np.linspace(1.0, 3.0, n)[None] * rng.uniform(0.5, 1.5, (o, 1))
    i0, frac = td.delay_indices(dist)
    gains = rng.uniform(0.5, 1.5, (o, 2)).astype(np.float32)
    ref = np.asarray(jd.delay_resample(jnp.asarray(sound), jnp.asarray(i0),
                                       jnp.asarray(frac), jnp.asarray(gains)))
    got = td.delay_resample(_t(sound), _t(i0), _t(frac), _t(gains))
    assert got.dtype == torch.float32 and got.shape == (n, 2)
    assert (ref[:int(dist.min() * SAMPLE_RATE / SOUND_SPEED) - 1] == 0).all()
    assert dberr(got.numpy(), ref) <= -100


@pytest.mark.parametrize("multi", [False, True])
def test_delay_lines_match_jax(multi, dberr):
    rng = np.random.default_rng(3)
    o, nl, h, n = 3, 2, 300, 512
    lead = (o, nl) if multi else (o,)
    hist = rng.standard_normal(lead + (h,)).astype(np.float32)
    sound = rng.standard_normal(lead + (n,)).astype(np.float32)
    d0 = rng.uniform(10.0, 250.0, lead).astype(np.float32)
    d1 = rng.uniform(10.0, 250.0, lead).astype(np.float32)
    gains = rng.uniform(0.5, 1.5, (o, nl)).astype(np.float32)
    jfn, tfn = ((jd._doppler_mix_multi, td._doppler_mix_multi) if multi
                else (jd._doppler_mix, td._doppler_mix))
    rmix, rhist = jfn(*(jnp.asarray(x) for x in (hist, sound, d0, d1,
                                                 gains)))
    mix, new_hist = tfn(*(_t(x) for x in (hist, sound, d0, d1, gains)))
    assert mix.shape == (n, nl) and mix.dtype == torch.float32
    assert dberr(mix.numpy(), np.asarray(rmix)) <= -100
    np.testing.assert_array_equal(new_hist.numpy(), np.asarray(rhist))


@pytest.mark.parametrize("nl", [1, 3])
def test_post_mix_sequence_matches_jax(nl, dberr):
    """A sequence of listener events, a velocity, an object move, span and
    block dispatches and a reset: the same mixes, delays and positions."""
    rng = np.random.default_rng(4)
    o, s = 4, 128
    positions = rng.uniform(-3.0, 3.0, (o, 3))
    gains = rng.uniform(0.5, 1.5, (o, 2 if nl == 1 else nl))
    jp = jd.DopplerPostMix(positions, gains=gains, num_listeners=nl,
                           max_distance=10.0)
    tp = td.DopplerPostMix(positions, gains=gains, num_listeners=nl,
                           max_distance=10.0, device="cpu")
    lead = (o,) if nl == 1 else (o, nl)

    def sound(n):
        return rng.standard_normal(lead + (n,)).astype(np.float32)
    listener = (rng.uniform(-2, 2, 3) if nl == 1
                else rng.uniform(-2, 2, (nl, 3)))
    steps = [("listener", listener), ("span", sound(3 * s)),
             ("velocity", (1, np.asarray([4.0, -2.0, 0.5]))),
             ("span", sound(2 * s)), ("block", sound(s)),
             ("position", (2, np.asarray([1.0, 1.0, -1.0]))),
             ("listener", np.zeros(3)), ("block", sound(s)), ("reset", None),
             ("span", sound(4 * s))]
    for kind, arg in steps:
        if kind == "listener":
            jp.on_listener(arg)
            tp.on_listener(arg)
        elif kind == "velocity":
            jp.set_velocity(*arg)
            tp.set_velocity(*arg)
        elif kind == "position":
            jp.set_position(*arg)
            tp.set_position(*arg)
        elif kind == "reset":
            jp.reset()
            tp.reset()
        else:
            blk = arg if kind == "span" or nl == 1 else np.swapaxes(arg, 0, 1)
            if kind == "span":
                ref = jp.process_span(jnp.asarray(blk))
                got = tp.process_span(_t(blk))
            else:
                ref = jp(jnp.asarray(blk), None)
                got = tp(_t(blk), None)
            assert got.shape == ref.shape
            assert dberr(got.numpy(), np.asarray(ref)) <= -100
        for name in ("positions", "velocities", "_d_cur", "_d_tgt"):
            np.testing.assert_array_equal(getattr(tp, name),
                                          getattr(jp, name), err_msg=name)


def test_post_mix_copies_positions_and_checks_layout():
    """The post-mix moves its own copy of the centers (a float64 caller
    array is not drifted), and per-client mode needs [O, L, N] sound."""
    caller = np.asarray([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    pm = td.DopplerPostMix(caller, device="cpu")
    pm.set_velocity(0, [5.0, 0.0, 0.0])
    pm.process_span(torch.zeros((2, 256)))
    assert caller[0, 0] == 1.0 and pm.positions[0, 0] > 1.0
    multi = td.DopplerPostMix(caller, num_listeners=2, device="cpu")
    with pytest.raises(ValueError, match="per-client"):
        multi.process_span(torch.zeros((2, 256)))


def test_span_equals_chained_blocks(dberr):
    """One span equals chained blocks through the same delay line
    (tests/test_moving.py:230-269) up to the float32 rounding of their
    different buffer-relative index grids."""
    rng = np.random.default_rng(3)
    o, s, nb = 2, 128, 6
    positions = np.asarray([[2.0, 0.0, 0.0], [0.0, 3.0, 0.0]])
    sound = rng.standard_normal((o, nb * s)).astype(np.float32)
    a = td.DopplerPostMix(positions, max_distance=10.0, device="cpu")
    ref = torch.cat([a(_t(sound[:, i * s:(i + 1) * s]), None)
                     for i in range(nb)])
    b = td.DopplerPostMix(positions, max_distance=10.0, device="cpu")
    got = torch.cat([b.process_span(_t(sound[:, :3 * s])),
                     b.process_span(_t(sound[:, 3 * s:]))])
    assert dberr(got.numpy(), ref.numpy()) <= -80


def test_per_client_lines_equal_single_listener_lines():
    """Column l of the per-client post-mix equals a single-listener
    post-mix on listener l's rows (tests/test_moving.py:460-520)."""
    rng = np.random.default_rng(7)
    o, ll, s = 2, 2, 128
    positions = np.asarray([[2.0, 0.0, 0.0], [0.0, 3.0, 0.0]])
    rows = np.asarray([[0.5, 0.0, 0.0], [-1.0, 0.5, 0.0]])
    gains = rng.uniform(0.5, 1.5, (o, ll))
    sound = rng.standard_normal((o, ll, 6 * s)).astype(np.float32)
    multi = td.DopplerPostMix(positions, num_listeners=ll, gains=gains,
                              max_distance=10.0, device="cpu")
    multi.on_listener(rows)
    got = multi.process_span(_t(sound)).numpy()
    for li in range(ll):
        single = td.DopplerPostMix(positions, gains=gains[:, li:li + 1],
                                   max_distance=10.0, device="cpu")
        single.on_listener(rows[li])
        ref = single.process_span(_t(sound[:, li])).numpy()[:, 0]
        np.testing.assert_allclose(got[:, li], ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("k", [1, 2])
def test_carry_from_continues_the_old_columns(k):
    """A listener-bucket grow (k -> 4 columns): the grown post-mix carries
    the old columns' delay lines, delays (a retarget not yet ramped too),
    rows, positions and velocities, and its first reset() returns to that
    state, once. Its old columns then go on as the old post-mix would;
    the added ones as a fresh post-mix settled at their rows."""
    rng = np.random.default_rng(11)
    o, ll, s = 3, 4, 128
    positions = rng.uniform(-2.0, 2.0, (o, 3))
    gains = rng.uniform(0.5, 1.5, (o, ll))
    rows = rng.uniform(-1.0, 1.0, (ll, 3))
    old = td.DopplerPostMix(positions, num_listeners=k,
                            gains=gains[:, :k] if k > 1 else None,
                            max_distance=10.0, device="cpu")
    old.on_listener(rows[:k] if k > 1 else rows[0])
    old.set_velocity(1, [3.0, 0.0, 0.0])
    for _ in range(3):
        old.process_span(_t(rng.standard_normal(
            (o, k, s) if k > 1 else (o, s)).astype(np.float32)))
    old.on_listener(rows[:k] + 0.2 if k > 1 else rows[0] + 0.2)
    new = td.DopplerPostMix(positions, num_listeners=ll, gains=gains,
                            max_distance=10.0, device="cpu")
    new.carry_from(old, rows)
    new.process_span(_t(rng.standard_normal((o, ll, s)).astype(np.float32)))
    new.reset()                          # start()'s reset after its warmup
    assert torch.equal(new._hist[:, :k], old._hist.reshape(o, k, -1))
    assert not new._hist[:, k:].any()
    np.testing.assert_array_equal(new._d_cur[:, :k],
                                  old._d_cur.reshape(o, k))
    np.testing.assert_array_equal(new._d_tgt[:, :k],
                                  old._d_tgt.reshape(o, k))
    np.testing.assert_array_equal(new.positions, old.positions)
    np.testing.assert_array_equal(new.velocities, old.velocities)
    sound = rng.standard_normal((o, ll, 2 * s)).astype(np.float32)
    got = new.process_span(_t(sound)).numpy()
    if k > 1:
        ref = old.process_span(_t(sound[:, :k])).numpy()
        np.testing.assert_allclose(got[:, :k], ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    fresh = td.DopplerPostMix(positions, num_listeners=ll - k,
                              gains=gains[:, k:], max_distance=10.0,
                              device="cpu")
    fresh.positions[...] = old.positions
    fresh.on_listener(rows[k:])
    fresh.reset()
    fresh.velocities[...] = old.velocities
    ref = fresh.process_span(_t(sound[:, k:])).numpy()
    np.testing.assert_allclose(got[:, k:], ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    new.reset()                          # the carried state only once
    assert not new._hist.any()
    with pytest.raises(ValueError, match="cannot carry"):
        td.DopplerPostMix(positions[:2], num_listeners=ll,
                          device="cpu").carry_from(old, rows)


def _tone_session(f0=1000.0, block=512, alpha=1e-2, beta=1e-7, nl=1):
    density = 2700.0
    omega = 2 * np.pi * f0
    omega_sq = np.asarray([omega * omega * density])
    bank = bank_from_material(density, omega_sq, alpha, beta, num_objects=1,
                              block_size=block, device="cpu")
    return TSession(bank, config=TConfig(block_size=block,
                                         backend="blocked"),
                    num_listeners=nl)


def _dominant_freq(x, sr=SAMPLE_RATE):
    crossings = np.count_nonzero(np.diff(np.sign(x)) != 0)
    return crossings / 2 * sr / x.size


def test_frequency_shift_of_an_approach():
    """An approaching listener hears the mode shifted by (1 + v/c)
    (tests/test_moving.py:156-182)."""
    block, f0 = 512, 1000.0
    v = 0.05 * SOUND_SPEED
    sess = _tone_session(f0=f0, block=block)
    sess.hit(0, np.ones(1), kind="point")
    t_blocks = 86
    times = np.arange(t_blocks) * block / SAMPLE_RATE
    rel = np.zeros((t_blocks, 3))
    rel[:, 0] = 30.0 - v * times
    mix = sess.render_doppler(rel)
    assert mix.shape == (t_blocks * block, 2)
    w0, w1 = int(0.3 * SAMPLE_RATE), int(0.95 * SAMPLE_RATE)
    got = _dominant_freq(mix[w0:w1, 0])
    assert abs(got - f0 * (1 + v / SOUND_SPEED)) < 5.0, got


def test_arrival_delay_and_static_parity():
    """A static listener at r hears the render delayed by r/c: silence
    before the wavefront, an exact integer-delay copy after."""
    block, delay = 256, 64
    a, b = _tone_session(f0=700.0, block=block), _tone_session(
        f0=700.0, block=block)
    for s in (a, b):
        s.hit(0, np.ones(1), kind="gaussian", width_us=400.0)
    rel = np.zeros((8, 3))
    rel[:, 2] = delay * SOUND_SPEED / SAMPLE_RATE
    got, ref = a.render_doppler(rel), b.render(8)
    assert np.abs(got[:delay]).max() == 0.0
    np.testing.assert_allclose(got[delay:, 0], ref[: 8 * block - delay, 0],
                               rtol=0, atol=1e-7)


def test_multi_listener_path_validation():
    sess = _tone_session(block=128, nl=2)
    with pytest.raises(ValueError, match="listener path"):
        sess.render_doppler(np.ones((4, 3, 3)))
    out = sess.render_doppler(np.ones((4, 3)) * 2.0)
    assert out.shape == (4 * 128, 2) and np.isfinite(out).all()


def test_object_velocity_on_the_audio_clock():
    """set_velocity integrates each object's position on the audio clock,
    and the delay ramp shifts a tone's received cycle count by the full
    Doppler accumulation (tests/test_moving.py:403-457)."""
    f0, n, spans, v = 900.0, 2048, 8, 20.0
    pm = td.DopplerPostMix(np.asarray([[10.0, 0.0, 0.0]]),
                           max_distance=12.0, device="cpu")
    pm.set_velocity(0, [-v, 0.0, 0.0])
    tone = np.sin(2 * np.pi * f0 * np.arange(spans * n) / SAMPLE_RATE)
    tone = tone.astype(np.float32)[None, :]
    out = torch.cat([pm.process_span(_t(tone[:, i * n:(i + 1) * n]))
                     for i in range(spans)]).numpy()[:, 0]
    moved = v * spans * n / SAMPLE_RATE
    np.testing.assert_allclose(pm.positions[0], [10.0 - moved, 0.0, 0.0],
                               atol=1e-9)
    d_f = float(pm._d_cur[0])
    n_a = int(np.argmax(out != 0.0))
    cycles = np.sum(np.abs(np.diff(np.signbit(out[n_a:])))) / 2.0
    expected = f0 / SAMPLE_RATE * (spans * n - d_f)
    static = f0 / SAMPLE_RATE * (spans * n - n_a)
    assert abs(cycles - expected) < 3.0 and abs(cycles - static) > 8.0
    pm.set_velocity(0, np.zeros(3))
    frozen = pm.positions.copy()
    pm.process_span(_t(tone[:, :n]))
    np.testing.assert_array_equal(pm.positions, frozen)


S, O, N = 128, 3, 12


@pytest.fixture(scope="module")
def ffat_pair():
    md = synth_mode_data(N, 8, seed=5)
    lam64 = lambda_from_modes(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta)[0]
    jbank = j_bank(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                   CERAMIC.beta, num_objects=O, block_size=S,
                   dtype=jnp.float32)
    jffat = build_ffat({i: synth_fatcube(i, 300.0 * (i + 1), n=6, seed=3)
                        for i in range(N)}, jbank.num_modes,
                       dtype=jnp.float32)
    tbank = bank_from_numpy(jax.tree.map(np.asarray, jbank), device="cpu")
    tffat = ffat_from_numpy(jax.tree.map(np.asarray, jffat), device="cpu")

    def make(nl=1, lam=False, smooth=False):
        kw = dict(num_listeners=nl,
                  lam64=np.broadcast_to(lam64, (O, N)) if lam else None)
        return (JSession(jbank, jffat, JConfig(block_size=S,
                                               backend="blocked",
                                               smooth_transfer=smooth), **kw),
                TSession(tbank, tffat, TConfig(block_size=S,
                                               backend="blocked",
                                               smooth_transfer=smooth), **kw))
    return make


def _path(t, nl=1):
    base = np.stack([np.linspace(4.0, 1.5, t), np.full(t, 0.3),
                     np.linspace(0.5, 1.2, t)], axis=1)
    if nl == 1:
        return base
    return base[:, None, :] + np.asarray([[0.09, 0, 0], [-0.09, 0, 0]])[None]


def _strike(sess):
    sess.hit(0, np.linspace(0.3, 1.0, N), kind="gaussian", width_us=400.0)
    sess.hit(2, np.linspace(1.0, -0.5, N), kind="point", when=3 * S)


@pytest.mark.parametrize("nl", [1, 2])
def test_render_doppler_matches_jax(ffat_pair, nl, dberr):
    js, ts = ffat_pair(nl=nl, smooth=True)
    path = _path(10, nl)
    for s in (js, ts):
        s.set_listener(path[0])
        _strike(s)
    ref = js.render_doppler(path, blocks_per_dispatch=4)
    got = ts.render_doppler(path, blocks_per_dispatch=4)
    assert got.shape == ref.shape == (10 * S, 2)
    assert np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100
    assert ts.sample_clock == 10 * S and ts._xfade_from is None
    np.testing.assert_array_equal(ts._last_listener, js._last_listener)


def test_render_doppler_centers_and_events_match_jax(ffat_pair, dberr):
    """object_centers move the delay frame only; state events land at
    their block, one past the end still runs."""
    js, ts = ffat_pair()
    centers = np.asarray([[0.5, 0.0, 0.0], [-0.4, 0.2, 0.0],
                          [0.0, 0.0, 0.6]])

    def events():
        return [(3, lambda s: s.hit(1, np.ones(N), kind="point")),
                (6, lambda s: s.clear_forces(0)),
                (12, lambda s: s.hit(2, np.ones(N)))]
    for s in (js, ts):
        s.set_listener(_path(1)[0])
        _strike(s)
    ref = js.render_doppler(_path(10), object_centers=centers,
                            state_events=events())
    got = ts.render_doppler(_path(10), object_centers=centers,
                            state_events=events())
    assert dberr(got, ref) <= -100
    assert (ts._expiry == js._expiry).all()
    with pytest.raises(ValueError, match="object_centers"):
        ts.render_doppler(_path(2), object_centers=np.zeros((2, 3)))


def test_render_doppler_chunking_invariant(ffat_pair):
    outs = []
    for bpd in (4, 12):
        _, ts = ffat_pair()
        ts.set_listener(_path(1)[0])
        _strike(ts)
        outs.append(ts.render_doppler(_path(12), blocks_per_dispatch=bpd))
    assert np.abs(outs[0]).max() > 0
    np.testing.assert_array_equal(outs[0], outs[1])


def _collect(engine, n_blocks, seconds=120.0):
    """Start, wait for n_blocks of produced audio, stop."""
    import time
    produced = []
    inner = engine._synth_once

    def tapped():
        blocks = inner()
        produced.extend(np.array(b) for b in blocks)
        return blocks
    engine._synth_once = tapped
    engine.start()
    deadline = time.time() + seconds
    while len(produced) < n_blocks and time.time() < deadline:
        time.sleep(0.01)
    engine.stop()
    assert engine.error is None
    return np.concatenate(produced[:n_blocks])


@pytest.mark.parametrize("lookahead", [1, 4])
def test_engine_streams_through_the_post_mix_as_jax(ffat_pair, lookahead,
                                                    dberr):
    """Both engines over span sessions, a listener and hits applied before
    block 0, the delay line fed by the engine's listener hook: the first
    blocks agree to <= -100 dB."""
    js, ts = ffat_pair(lam=True)
    positions = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.5, 0.0],
                            [-1.0, 0.0, 0.5]])
    streams = []
    for eng in (JEngine(js, JCollector(), lookahead=lookahead,
                        post_mix=jd.DopplerPostMix(positions)),
                StreamingEngine(ts, RawCollectorSink(), lookahead=lookahead,
                                post_mix=td.DopplerPostMix(
                                    positions, device="cpu"))):
        eng.set_listener(np.asarray([2.0, 0.4, 0.3]))
        eng.hit(0, np.linspace(0.3, 1.0, N), kind="gaussian", width_us=400.0)
        eng.hit(2, np.ones(N))
        streams.append(_collect(eng, 12))
    ref, got = streams
    assert got.shape == (12 * S, 2) and np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100


def test_export_timeline_live_doppler_matches_jax(ffat_pair):
    """A recording engine with a live Doppler post-mix exports the delay
    keyframes (old position held to the applied block, the new one a block
    later) and the object centers, as the JAX engine does."""
    js, ts = ffat_pair()
    centers = np.asarray([[0.3, 0.0, 0.0], [0.0, 0.0, 0.0],
                          [0.0, -0.2, 0.0]])
    for s in (js, ts):
        s.set_listener(np.asarray([1.0, 0.0, 0.5]))
    jeng = JEngine(js, JCollector(), record=True,
                   post_mix=jd.DopplerPostMix(centers))
    teng = StreamingEngine(ts, RawCollectorSink(), record=True,
                           post_mix=td.DopplerPostMix(centers, device="cpu"))
    for eng, ev in ((jeng, JTransfer), (teng, TransferEvent)):
        eng.recorded = [(4 * S, ev(np.asarray([2.0, 0.0, 0.0]))),
                        (9 * S, ev(np.asarray([0.5, 1.0, 0.0]))),
                        (11 * S, ev(np.zeros((O, 3))))]
        eng._blocks_done = 16
    got, ref = teng.export_timeline(), jeng.export_timeline()
    assert got == ref
    assert got["doppler"] is True and got["objects"] == centers.tolist()
    assert got["skipped_events"] == 1
