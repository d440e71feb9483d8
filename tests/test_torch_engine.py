"""The port's StreamingEngine (openpbso_tpu_torch.runtime.engine): the
counterparts of tests/test_engine.py on CPU sessions, and one script through
the JAX engine and the port's, <= -100 dB over the first blocks.

Nothing here asserts a wall-clock rate: the streams are collected, waited on
by block count with generous timeouts, and compared by content.
"""
import queue
import threading
import time
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops.coeffs import bank_from_material as j_bank_from_material
from openpbso_tpu.ops.coeffs import lambda_from_modes
from openpbso_tpu.runtime.audio import RawCollectorSink as JCollector
from openpbso_tpu.runtime.engine import StreamingEngine as JEngine
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy
from openpbso_tpu_torch.ops.coeffs import bank_from_material
from openpbso_tpu_torch.ops.ffat import build_ffat
from openpbso_tpu_torch.runtime.audio import (RawCollectorSink,
                                              RealTimePacerSink, WavFileSink)
from openpbso_tpu_torch.runtime.engine import (BufferHealth, LatestWins,
                                               StreamingEngine)
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _session(o=1, s=256, n_modes=16, lam=False, **cfg):
    md = synth_mode_data(n_modes, 8)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                              block_size=s, device="cpu")
    lam64 = (lambda_from_modes(CERAMIC.density, md.omega_squared,
                               CERAMIC.alpha, CERAMIC.beta)[0]
             if lam else None)
    return ModalSession(bank, config=SolverConfig(
        block_size=s, backend="blocked", **cfg), lam64=lam64), md


def _engine(sink, o=1, s=256, n_modes=16, **kw):
    sess, md = _session(o, s, n_modes)
    return StreamingEngine(sess, sink, **kw), md


def _wait(cond, seconds=120.0):
    """Poll ``cond`` until it holds; a generous bound keeps a real hang
    loud without tying the test to the host's speed."""
    deadline = time.time() + seconds
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return bool(cond())


def _tap(engine):
    """Record what each synthesis dispatch produced (the consumer pads its
    sink with stale blocks whenever the host stalls; the tap does not)."""
    produced = []
    inner = engine._synth_once

    def tapped():
        blocks = inner()
        produced.extend(np.array(b) for b in blocks)
        return blocks

    engine._synth_once = tapped
    return produced


def test_latest_wins_slot():
    slot = LatestWins()
    assert slot.take() is None
    slot.put(1)
    slot.put(2)
    assert slot.take() == 2
    assert slot.take() is None


def test_buffer_health_ring():
    h = BufferHealth(size=4)
    assert h.health == 1.0
    h.record(False)
    h.record(False)
    assert h.health == 0.5 and h.missed == 2
    for _ in range(4):
        h.record(True)
    assert h.health == 1.0 and h.missed == 2 and h.total == 6


def test_engine_produces_audio_from_hit():
    sink = RawCollectorSink()
    engine, md = _engine(sink)
    produced = _tap(engine)
    engine.hit(0, np.ones(md.num_modes))
    engine.start()
    assert _wait(lambda: len(produced) >= 8)
    engine.stop()
    assert engine.error is None
    audio = sink.concatenated()
    assert audio.shape[0] > 0 and audio.dtype == np.float32
    assert np.abs(audio).max() > 0
    assert np.isfinite(audio).all()


def test_engine_event_types():
    sink = RawCollectorSink()
    engine, md = _engine(sink)
    produced = _tap(engine)
    engine.start()
    engine.sustained_start(0, np.ones(md.num_modes))
    engine.set_ar_params(0, a=(0.5, 0.2), sigma=0.01, mu=0.3)
    assert _wait(lambda: engine.session._sus_active[0])
    n = len(produced)
    assert _wait(lambda: len(produced) >= n + 6)
    engine.sustained_end(0)
    engine.set_listener(np.asarray([1.0, 0.0, 0.0]))  # no ffat -> no-op
    engine.clear_forces()
    assert _wait(lambda: not engine.session._sus_active[0])
    engine.stop()
    assert engine.error is None
    assert np.abs(np.concatenate(produced)).max() > 0  # the drag sounded
    np.testing.assert_allclose(
        engine.session.state.sustained.a[0].numpy(), [0.5, 0.2], rtol=1e-6)


def test_engine_pacing_against_realtime_sink():
    """A real-time paced consumer holds the producer back through the
    bounded sound queue: the producer never runs more than the queue's
    depth (plus the block in each hand) ahead of the sink."""
    sink = RealTimePacerSink()
    engine, md = _engine(sink, s=512)
    engine.hit(0, np.ones(md.num_modes), kind="gaussian", width_us=2000.0)
    engine.start()
    assert _wait(lambda: sink.total_blocks >= 20)
    ahead = engine._blocks_done - sink.total_blocks
    engine.stop()
    assert engine.error is None
    assert 0 <= ahead <= 2 + 2
    assert engine.health.total >= 20


def test_wav_sink_roundtrip(tmp_path):
    path = str(tmp_path / "t.wav")
    sink = WavFileSink(path)
    sink.write(np.full((64, 2), 0.5, np.float32))
    sink.close()
    with wave.open(path) as w:
        assert w.getnchannels() == 2
        assert w.getnframes() == 64
        frames = np.frombuffer(w.readframes(64), "<i2")
        assert abs(int(frames[0]) - int(0.5 * 32767)) <= 1


def test_underrun_stale_replay():
    """When synthesis cannot keep up, the consumer replays the last block
    and marks the health ring (real_time_modal_sound.cpp:203-210)."""
    sink = RawCollectorSink()
    engine, md = _engine(sink, s=128)
    # no synth thread: hand-feed one block, then starve the consumer
    block = np.full((128, 2), 0.25, np.float32)
    engine._sound.put(block)
    t = threading.Thread(target=engine._consume_loop, daemon=True)
    engine._stop.clear()
    t.start()
    assert _wait(lambda: len(sink.blocks) >= 2)
    engine._stop.set()
    t.join(30.0)
    np.testing.assert_array_equal(sink.blocks[0], block)
    np.testing.assert_array_equal(sink.blocks[1], block)  # stale replay
    assert engine.health.health < 1.0 and engine.health.missed >= 1


def test_synth_failure_is_observable():
    """A dying synthesis thread surfaces through .error and .healthy
    instead of a silent stream of stale blocks."""
    engine, md = _engine(RawCollectorSink())
    engine._synth_once = lambda: (_ for _ in ()).throw(
        RuntimeError("injected device failure"))
    engine.start()
    assert _wait(lambda: not engine.healthy)
    assert isinstance(engine.error, RuntimeError)
    engine.stop()
    with pytest.raises(RuntimeError, match="synthesis pipeline failed"):
        engine.run_for(5.0)


def _ffat_session(**cfg):
    md = synth_mode_data(12, 8, seed=3)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, block_size=128,
                              device="cpu")
    freqs = md.frequencies_hz(CERAMIC.density)
    maps = {i: synth_fatcube(i, float(freqs[i]), n=8, seed=3)
            for i in range(12)}
    ffat = build_ffat(maps, bank.num_modes, device="cpu")
    return ModalSession(bank, ffat=ffat, config=SolverConfig(
        block_size=128, backend="blocked", **cfg))


def test_stream_exercises_all_step_variants():
    """One live stream through the full, decay, xfade and qnorm steps."""
    sess = _ffat_session(smooth_transfer=True)
    sess.set_listener(np.asarray([0.6, 0.4, 0.3]))
    calls = {"full": 0, "decay": 0, "xfade": 0}
    for name in calls:
        inner = getattr(sess, f"_step_{name}")

        def counted(*a, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)
        setattr(sess, f"_step_{name}", counted)
    sink = RawCollectorSink()
    eng = StreamingEngine(sess, sink, qnorm_every=4)
    produced = _tap(eng)
    # the warmup's counts as it returns: the synthesis thread may step
    # before start() itself returns
    warmup, warmed = sess.warmup, []
    sess.warmup = lambda **kw: (warmup(**kw), warmed.append(dict(calls)))[0]
    eng.start()
    warm, = warmed
    try:
        eng.hit(0, np.ones(12), kind="point")              # full step
        assert _wait(lambda: calls["decay"] > warm["decay"] + 4)
        eng.set_listener(np.asarray([0.1, 0.8, 0.5]))      # xfade step
        assert _wait(lambda: calls["xfade"] > warm["xfade"])
        n = len(produced)
        assert _wait(lambda: len(produced) >= n + 8)
        q = eng.latest_qnorm()                             # qnorm steps
    finally:
        eng.stop()
    assert eng.error is None
    assert calls["full"] > warm["full"]
    audio = np.concatenate(produced)
    assert np.abs(audio).max() > 0 and np.isfinite(audio).all()
    assert q is not None and q.shape == (1, sess.bank.num_modes)
    assert np.isfinite(q).all()
    assert sess.config.compute_qnorm is False   # toggled back each time


def test_lookahead1_span_live_path(dberr):
    """A session with lam64 streams at lookahead=1 through single-block
    span dispatches: the audio matches the per-block step's, events still
    apply, and the span cache shows the path was taken."""
    s = 256
    sess, md = _session(s=s, lam=True)
    engine = StreamingEngine(sess, RawCollectorSink(), lookahead=1)
    produced = _tap(engine)
    spans = []
    inner = sess._step_span
    sess._step_span = lambda n, **kw: (spans.append(n), inner(n, **kw))[1]
    # start() warms up before it spawns the synthesis thread: count the
    # warmup's spans as it returns, since the thread may dispatch before
    # start() itself returns
    warmup, warmed = sess.warmup, []
    sess.warmup = lambda **kw: (warmup(**kw), warmed.append(len(spans)))[0]
    engine.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
    engine.start()
    warm, = warmed
    assert _wait(lambda: len(produced) >= 20)
    engine.stop()
    assert engine.error is None
    assert len(spans) - warm >= 20 and set(spans) == {1}
    assert sess._span_cache      # the single-block chunk table was built
    plain, _ = _session(s=s)
    plain.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
    assert dberr(np.concatenate(produced[:20]), plain.render(20)) <= -90
    # a drag rides the span too
    sess2, _ = _session(s=s, lam=True)
    engine2 = StreamingEngine(sess2, RawCollectorSink(), lookahead=1)
    produced2 = _tap(engine2)
    engine2.sustained_start(0, np.ones(16))
    engine2.start()
    assert _wait(lambda: len(produced2) >= 10)
    engine2.sustained_end(0)
    engine2.stop()
    assert engine2.error is None
    assert np.abs(np.concatenate(produced2)).max() > 0


def _qnorm_stream(lookahead, o):
    sess, _ = _session(o=o, s=128, lam=True)
    sink = RawCollectorSink()
    engine = StreamingEngine(sess, sink, lookahead=lookahead, qnorm_every=8)
    produced = _tap(engine)
    engine.hit(0, np.ones(16))
    engine.start()
    got = []

    def poll():
        q = engine.latest_qnorm()
        if q is not None:
            got.append(q)
        return len(got) >= 3
    ok = _wait(poll)
    engine.stop()
    assert engine.error is None
    return ok, got, produced, sess


def test_qnorm_cadence_with_even_lookahead():
    """A modulo-based qnorm schedule starves with lookahead > 1 (blocks
    advance by the lookahead, off the modulo grid forever); the threshold
    schedule keeps telemetry flowing."""
    ok, got, _, _ = _qnorm_stream(lookahead=4, o=1)
    assert ok, f"qnorm telemetry starved: {len(got)} values"


def test_qnorm_flows_alongside_span_lookahead():
    """The span + qnorm branch: telemetry rides a probe of the state
    instead of breaking the span for a per-block qnorm step."""
    ok, got, produced, sess = _qnorm_stream(lookahead=4, o=2)
    assert ok, "qnorm telemetry starved on the span path"
    assert got[0].shape == (2, sess.bank.num_modes)
    assert np.abs(np.concatenate(produced)).max() > 0
    assert sess._span_cache          # the span ran
    assert len(produced) % 4 == 0    # four blocks per dispatch


def test_double_start_refused():
    """Two synth threads racing one session would corrupt its state."""
    engine, _ = _engine(RawCollectorSink())
    engine.start()
    try:
        with pytest.raises(RuntimeError, match="already running"):
            engine.start()
    finally:
        engine.stop()
    engine.start()      # a stopped engine can start again
    engine.stop()


def test_restart_clears_stale_error():
    engine, _ = _engine(RawCollectorSink())
    engine.start()
    engine.error = RuntimeError("injected")
    engine._stop.set()
    engine.stop()
    assert not engine.healthy
    engine.start()
    try:
        assert engine.healthy and engine.error is None
    finally:
        engine.stop()


def test_event_validation_on_producer_thread():
    """A bad event applied on the synthesis thread would kill the stream:
    each is refused where it is enqueued."""
    engine, _ = _engine(RawCollectorSink(), o=2)
    with pytest.raises(IndexError):
        engine.hit(2, np.ones(16))
    with pytest.raises(ValueError, match="kind"):
        engine.hit(0, np.ones(16), kind="scrape")
    with pytest.raises(IndexError):
        engine.sustained_start(7, np.ones(16))
    with pytest.raises(IndexError):
        engine.sustained_end(-1)
    with pytest.raises(IndexError):
        engine.clear_forces(5)
    with pytest.raises(ValueError):
        engine.set_ar_params(0, a=(0.1, 0.2, 0.3))
    with pytest.raises(ValueError, match="unstable"):
        engine.set_ar_params(0, a=(1.2, 0.3))
    with pytest.raises(IndexError):
        engine.set_ar_params(9)
    assert engine._events.empty() and engine._arprm.take() == []


def test_lookahead_without_span_stacks_one_copy(dberr):
    """No lam64: lookahead blocks are stepped back to back and reach the
    host as one stacked copy; the audio is the per-block render's."""
    sess, md = _session(s=128)
    engine = StreamingEngine(sess, RawCollectorSink(), lookahead=3)
    produced = _tap(engine)
    engine.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
    engine.start()
    assert _wait(lambda: len(produced) >= 12)
    engine.stop()
    assert engine.error is None and len(produced) % 3 == 0
    plain, _ = _session(s=128)
    plain.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
    np.testing.assert_array_equal(np.concatenate(produced[:12]),
                                  plain.render(12))


class _PostMix:
    """A plain hook: halves the mix, counts its calls."""

    def __init__(self, span):
        self.calls, self.resets, self.listeners = 0, 0, []
        if span:
            self.process_span = self._process_span

    def __call__(self, sound, mix):
        assert isinstance(sound, torch.Tensor) and isinstance(mix,
                                                              torch.Tensor)
        self.calls += 1
        return 0.5 * mix

    def _process_span(self, sound):
        self.calls += 1
        return 0.5 * sound.sum(dim=0)[:, None].expand(-1, 2) / 1e10

    def on_listener(self, pos):
        self.listeners.append(np.asarray(pos))

    def reset(self):
        self.resets += 1
        self.calls = 0


@pytest.mark.parametrize("span", [False, True])
def test_post_mix_hooks(span):
    """post_mix replaces the mixdown per block; with process_span the
    stream stays on span dispatches; on_listener and reset are honored."""
    sess, _ = _session(s=128, lam=True)
    plain, _ = _session(s=128, lam=True)
    pm = _PostMix(span)
    engine = StreamingEngine(sess, RawCollectorSink(), post_mix=pm)
    produced = _tap(engine)
    spans = []
    inner = sess._step_span_sound
    sess._step_span_sound = lambda n, **kw: (spans.append(n),
                                             inner(n, **kw))[1]
    # count the warmup's spans as it returns: the synthesis thread may
    # dispatch its stream spans before start() itself returns
    warmup, warmed = sess.warmup, []
    sess.warmup = lambda **kw: (warmup(**kw), warmed.append(len(spans)))[0]
    engine.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
    engine.set_listener(np.array([1.0, 2.0, 3.0]))
    engine.start()
    assert pm.resets == 1               # after warmup, before the stream
    warm, = warmed
    assert _wait(lambda: len(produced) >= 6)
    engine.stop()
    assert engine.error is None and pm.calls >= 6
    assert (len(spans) > warm) == span
    np.testing.assert_array_equal(pm.listeners[0], [1.0, 2.0, 3.0])
    plain.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
    want = 0.5 * (plain.render_multi(6, 1) if span else plain.render(6))
    np.testing.assert_allclose(np.concatenate(produced[:6]), want,
                               rtol=1e-5, atol=1e-9)


def test_record_and_export_timeline():
    sess, _ = _session(s=128)
    sess._last_listener = np.array([0.0, 0.0, 1.0])
    engine = StreamingEngine(sess, RawCollectorSink(), record=True)
    engine.hit(0, np.ones(16), kind="gaussian", width_us=300.0, amp=0.5)
    engine.sustained_start(0, np.ones(16))
    engine.set_ar_params(0, a=(0.6, 0.1))
    engine.set_listener(np.array([1.0, 0.0, 0.0]))
    engine.clear_forces()
    engine._apply_events()
    tl = engine.export_timeline()
    assert [e["kind"] for e in tl["events"]] == ["gaussian"]
    assert tl["events"][0]["t"] == 0.0 and tl["events"][0]["amp"] == 0.5
    assert [s["action"] for s in tl["sustained"]] == ["start", "arparam"]
    assert tl["seed"] == 0 and tl["skipped_events"] == 1
    assert tl["listener"][-1]["pos"] == [1.0, 0.0, 0.0]
    assert tl["smooth"] is False
    with pytest.raises(ValueError, match="record=True"):
        _engine(RawCollectorSink())[0].export_timeline()


def test_engine_matches_jax_engine_on_one_script(dberr):
    """Hits enqueued before start() (all apply before block 0) through the
    JAX engine and the port's: the first blocks agree to <= -100 dB."""
    s, o, n_modes, n_blocks = 128, 3, 24, 16
    md = synth_mode_data(n_modes, 8, seed=4)
    jbank = j_bank_from_material(CERAMIC.density, md.omega_squared,
                                 CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                                 block_size=s, dtype=jnp.float32)
    tbank = bank_from_numpy(jax.tree.map(np.asarray, jbank), device="cpu")
    jsess = JSession(jbank, config=JConfig(block_size=s, backend="blocked"))
    tsess = ModalSession(tbank, config=SolverConfig(block_size=s,
                                                    backend="blocked"))
    rng = np.random.default_rng(6)
    hits = [(i % o, rng.standard_normal(n_modes), kind, 250.0 + 50 * i)
            for i, kind in enumerate(["point", "gaussian", "hertz",
                                      "gaussian", "point"])]
    streams = []
    for engine in (JEngine(jsess, JCollector()),
                   StreamingEngine(tsess, RawCollectorSink())):
        produced = _tap(engine)
        for obj, space, kind, width in hits:
            assert engine.hit(obj, space, kind=kind, width_us=width,
                              amp=0.8)
        engine.start()
        assert _wait(lambda: len(produced) >= n_blocks)
        engine.stop()
        assert engine.error is None
        streams.append(np.concatenate(produced[:n_blocks]))
    ref, got = streams
    assert np.abs(ref).max() > 0
    assert dberr(got, ref) <= -100


def test_thread_first_use_runs_on_any_device():
    """The synthesis thread's first-use pass (made for the card's
    per-thread library handles) is plain torch on the given device."""
    from openpbso_tpu_torch.runtime.engine import _thread_first_use
    _thread_first_use(torch.device("cpu"))


def test_full_event_queue_drops():
    engine, _ = _engine(RawCollectorSink(), force_queue_depth=4)
    results = [engine.hit(0, np.ones(16)) for _ in range(6)]
    assert results == [True] * 4 + [False] * 2
    with pytest.raises(queue.Full):
        engine._events.put_nowait(None)
