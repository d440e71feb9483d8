"""The port's checkpoints and model hot-swap
(openpbso_tpu_torch.runtime.checkpoint), and the engine cases of
tests/test_runtime_hardening.py on the port: a snapshot round-trips bitwise,
every refusal of the reference's loader is kept, and the engine's command
queues keep their hardened semantics.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from openpbso_tpu_torch.ops.coeffs import (bank_from_material,
                                           build_modal_bank,
                                           lambda_from_modes)
from openpbso_tpu_torch.runtime.audio import RawCollectorSink
from openpbso_tpu_torch.runtime.checkpoint import (load_session, load_state,
                                                   save_session, save_state,
                                                   swap_model)
from openpbso_tpu_torch.runtime.engine import StreamingEngine
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.runtime.state import state_leaves
from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 128


def _session(num_objects=2, span=False, num_slots=4, dtype=torch.float32):
    md = synth_mode_data(12, 8, seed=3)
    if span:
        lam64, b, valid = lambda_from_modes(
            CERAMIC.density, md.omega_squared, CERAMIC.alpha, CERAMIC.beta)
        o = num_objects
        bank = build_modal_bank(
            np.broadcast_to(lam64, (o,) + lam64.shape),
            np.broadcast_to(b, (o,) + b.shape),
            np.broadcast_to(valid, (o,) + valid.shape),
            block_size=S, shared=False, dtype=dtype, device="cpu")
        return ModalSession(bank, config=SolverConfig(block_size=S,
                                                      backend="blocked"),
                            num_slots=num_slots, dtype=dtype,
                            lam64=np.broadcast_to(lam64,
                                                  (o,) + lam64.shape))
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              num_objects=num_objects, block_size=S,
                              dtype=dtype, device="cpu")
    return ModalSession(bank, config=SolverConfig(block_size=S,
                                                  backend="blocked"),
                        num_slots=num_slots, dtype=dtype)


def _wait(cond, seconds=120.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return bool(cond())


def _play(sess):
    rng = np.random.default_rng(0)
    sess.hit(0, rng.standard_normal(12), kind="gaussian", width_us=900.0)
    sess.hit(1, rng.standard_normal(12), kind="hertz", width_us=2000.0,
             when=3 * S)
    sess.sustained_start(1, rng.standard_normal(12))
    sess.render(2)


def test_state_round_trips_bitwise(tmp_path):
    sess = _session()
    _play(sess)
    path = str(tmp_path / "state.npz")
    save_state(path, sess.state)
    data = np.load(path)
    leaves = state_leaves(sess.state)
    # the state's fields in declaration order, None fields skipped
    assert sorted(data.files) == sorted(f"leaf_{i}"
                                        for i in range(len(leaves)))
    assert len(leaves) == 2 + 5 + 7 + 2 and sess.state.transfer_im is None
    assert int(data[f"leaf_{len(leaves) - 1}"]) == sess.state.block_start
    back = load_state(path, _session().state)
    for a, b in zip(leaves, state_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b and type(b) is int


def test_session_round_trips_and_renders_on_bitwise(tmp_path):
    """Mirrors, clock, drags and hits: the restored session renders the
    next blocks bitwise, per block and by span."""
    for span in (False, True):
        sess = _session(span=span)
        _play(sess)
        path = str(tmp_path / f"snap{span}.npz")
        save_session(path, sess)
        fresh = _session(span=span)
        fresh._xfade_from = (fresh.state.transfer, None)
        load_session(path, fresh)
        assert fresh._xfade_from is None
        assert fresh.sample_clock == sess.sample_clock == 2 * S
        np.testing.assert_array_equal(fresh._expiry, sess._expiry)
        np.testing.assert_array_equal(fresh._t0, sess._t0)
        np.testing.assert_array_equal(fresh._sus_active, [False, True])
        if span:
            out = [s.render_multi(6, 3) for s in (sess, fresh)]
        else:
            out = [s.render(6) for s in (sess, fresh)]
        assert np.abs(out[0]).max() > 0
        np.testing.assert_array_equal(out[0], out[1])
        # a later hit recycles the same slot in both
        assert fresh._alloc_slot(0) == sess._alloc_slot(0)


def test_restore_goes_to_the_templates_dtype_and_device(tmp_path):
    sess = _session()
    _play(sess)
    path = str(tmp_path / "snap.npz")
    save_session(path, sess)
    wide = _session(dtype=torch.float64)
    load_session(path, wide)
    for a, b in zip(state_leaves(sess.state), state_leaves(wide.state)):
        if isinstance(a, torch.Tensor):
            assert b.device == a.device
            if a.dtype == torch.float32:
                assert b.dtype == torch.float64
                assert torch.equal(a.double(), b)
            else:
                assert b.dtype == a.dtype and torch.equal(a, b)


def test_load_session_restores_ar_host_mirror(tmp_path):
    space = np.linspace(0.3, 1.0, 12)
    sess = _session(span=True)
    sess.set_ar_params(0, a=(0.9, 0.05), sigma=0.002, mu=0.1)
    path = str(tmp_path / "snap.npz")
    save_session(path, sess)
    fresh = _session(span=True)
    fresh.ar_span_table(4)                  # a stale cached table
    load_session(path, fresh)
    np.testing.assert_array_equal(fresh._ar_host[0], [0.9, 0.05])
    assert fresh._ar_g == {}   # stale length-keyed tables dropped
    # the retuned drag renders identically through the span path (whose
    # impulse tables come from the host mirror, not the device state)
    for s in (sess, fresh):
        s.sustained_start(0, space)
    a_out = sess.render_multi(4, 4)
    b_out = fresh.render_multi(4, 4)
    assert np.abs(a_out).max() > 0
    np.testing.assert_array_equal(a_out, b_out)


def test_snapshot_without_the_ar_key_falls_back_to_the_device_copy(tmp_path):
    sess = _session()
    sess.set_ar_params(1, a=(0.7, 0.1))
    path = str(tmp_path / "snap.npz")
    save_session(path, sess)
    data = dict(np.load(path))
    for key in ("_session_ar_host", "_session_clock",
                "_session_clock_base"):
        del data[key]
    np.savez_compressed(path, **data)
    fresh = _session()
    load_session(path, fresh)
    np.testing.assert_allclose(fresh._ar_host[1], [0.7, 0.1], rtol=1e-6)
    assert fresh._clock == fresh.state.block_start and fresh._clock_base == 0


def test_load_state_refuses_a_session_snapshot(tmp_path):
    sess = _session()
    path = str(tmp_path / "snap.npz")
    save_session(path, sess)
    with pytest.raises(ValueError, match="load_session"):
        load_state(path, sess.state)


def test_load_state_structure_mismatch_is_an_error(tmp_path):
    """A snapshot with an imaginary transfer row holds one leaf more; it
    and a real-row template refuse each other instead of dropping the
    phase."""
    rng = np.random.default_rng(0)
    sess = _session()
    o, m = sess.bank.num_objects, sess.bank.num_modes
    complex_state = dataclasses.replace(
        sess.state, transfer_im=torch.as_tensor(
            rng.uniform(0, 1, (o, m))).float())
    p_complex = str(tmp_path / "complex.npz")
    save_state(p_complex, complex_state)
    fresh = _session()
    with pytest.raises(ValueError, match="STRUCTURES"):
        load_state(p_complex, fresh.state)
    p_real = str(tmp_path / "real.npz")
    save_state(p_real, fresh.state)
    with pytest.raises(ValueError, match="STRUCTURES"):
        load_state(p_real, complex_state)
    back = load_state(p_complex, complex_state)
    assert torch.equal(back.transfer_im, complex_state.transfer_im)


def test_shape_mismatches_are_errors(tmp_path):
    sess = _session(num_objects=2)
    p_state = str(tmp_path / "state.npz")
    save_state(p_state, sess.state)
    with pytest.raises(ValueError, match="shape"):
        load_state(p_state, _session(num_objects=3).state)
    p_sess = str(tmp_path / "sess.npz")
    save_session(p_sess, sess)
    before = _session(num_slots=6)
    leaves = [v.clone() if isinstance(v, torch.Tensor) else v
              for v in state_leaves(before.state)]
    with pytest.raises(ValueError, match="slot"):
        load_session(p_sess, before)            # a 4-slot snapshot
    # a refused load leaves the session as it was
    for a, b in zip(leaves, state_leaves(before.state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_swap_model_drains_stale_command_events():
    big = _session(num_objects=8)
    engine = StreamingEngine(big, RawCollectorSink())
    assert engine.hit(5, np.ones(12))               # valid for 8 objects
    engine.set_ar_params(7, a=(0.9, 0.05))
    engine.set_listener(np.array([1.0, 0.0, 0.0]))
    engine._sound.put(np.zeros((S, 2), np.float32))
    engine._last_block = np.ones((S, 2), np.float32)
    small = _session(num_objects=2)
    old_profiler = engine.profiler
    swap_model(engine, small)
    assert engine.session is small
    assert engine._events.empty()                   # hit(5) would raise
    assert engine._arprm.take() == []
    assert engine._transfer.take() is None
    assert engine._sound.empty() and engine._last_block is None
    assert engine.profiler is not old_profiler


def test_swap_model_restarts_a_running_engine():
    engine = StreamingEngine(_session(num_objects=4), RawCollectorSink())
    engine.start()
    try:
        assert _wait(lambda: engine._blocks_done >= 3)
        old = engine._synth_thread
        small = _session(num_objects=2)
        swap_model(engine, small)
        assert not old.is_alive() and engine._synth_thread.is_alive()
        assert engine.healthy and engine.session is small
        engine.hit(1, np.ones(12))
        n = engine._blocks_done
        assert _wait(lambda: engine._blocks_done >= n + 3)
    finally:
        engine.stop()
    assert engine.error is None


def test_ar_retunes_are_latest_wins_per_object():
    engine = StreamingEngine(_session(), RawCollectorSink())
    engine.set_ar_params(0, a=(0.9, 0.05))
    engine.set_ar_params(1, a=(0.5, 0.2))           # must not drop obj 0
    engine._apply_events()
    a = engine.session.state.sustained.a.numpy()
    np.testing.assert_allclose(a[0], [0.9, 0.05], rtol=1e-6)
    np.testing.assert_allclose(a[1], [0.5, 0.2], rtol=1e-6)
    # the newest retune of one object still wins
    engine.set_ar_params(0, a=(0.8, 0.1))
    engine.set_ar_params(0, a=(0.7, 0.2))
    assert len(engine._arprm.take()) == 1


def test_restart_after_failure_leaves_one_consumer():
    engine = StreamingEngine(_session(), RawCollectorSink())
    engine.start()
    try:
        engine._stop.set()     # the failure path's stop flag
        assert _wait(lambda: not engine._synth_thread.is_alive())
        # the consume thread may still sit in its 0.2 s poll: start() must
        # join the old threads before it clears the flag
        old_consumer = engine._consume_thread
        engine.start()
        assert not old_consumer.is_alive()
        assert engine._consume_thread.is_alive()
        assert engine._consume_thread is not old_consumer
        assert engine.healthy
    finally:
        engine.stop()


def test_sustained_events_drop_on_full():
    engine = StreamingEngine(_session(), RawCollectorSink())
    space = np.ones(12)
    while engine.hit(0, space):
        pass                                        # fill the queue
    assert engine.sustained_start(0, space) is False
    assert engine.sustained_update(0, space) is False
    assert engine.sustained_end(0) is False
    assert engine.clear_forces() is False           # none may block


def test_engine_control_runs_on_synth_thread(tmp_path):
    engine = StreamingEngine(_session(), RawCollectorSink())
    # not running: inline fallback
    seen = []
    assert engine.control(seen.append) is True
    assert seen == [engine.session]
    engine.start()
    try:
        names = []
        assert engine.control(
            lambda sess: names.append(threading.current_thread().name))
        assert names == ["pbso-synth"]

        def boom(sess):
            raise ValueError("boom")

        with pytest.raises(ValueError, match="boom"):
            engine.control(boom)
        assert engine.healthy                       # the stream survived
        # a snapshot taken between two blocks of a live stream
        path = str(tmp_path / "live.npz")
        engine.hit(0, np.ones(12), kind="gaussian", width_us=900.0)
        assert _wait(lambda: (engine.session._expiry > 0).any())
        assert engine.control(lambda sess: save_session(path, sess))
    finally:
        engine.stop()
    fresh = _session()
    load_session(path, fresh)
    assert fresh.sample_clock > 0 and fresh.sample_clock % S == 0
    assert (fresh._expiry > 0).any()
