"""ModalSession.batched_writes: the event methods' device writes staged on
the host and applied as one index write a state leaf. Every case holds a
batched group against the same calls made one by one on a twin session:
each state leaf bitwise, each host mirror equal, and the audio after it
bitwise. The live path (StreamingEngine._apply_events) opens no batch and
writes at once.
"""
import contextlib

import numpy as np
import pytest
import torch

from openpbso_tpu_torch.ops.coeffs import bank_from_material, lambda_from_modes
from openpbso_tpu_torch.runtime.audio import RawCollectorSink
from openpbso_tpu_torch.runtime.engine import StreamingEngine
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.runtime.state import state_leaves
from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data

S = 128
MODES = 12
# the leaves a hit writes
HIT_LEAVES = 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _session(num_slots=4, objects=3):
    md = synth_mode_data(MODES, 8, seed=3)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              num_objects=objects, block_size=S,
                              device="cpu")
    lam64 = lambda_from_modes(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta)[0]
    return ModalSession(bank, lam64=lam64, num_slots=num_slots,
                        config=SolverConfig(block_size=S, backend="blocked"))


def _space(k, n=MODES):
    return np.cos(0.7 * k + np.arange(n))


def _bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def assert_same_session(a, b):
    """Every state leaf bitwise (dtype included) and every host mirror."""
    la, lb = state_leaves(a.state), state_leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(_bits(x), _bits(y))
        else:
            assert x == y
    for name in ("_expiry", "_t0", "_sus_active", "_ar_host"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a._clock, a._clock_base) == (b._clock, b._clock_base)
    assert a._ar_g.keys() == b._ar_g.keys()


def _wave(sess, batch):
    """A random wave over point, gaussian and hertz hits: rows shorter
    and longer than the bank's modes, future blocks, slots overwritten."""
    rng = np.random.default_rng(7)
    with batch():
        for k in range(40):
            sess.hit(int(rng.integers(3)),
                     rng.normal(size=int(rng.integers(4, 2 * MODES))),
                     kind=("point", "gaussian", "hertz")[k % 3],
                     width_us=float(rng.uniform(50.0, 900.0)),
                     amp=float(rng.uniform(0.1, 2.0)),
                     when=sess.sample_clock + S * int(rng.integers(0, 20)))


def _overwrite(sess, batch):
    """Two hits on one object at one block with one slot: the second
    takes the first's slot in the same batch."""
    with batch():
        sess.hit(0, _space(1), kind="gaussian", width_us=300.0,
                 when=sess.sample_clock + 3 * S)
        sess.hit(0, -_space(2), amp=0.5, when=sess.sample_clock + 3 * S)
        sess.hit(1, _space(3))


def _drag(sess, batch):
    """Starts, updates, retunes and ends on the same objects at one
    block, with hits and a clear: slot rows and whole-object rows of
    ``slots.ftype`` in turn."""
    with batch():
        sess.hit(0, _space(1), when=sess.sample_clock + 2 * S)
        sess.hit(2, _space(2), kind="hertz", width_us=500.0)
        sess.sustained_start(0, _space(3))
        sess.sustained_start(1, _space(4))
        sess.sustained_update(0, _space(5))
        sess.set_ar_params(0, a=(0.6, 0.2), sigma=0.003, mu=0.1)
        sess.sustained_update(1, _space(6, 5))
        sess.set_ar_params(1, a=(0.5, 0.1), sigma=0.002, mu=0.2)
        sess.sustained_end(0)
        sess.clear_forces(2)
        sess.hit(2, _space(7), kind="gaussian", width_us=200.0)
        sess.sustained_start(0, _space(8))
        sess.set_ar_params(1, sigma=0.004)


def _invalid_when(sess, batch):
    """A hit whose ``when`` is off the block grid, in the middle: the
    earlier writes land and ValueError propagates."""
    with pytest.raises(ValueError, match="block-aligned"):
        with batch():
            sess.hit(0, _space(1))
            sess.sustained_start(1, _space(2))
            sess.hit(2, _space(3), when=sess.sample_clock + S + 1)
            sess.hit(1, _space(4))
    assert sess._staged is None


def _nested(sess, batch):
    """A batch inside a batch acts as one: the inner one applies
    nothing on leaving."""
    with batch():
        sess.hit(0, _space(1))
        writes = sess.event_writes
        with batch():
            sess.hit(0, _space(2), when=sess.sample_clock + S)
            sess.sustained_start(1, _space(3))
        if batch is not contextlib.nullcontext:
            assert sess.event_writes == writes and sess._staged
        sess.hit(1, _space(4))
        sess.sustained_end(1)


CASES = {"wave": (_wave, 4), "overwrite": (_overwrite, 1),
         "drag": (_drag, 4), "invalid when": (_invalid_when, 4),
         "nested": (_nested, 4)}


@pytest.mark.parametrize("case", list(CASES))
def test_a_batch_leaves_the_session_of_the_calls_one_by_one(case):
    fn, slots = CASES[case]
    one, batched = _session(slots), _session(slots)
    for sess in (one, batched):
        sess.hit(1, _space(9))
        sess.render_multi(3, blocks_per_dispatch=3)
    fn(one, contextlib.nullcontext)
    fn(batched, batched.batched_writes)
    assert batched._staged is None
    assert_same_session(one, batched)
    a = one.render_multi(24, blocks_per_dispatch=8)
    b = batched.render_multi(24, blocks_per_dispatch=8)
    assert float(np.abs(a).max()) > 0
    assert np.array_equal(a, b)
    assert_same_session(one, batched)


def test_a_batch_makes_one_write_a_leaf():
    one, batched = _session(), _session()
    _wave(one, contextlib.nullcontext)
    _wave(batched, batched.batched_writes)
    assert one.event_writes == 40 * HIT_LEAVES
    assert batched.event_writes == HIT_LEAVES


def test_a_dispatch_inside_a_batch_raises():
    sess = _session()
    with pytest.raises(RuntimeError, match="batched_writes"):
        with sess.batched_writes():
            sess.hit(0, _space(1))
            sess.render_multi(2)
    # the hit staged before the dispatch was applied
    assert int(sess.state.slots.ftype[0, 0]) != 0


def test_an_unbatched_hit_writes_at_once():
    sess = _session()
    sess.hit(2, _space(1), kind="gaussian", width_us=300.0, amp=0.5)
    assert sess._staged is None and sess.event_writes == HIT_LEAVES
    assert int(sess.state.slots.ftype[2, 0]) != 0
    assert float(sess.state.slots.amp[2, 0]) == 0.5
    row = np.zeros(sess.bank.num_modes)     # the bank pads its modes
    row[:MODES] = _space(1)
    assert torch.equal(sess.state.slots.space[2, 0],
                       torch.as_tensor(row).to(torch.float32))


def test_the_live_engine_applies_its_events_unbatched():
    """StreamingEngine._apply_events writes each event at once: it opens
    no batch, and a hit makes its five writes."""
    sess = _session()
    engine = StreamingEngine(sess, RawCollectorSink())

    def no_batch():
        raise AssertionError("the live path opened a batch")
    sess.batched_writes = no_batch
    engine.hit(0, _space(1), kind="gaussian", width_us=300.0)
    engine.hit(1, _space(2))
    engine.sustained_start(2, _space(3))
    engine.set_ar_params(2, a=(0.6, 0.2), sigma=0.003, mu=0.1)
    engine._apply_events()
    assert sess.event_writes == 2 * HIT_LEAVES + 3 + 4
    ref = _session()
    ref.hit(0, _space(1), kind="gaussian", width_us=300.0)
    ref.hit(1, _space(2))
    ref.sustained_start(2, _space(3))
    ref.set_ar_params(2, a=(0.6, 0.2), sigma=0.003, mu=0.1)
    assert_same_session(sess, ref)
