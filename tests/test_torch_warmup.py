"""ModalSession.warmup of the port: it runs every variant the live loop can
take and leaves no trace. The port writes force slots and the sustained
channel in place, so warmup must work on clones; a session rendered after
warmup equals, bitwise, one rendered without.
"""
import dataclasses

import numpy as np
import pytest
import torch

from openpbso_tpu_torch.ops.coeffs import (bank_from_material,
                                           lambda_from_modes)
from openpbso_tpu_torch.ops.ffat import build_ffat
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.runtime.state import state_leaves
from openpbso_tpu_torch.utils.synth import (CERAMIC, synth_fatcube,
                                            synth_mode_data)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


O, N, S = 3, 12, 64


def _session(ffat=True, lam=True, backend="blocked", **cfg):
    md = synth_mode_data(N, 8, seed=3)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, num_objects=O,
                              block_size=S, device="cpu")
    maps = None
    if ffat:
        freqs = md.frequencies_hz(CERAMIC.density)
        maps = build_ffat({i: synth_fatcube(i, float(freqs[i]), n=6, seed=3)
                           for i in range(N)}, bank.num_modes, device="cpu")
    lam64 = (lambda_from_modes(CERAMIC.density, md.omega_squared,
                               CERAMIC.alpha, CERAMIC.beta)[0]
             if lam else None)
    return ModalSession(bank, maps, SolverConfig(
        block_size=S, backend=backend, **cfg), num_slots=4, lam64=lam64)


def _busy(sess):
    """A state with everything warmup could disturb: live and scheduled
    hits in several slots, a drag, a retuned AR model, a pending move."""
    rng = np.random.default_rng(0)
    sess.set_listener(np.array([0.6, 0.4, 0.3]))
    sess.hit(0, rng.standard_normal(N), kind="gaussian", width_us=900.0)
    sess.hit(0, rng.standard_normal(N), kind="point")
    sess.hit(1, rng.standard_normal(N), kind="hertz", width_us=3000.0,
             when=4 * S)
    sess.sustained_start(2, rng.standard_normal(N))
    sess.set_ar_params(2, a=(0.6, 0.2), sigma=0.01, mu=0.2)
    sess.render(2)
    sess.set_listener(np.array([0.1, 0.8, 0.5]))   # pending when smooth


def _snapshot(sess):
    leaves = [v.clone() if isinstance(v, torch.Tensor) else v
              for v in state_leaves(sess.state)]
    mirrors = dict(clock=sess._clock, base=sess._clock_base,
                   expiry=sess._expiry.copy(), t0=sess._t0.copy(),
                   sus=sess._sus_active.copy(), ar=sess._ar_host.copy(),
                   listener=np.array(sess._last_listener),
                   config=sess.config, xfade=sess._xfade_from)
    return leaves, mirrors


def _assert_same(a, b):
    for x, y in zip(a[0], b[0]):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
    for k, v in a[1].items():
        w = b[1][k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, w)
        else:
            assert v is w or v == w, k


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("backend", ["blocked", "fused"])
def test_warmup_leaves_no_trace(smooth, backend):
    """State, clock, mirrors, pending move, config and listener are as
    before, and the audio that follows is bitwise the unwarmed session's."""
    warmed = _session(backend=backend, smooth_transfer=smooth)
    plain = _session(backend=backend, smooth_transfer=smooth)
    for sess in (warmed, plain):
        _busy(sess)
    before = _snapshot(warmed)
    assert (before[1]["xfade"] is not None) == smooth
    warmed.warmup(qnorm=True, span_blocks=(1, 4))
    _assert_same(before, _snapshot(warmed))
    assert warmed.sample_clock == plain.sample_clock == 2 * S
    np.testing.assert_array_equal(warmed.render(8), plain.render(8))
    np.testing.assert_array_equal(warmed.render_multi(8, 4),
                                  plain.render_multi(8, 4))


def test_warmup_on_a_fresh_session_changes_no_audio():
    warmed, plain = _session(), _session()
    warmed.warmup(span_blocks=(2,))
    for sess in (warmed, plain):
        _busy(sess)
    np.testing.assert_array_equal(warmed.render(6), plain.render(6))


def test_warmup_state_is_not_an_alias():
    """The in-place slot and channel writes warmup makes land in a clone:
    the session holds the very tensors it held before, untouched."""
    sess = _session()
    _busy(sess)
    old = sess.state
    kept = [v.clone() for v in state_leaves(old)
            if isinstance(v, torch.Tensor)]
    seen = []
    inner = sess.hit
    sess.hit = lambda *a, **kw: (seen.append(sess.state), inner(*a, **kw))
    sess.warmup()
    assert seen[0] is not old and seen[0].slots.space is not old.slots.space
    assert sess.state is old
    for a, b in zip(kept, (v for v in state_leaves(old)
                           if isinstance(v, torch.Tensor))):
        assert torch.equal(a, b)


def _count(sess):
    calls = []
    for name in ("_step_full", "_step_xfade", "_step_decay", "_step_span",
                 "_step_span_sound", "hit", "clear_forces",
                 "set_listener_relative"):
        inner = getattr(sess, name)

        def counted(*a, _inner=inner, _name=name, **kw):
            calls.append((_name, a[1:] if _name == "_step_xfade" else a,
                          tuple(sorted(kw.items()))))
            return _inner(*a, **kw)
        setattr(sess, name, counted)
    return calls


def _names(calls):
    out = {}
    for name, _, _ in calls:
        out[name] = out.get(name, 0) + 1
    return out


def test_warmup_dispatches_every_variant():
    """slot_buckets (1, 2) of a 4-slot table: 3 bucket variants plus the
    sustained one, each with its xfade twin, times the qnorm pass; the
    decay step per pass; and the span matrix per length."""
    sess = _session(smooth_transfer=True, slot_buckets=(1, 2))
    calls = _count(sess)
    sess.warmup(qnorm=True, span_blocks=(1, 4))
    n = _names(calls)
    assert n["_step_full"] == n["_step_xfade"] == 2 * 4
    assert n["_step_decay"] == 2
    # per span length: 3 buckets, 4 sustained (0 + 3), 1 per-object, 1 idle
    assert n["_step_span"] == 2 * 9 and "_step_span_sound" not in n
    assert n["hit"] == n["clear_forces"] == n["set_listener_relative"] == 1
    full = {kw for name, _, kw in calls if name == "_step_full"}
    assert full == {(("num_slots", b), ("with_sustained", ws))
                    for ws, b in [(False, 1), (False, 2), (False, None),
                                  (True, None)]}
    spans = [dict(kw) for name, _, kw in calls if name == "_step_span"]
    assert sum(s.get("ar_per_object", False) for s in spans) == 2
    assert sum(s.get("idle") is True for s in spans) == 2
    assert {s["num_slots"] for s in spans if s.get("with_sustained")} == {
        0, 1, 2, None}


def test_warmup_gates_variants_to_the_session():
    # no FFAT: the transfer never changes, so no xfade and no lookup;
    # no lam64: no span; sustained=False: no sustained variant
    sess = _session(ffat=False, lam=False, smooth_transfer=True)
    calls = _count(sess)
    sess.warmup(sustained=False, span_blocks=(4,))
    n = _names(calls)
    assert n == {"hit": 1, "clear_forces": 1, "_step_full": 2,
                 "_step_decay": 1}
    # a table-less bank steps by scan and has no decay step
    md = synth_mode_data(N, 8, seed=3)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, device="cpu")
    scan = ModalSession(bank, config=SolverConfig(block_size=S))
    calls = _count(scan)
    scan.warmup()
    assert "_step_decay" not in _names(calls)


class _PostMix:
    def __init__(self, span):
        self.calls, self.span_calls, self.resets = 0, 0, 0
        if span:
            self.process_span = self._process_span

    def __call__(self, sound, mix):
        self.calls += 1
        return mix

    def _process_span(self, sound):
        self.span_calls += 1
        return sound.sum(dim=0)[:, None]

    def reset(self):
        self.resets += 1


@pytest.mark.parametrize("span", [False, True])
def test_warmup_runs_and_resets_the_post_mix(span):
    sess = _session()
    calls = _count(sess)
    pm = _PostMix(span)
    sess.warmup(post_mix=pm, span_blocks=(2,))
    assert pm.calls == 1 and pm.resets == 1
    n = _names(calls)
    if span:    # the engine's pair: the sound span and process_span
        assert pm.span_calls == n["_step_span_sound"] == 7
        assert "_step_span" not in n
    else:
        assert pm.span_calls == 0 and n["_step_span"] == 7


def test_warmup_restores_after_a_failure():
    sess = _session()
    _busy(sess)
    before = _snapshot(sess)

    def boom(*a, **kw):
        raise RuntimeError("injected")
    sess._step_decay = boom
    with pytest.raises(RuntimeError, match="injected"):
        sess.warmup(qnorm=True)
    _assert_same(before, _snapshot(sess))


def test_ar_span_table_force_per_object():
    sess = _session()
    shared = sess.ar_span_table(4)
    per_obj = sess.ar_span_table(4, force_per_object=True)
    assert shared.shape[0] == 1 and per_obj.shape[0] == O
    for row in per_obj:
        assert torch.equal(row, shared[0])
    assert sess.ar_span_table(4) is shared      # both stay cached


def test_step_overrides_match_the_host_gating():
    """_step_full's and _step_span's explicit flags give what the host
    gating would have chosen."""
    a, b = _session(), _session()
    for sess in (a, b):
        sess.hit(0, np.ones(N), kind="gaussian", width_us=500.0)
    assert a._slot_bucket() == 1 and not a._with_sustained()
    x = a._step_full()[1]
    y = b._step_full(with_sustained=False, num_slots=1)[1]
    assert torch.equal(x, y)
    x = a._step_span(3)
    y = b._step_span(3, num_slots=1, idle=False, with_sustained=False)
    assert torch.equal(x, y)
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
