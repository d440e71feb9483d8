"""The port's span log (openpbso_tpu_torch.runtime.profiling): it records
exactly while a torch.profiler session records, on the profiler's clock,
with parents, trace ids and counters per thread, in a ring that counts
what it overwrote; and the spans the engine, the session and the bake
record on CPU sessions. Nothing here asserts a wall-clock rate."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from openpbso_tpu_torch.apps import render_timeline as ttl
from openpbso_tpu_torch.models import ModalSoundModel, Scene, SceneInstance
from openpbso_tpu_torch.ops.coeffs import bank_from_material, lambda_from_modes
from openpbso_tpu_torch.ops.ffat_fit import compress_map
from openpbso_tpu_torch.runtime import profiling as P
from openpbso_tpu_torch.runtime.audio import RawCollectorSink
from openpbso_tpu_torch.runtime.engine import StreamingEngine
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.utils.synth import (CERAMIC, synth_fatcube,
                                             synth_mode_data)

S = 128
MODES = 12


@pytest.fixture(autouse=True)
def _fresh_log():
    """Each test reads a log of its own; one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    P.reset()
    yield
    P.reset()
    torch.set_num_threads(threads)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _session(objects=2, num_slots=4):
    md = synth_mode_data(MODES, 8, seed=3)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              num_objects=objects, block_size=S,
                              device="cpu")
    lam64 = lambda_from_modes(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta)[0]
    return ModalSession(bank, lam64=lam64, num_slots=num_slots,
                        config=SolverConfig(block_size=S, backend="blocked"))


def _space(k):
    return np.cos(0.7 * k + np.arange(MODES))


def _named(s, name):
    return np.nonzero(s["name"] == P.NAMES.index(name))[0]


def test_nothing_recorded_without_a_profiler():
    assert not P._flag._is_profiler_enabled
    tok = P.begin(P.BAKE, 7)
    assert tok == -1
    P.end(tok, 3)
    assert P.spans()["index"].size == 0 and P.overwritten() == 0


def test_a_site_costs_one_flag_read_without_a_profiler(monkeypatch):
    class Flag:
        reads = 0

        @property
        def _is_profiler_enabled(self):
            Flag.reads += 1
            return False

    monkeypatch.setattr(P, "_flag", Flag())
    P.end(P.begin(P.SPAN), 16, 2)
    assert Flag.reads == 1
    assert P.spans()["index"].size == 0


def test_records_under_the_profiler_also_on_a_later_thread():
    """A thread started after the profiler records too (the C-level query
    torch._C._autograd._profiler_enabled reads False there)."""
    with _profiler():
        assert P._flag._is_profiler_enabled
        main = P.begin(P.BAKE, 1)

        def work():
            P.end(P.begin(P.DISPATCH, 2), 1)

        t = threading.Thread(target=work)
        t.start()
        t.join()
        P.end(main)
    assert not P._flag._is_profiler_enabled
    P.end(P.begin(P.BAKE, 3))          # after the profiler: not kept
    s = P.spans()
    assert sorted(s["trace"].tolist()) == [1, 2]
    assert len(set(s["thread"].tolist())) == 2
    assert (s["parent"] == -1).all()


def test_parents_ids_and_counters_of_nested_spans_on_two_threads():
    go = threading.Barrier(2)

    def work(trace, events):
        outer = P.begin(P.DISPATCH, trace)
        go.wait()                       # both threads hold an open span
        inner = P.begin(P.APPLY)
        leaf = P.begin(P.SPAN)
        go.wait()
        P.end(leaf, 16, trace)
        P.end(inner, events)
        P.end(outer, 2)

    with _profiler():
        threads = [threading.Thread(target=work, args=(trace, 10 + trace))
                   for trace in (100, 200)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    s = P.spans()
    assert s["index"].size == 6
    by_index = {int(i): k for k, i in enumerate(s["index"])}
    for trace in (100, 200):
        mine = np.nonzero(s["trace"] == trace)[0]
        assert mine.size == 3           # children inherit the trace id
        names = {P.NAMES[int(s["name"][k])]: k for k in mine}
        outer, inner, leaf = (names["engine.dispatch"], names["engine.apply"],
                              names["session.span"])
        assert s["parent"][outer] == -1
        assert by_index[int(s["parent"][inner])] == outer
        assert by_index[int(s["parent"][leaf])] == inner
        assert (s["c0"][outer], s["c0"][inner]) == (2, 10 + trace)
        assert (s["c0"][leaf], s["c1"][leaf]) == (16, trace)
        assert s["t0"][outer] <= s["t0"][inner] <= s["t0"][leaf]
        assert s["t1"][leaf] <= s["t1"][inner] <= s["t1"][outer]
        assert len({int(s["thread"][k]) for k in mine}) == 1


def test_the_ring_overwrites_its_oldest_and_counts_them():
    P.reset(capacity=8)
    with _profiler():
        stamps = []
        for k in range(20):
            P.end(P.begin(P.SCHEDULE, k), k)
            stamps.append(time.time_ns())
    assert P.overwritten() == 12
    s = P.spans()
    assert s["trace"].tolist() == list(range(12, 20))
    assert s["c0"].tolist() == list(range(12, 20))
    assert s["index"].tolist() == list(range(12, 20))
    # a window reaching back past what was kept cannot be read; one that
    # starts after the oldest kept span can
    assert P.spans(0, time.time_ns()) is None
    w = P.spans(stamps[14], stamps[-1])
    assert w["trace"].tolist() == list(range(15, 20))


def test_a_span_shares_the_profilers_clock():
    """A profiler event recorded inside a program span lies within the
    span's stamps."""
    with _profiler() as prof:
        tok = P.begin(P.BAKE, 0)
        with record_function("inside_the_span"):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum().item()
        P.end(tok)
    s = P.spans()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inside_the_span"]
    assert events and events[0].device_type() == DeviceType.CPU
    assert s["t0"][0] <= events[0].start_ns()
    assert events[0].end_ns() <= s["t1"][0]


def test_device_trace_writes_the_programs_spans(tmp_path):
    with P.device_trace(str(tmp_path)):
        tok = P.begin(P.BAKE, 4)
        with record_function("inside_the_span"):
            (torch.ones(16, 16) @ torch.ones(16, 16)).sum().item()
        P.end(tok)
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    mine = [e for e in events if e.get("pid") == "program spans"]
    assert [e["name"] for e in mine] == ["bake"]
    assert mine[0]["args"]["trace"] == 4
    inner = next(e for e in events if e.get("name") == "inside_the_span")
    assert mine[0]["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= mine[0]["ts"] + mine[0]["dur"] + 1


def test_engine_dispatch_spans_and_their_children():
    """Each dispatch: one engine.dispatch root with an engine.apply and an
    engine.synth child, the copies under the synth; the dispatches' blocks
    sum to the blocks made, and the applies count the events."""
    sess = _session()
    engine = StreamingEngine(sess, RawCollectorSink())
    with _profiler():
        for k in range(3):
            engine.hit(k % 2, _space(k))
        engine.start()
        deadline = time.time() + 120
        while engine._blocks_done < 8 and time.time() < deadline:
            time.sleep(0.01)
        engine.stop()
    assert engine.error is None and engine._blocks_done >= 8
    s = P.spans()
    pos = {int(i): k for k, i in enumerate(s["index"])}
    roots = _named(s, "engine.dispatch")
    assert s["c0"][roots].sum() == engine._blocks_done
    assert s["trace"][roots].tolist() == list(range(roots.size))
    for name in ("engine.apply", "engine.synth"):
        kids = _named(s, name)
        assert kids.size == roots.size
        assert s["name"][[pos[int(p)] for p in s["parent"][kids]]].tolist() \
            == [P.DISPATCH] * roots.size
        assert (s["trace"][kids] == s["trace"][roots]).all()
    assert s["c0"][_named(s, "engine.apply")].sum() == 3
    synth = _named(s, "engine.synth")
    assert (s["c0"][synth] == s["c0"][roots]).all()
    copies = _named(s, "engine.copy")
    assert copies.size >= roots.size
    in_stream = [pos.get(int(p)) for p in s["parent"][copies]]
    assert sum(k is not None and s["name"][k] == P.SYNTH
               for k in in_stream) >= roots.size
    assert engine.profiler.stats().count == engine._blocks_done
    assert engine.profiler.stats().dispatches == roots.size


def test_bake_schedule_counts_its_hits_and_sustained_actions():
    sess = _session(num_slots=2)
    hits = [{"t": 0.01 + 0.02 * k, "obj": k % 2, "space": _space(k).tolist()}
            for k in range(9)]
    drag = [{"t": 0.05, "obj": 1, "action": "start",
             "space": _space(20).tolist()},
            {"t": 0.05, "obj": 0, "action": "start",
             "space": _space(21).tolist()},
            {"t": 0.12, "obj": 1, "action": "update",
             "space": _space(22).tolist()},
            {"t": 0.2, "obj": 1, "action": "end"}]
    timeline = {"duration_s": 0.3, "events": hits, "sustained": drag,
                "seed": 2}
    with _profiler():
        ttl.bake(sess, timeline, blocks_per_dispatch=8)
        ttl.bake(_session(num_slots=2), timeline, blocks_per_dispatch=8)
    s = P.spans()
    bakes = _named(s, "bake")
    assert bakes.size == 2
    first = s["trace"][bakes[0]]
    assert s["trace"][bakes[1]] == first + 1
    sched = _named(s, "bake.schedule")
    mine = sched[s["trace"][sched] == first]
    assert s["c0"][mine].sum() == len(hits) + len(drag)
    assert (s["parent"][mine] == s["index"][bakes[0]]).all()
    # one span a block that has actions: the two starts share theirs
    blocks = {b for b, _ in ttl._hit_waves(sess, hits, 1000)}
    blocks |= {int(round(d["t"] * 44100 / S)) for d in drag}
    assert len(blocks) < len(hits) + len(drag) and mine.size == len(blocks)
    spans = _named(s, "session.span")
    assert spans.size and set(s["trace"][spans].tolist()) == {first,
                                                              first + 1}
    tables = _named(s, "session.tables")
    assert tables.size and set(s["trace"][tables].tolist()) == {first,
                                                                first + 1}


def test_bake_schedule_counts_one_write_a_leaf_a_group():
    """Each block's actions apply as one batch: ``writes`` is the leaves
    the group touched, however many events it counts."""
    sess = _session(objects=3)
    at = [b * S / 44100 for b in (10, 20, 30)]
    hits = [{"t": 0.0, "obj": k % 3, "space": _space(k).tolist(),
             "kind": ("point", "gaussian", "hertz")[k % 3]}
            for k in range(6)]
    drag = [{"t": at[0], "obj": 0, "action": "start",
             "space": _space(10).tolist()},
            {"t": at[0], "obj": 2, "action": "start",
             "space": _space(11).tolist()},
            {"t": at[1], "obj": 0, "action": "update",
             "space": _space(12).tolist()},
            {"t": at[1], "obj": 0, "action": "arparam", "a": [0.6, 0.2],
             "sigma": 0.003, "mu": 0.1},
            {"t": at[2], "obj": 2, "action": "end"}]
    timeline = {"duration_s": 0.1, "events": hits, "sustained": drag,
                "seed": 2}
    with _profiler():
        ttl.bake(sess, timeline, blocks_per_dispatch=8)
    s = P.spans()
    sched = _named(s, "bake.schedule")
    # the wave's hits write the five slot leaves; two starts space, AR
    # history and activity; an update and a retune space, a, sigma, mu
    # and the history; an end the activity alone
    assert s["c0"][sched].tolist() == [6, 2, 2, 1]
    assert s["c1"][sched].tolist() == [5, 3, 5, 1]
    assert P.COUNTERS[P.SCHEDULE] == ("events", "writes")


def _brute_live(sess, n_blocks):
    start = sess.sample_clock
    end = start + n_blocks * S
    count = 0
    for o in range(sess._expiry.shape[0]):
        for k in range(sess._expiry.shape[1]):
            if sess._t0[o, k] < end and sess._expiry[o, k] > start:
                count += 1
    return count


def test_session_span_counts_live_slots_and_its_bucket():
    sess = _session(objects=3, num_slots=4)
    sess.hit(0, _space(0), kind="gaussian", width_us=2000.0)
    sess.hit(1, _space(1), when=6 * S)             # after the first span
    sess.hit(2, _space(2), kind="hertz", width_us=500.0, when=2 * S)
    sess.hit(2, _space(3), when=3 * S)
    want = []

    def step(n, **kw):
        k = kw.get("num_slots", sess._span_bucket(False))
        idle = sess._idle() and sess.config.decay_fast_path
        want.append((_brute_live(sess, n), 0 if idle else
                     4 if k is None else k))
        sess._step_span(n, **kw)

    with _profiler():
        for n in (4, 4, 8):
            step(n)
        sess.hit(0, _space(5))
        step(4, num_slots=None)
        step(4)
    s = P.spans()
    spans = _named(s, "session.span")
    got = list(zip(s["c1"][spans].tolist(), s["c0"][spans].tolist()))
    assert got == want
    assert want[0][0] == 3 and want[1][0] == 2   # the future hit counts later
    assert want[3] == (1, 4)                      # the full table
    assert want[4] == (0, 0)                      # a decay span: no slots
    # the first span of 4 and the one of 8 blocks built their chunk's
    # tables; the rest found them
    tables = _named(s, "session.tables")
    assert s["parent"][tables].tolist() == s["index"][spans[[0, 2]]].tolist()


@pytest.mark.parametrize("blocks", [1, 4])
def test_block_profiler_samples_a_dispatch_against_its_blocks(blocks):
    p = P.BlockProfiler(512, 44100, capacity=8)
    period = 512 / 44100
    times = [0.5 * period * blocks, 0.9 * period * blocks,
             1.2 * period * blocks]
    for t in times:
        p.record(t, blocks)
    st = p.stats()
    assert st.count == 3 * blocks and st.dispatches == 3
    assert st.deadline_ms == pytest.approx(1e3 * period * blocks)
    assert st.deadline_miss_rate == pytest.approx(1 / 3)
    assert st.p50_ms == pytest.approx(1e3 * times[1])
    assert st.rtf == pytest.approx(1e3 * period * blocks / st.mean_ms)
    for _ in range(10):                 # the ring keeps the last 8
        p.record(0.1 * period, 1)
    st = p.stats()
    assert st.count == 3 * blocks + 10 and st.dispatches == 8


def test_threads_racing_lose_no_span_and_cross_no_parent():
    """More threads than cores, switching often: every span is kept once,
    and every child's parent is a span of its own thread and trace."""
    import sys
    n_threads, n_spans = 12, 300
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            def work(t):
                for k in range(n_spans):
                    outer = P.begin(P.DISPATCH, t * n_spans + k)
                    P.end(P.begin(P.COPY))
                    P.end(outer, t)
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    s = P.spans()
    assert s["index"].size == 2 * n_threads * n_spans
    assert np.unique(s["index"]).size == s["index"].size
    pos = {int(i): k for k, i in enumerate(s["index"])}
    kids = _named(s, "engine.copy")
    up = [pos[int(p)] for p in s["parent"][kids]]
    assert (s["name"][up] == P.DISPATCH).all()
    assert (s["thread"][up] == s["thread"][kids]).all()
    assert (s["trace"][up] == s["trace"][kids]).all()
    roots = _named(s, "engine.dispatch")
    assert sorted(s["trace"][roots].tolist()) == list(
        range(n_threads * n_spans))


def _scene(**kw):
    """Two instances of a small model with FFAT maps, on the CPU; with
    ``compressed`` its compressed maps too, read from the start."""
    md = synth_mode_data(MODES, 4, seed=5)
    freqs = md.frequencies_hz(CERAMIC.density)
    maps = {i: synth_fatcube(i, float(freqs[i]), n=4) for i in range(MODES)}
    model = ModalSoundModel("m", np.zeros((4, 3)), np.zeros((0, 3), int),
                            np.tile([0.0, 0.0, 1.0], (4, 1)), CERAMIC, md,
                            MODES, maps)
    if kw.pop("compressed", False):
        kw.update(compressed_maps=[{i: compress_map(m) for i, m in
                                    maps.items()}], use_compressed=True)
    return Scene([SceneInstance(model, np.zeros(3)),
                  SceneInstance(model, np.asarray([0.6, 0.0, 0.0]))],
                 block_size=S, backend="blocked", device="cpu", **kw)


def test_a_binaural_move_records_its_lookup_and_phase_inside_apply():
    """A head move put to the engine on a binaural ITD scene reading the
    compressed maps: one session.lookup (L = 2, compressed) and one
    session.itd (L = 2, the bank's M modes) inside engine.apply (the engine's warmup
    takes its own moves, outside any dispatch)."""
    scene = _scene(binaural=True, itd=True, smooth_transfer=True,
                   compressed=True)
    engine = StreamingEngine(scene.session, RawCollectorSink())
    with _profiler():
        engine.set_listener(np.asarray([1.1, 0.4, 0.7]))
        engine.start()
        deadline = time.time() + 120
        while engine._blocks_done < 2 and time.time() < deadline:
            time.sleep(0.01)
        engine.stop()
    assert engine.error is None
    s = P.spans()
    pos = {int(i): k for k, i in enumerate(s["index"])}
    in_apply = [k for k in range(s["index"].size) if s["parent"][k] >= 0
                and s["name"][pos[int(s["parent"][k])]] == P.APPLY]
    for name, counters in (("session.lookup", [2, 1]),
                           ("session.itd", [2, scene.bank.num_modes])):
        mine = [k for k in in_apply if k in _named(s, name)]
        assert len(mine) == 1
        assert [s["c0"][mine[0]], s["c1"][mine[0]]] == counters
    assert scene.session.state.transfer_im is not None


def test_a_move_records_nothing_without_a_profiler_and_mono_no_phase():
    """Outside a profiler a binaural ITD move records nothing; a mono
    move on the raw maps records its lookup (L = 1, raw) and no phase."""
    _scene(binaural=True, itd=True).set_listener(np.asarray([1.0, 0.5, 0.2]))
    assert P.spans()["index"].size == 0
    mono = _scene()
    with _profiler():
        mono.set_listener(np.asarray([1.0, 0.5, 0.2]))
    s = P.spans()
    lookup = _named(s, "session.lookup")
    assert lookup.size == 1
    assert [s["c0"][lookup[0]], s["c1"][lookup[0]]] == [1, 0]
    assert _named(s, "session.itd").size == 0
