"""The readers of the program's spans on synthetic spans: written through
the program's own span log (openpbso_tpu_torch.runtime.profiling) with
stamps and counters of the test's choosing, under a CPU profiler; and
each reader's None: another kind of cell, nothing to read, a program
without the log, a ring that overwrote the window."""
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from openpbso_tpu_torch.runtime import profiling as P
from portbench import cells

MS = 1_000_000
LIVE = ("apply_ms_p95.live", "enqueue_ms_per_block.live",
        "copy_wait_ms_per_block.live")
BAKE = ("schedule_us_per_event.render", "tables_ms_per_bake.render",
        "slot_fill_pct.render")


@pytest.fixture(autouse=True)
def _fresh_log():
    P.reset()
    yield
    P.reset()


def _write(tree):
    """Spans (name, trace, t0_ms, t1_ms, c0, c1, children), nested as
    given, into the log."""
    def put(node):
        name, trace, a, b, c0, c1, kids = node
        tok = P.begin(name, trace, t0=a * MS)
        for kid in kids:
            put(kid)
        P.end(tok, c0, c1, t1=b * MS)
    with profile(activities=[ProfilerActivity.CPU]):
        for node in tree:
            put(node)


def _dispatch(trace, a, apply_end, b, events, copies):
    return (P.DISPATCH, trace, a, b, 1, 0, [
        (P.APPLY, None, a, apply_end, events, 0, []),
        (P.SYNTH, None, apply_end, b, 1, 0,
         [(P.COPY, None, c0, c1, 0, 0, []) for c0, c1 in copies])])


def _live():
    # two dispatches in the window (apply 2 and 1 ms; synth 8 and 11 ms
    # with 2 and 1 + 2 ms of copies), one after it
    _write([_dispatch(0, 10, 12, 20, 2, [(18, 20)]),
            _dispatch(1, 50, 51, 62, 0, [(55, 56), (60, 62)]),
            _dispatch(2, 150, 151, 160, 5, [(155, 160)])])
    return dict(kind="live", config={}, t0_ns=0, t1_ns=100 * MS)


def _span(a, b, k, live, tables=()):
    return (P.SPAN, None, a, b, k, live,
            [(P.TABLES, None, t0, t1, 0, 0, []) for t0, t1 in tables])


def _bake():
    # two bakes in the window, one after it; 4 objects
    _write([(P.BAKE, 0, 0, 40, 0, 0, [
                (P.SCHEDULE, None, 1, 3, 10, 0, []),
                _span(5, 15, 16, 4, [(5, 9)]),
                _span(20, 30, 0, 0),
                (P.SCHEDULE, None, 31, 32, 5, 0, []),
                _span(33, 38, 4, 2)]),
            (P.BAKE, 1, 50, 90, 0, 0, [_span(55, 60, 16, 8, [(55, 56)])]),
            (P.BAKE, 2, 120, 130, 0, 0, [
                (P.SCHEDULE, None, 121, 122, 1, 0, []),
                _span(123, 129, 16, 16, [(123, 128)])])])
    return dict(kind="bake", config={"objects": 4}, t0_ns=0,
                t1_ns=100 * MS)


def test_live_readers():
    rec = _live()
    assert cells.reader("apply_ms_p95.live")(rec) == pytest.approx(
        np.percentile([2.0, 1.0], 95))
    assert cells.reader("enqueue_ms_per_block.live")(rec) == pytest.approx(
        (8 + 11 - 2 - 1 - 2) / 2)
    assert cells.reader("copy_wait_ms_per_block.live")(rec) == \
        pytest.approx((2 + 1 + 2) / 2)
    for name in BAKE:
        assert cells.reader(name)(rec) is None


def test_bake_readers():
    rec = _bake()
    assert cells.reader("schedule_us_per_event.render")(rec) == \
        pytest.approx((2000 + 1000) / 15)
    assert cells.reader("tables_ms_per_bake.render")(rec) == pytest.approx(
        (4 + 1) / 2)
    assert cells.reader("slot_fill_pct.render")(rec) == pytest.approx(
        100 * (4 + 2 + 8) / ((16 + 4 + 16) * 4))
    for name in LIVE:
        assert cells.reader(name)(rec) is None


def test_nothing_to_read():
    live = dict(kind="live", config={}, t0_ns=0, t1_ns=100 * MS)
    bake = dict(kind="bake", config={"objects": 4}, t0_ns=0, t1_ns=100 * MS)
    for name in LIVE:
        assert cells.reader(name)(live) is None
    for name in BAKE:
        assert cells.reader(name)(bake) is None
    # bakes with no events, no tables and no span over slots: no schedule
    # or fill, and no table time
    _write([(P.BAKE, 0, 0, 40, 0, 0, [_span(5, 15, 0, 0)])])
    assert cells.reader("schedule_us_per_event.render")(bake) is None
    assert cells.reader("slot_fill_pct.render")(bake) is None
    assert cells.reader("tables_ms_per_bake.render")(bake) == 0.0


def test_a_program_without_the_span_log(monkeypatch):
    live, bake = _live(), _bake()
    monkeypatch.delattr(P, "spans")
    for name in LIVE:
        assert cells.reader(name)(live) is None
    for name in BAKE:
        assert cells.reader(name)(bake) is None


def test_a_ring_that_overwrote_the_window():
    P.reset(capacity=4)
    live = _live()
    assert P.overwritten() > 0
    for name in LIVE:
        assert cells.reader(name)(live) is None
    # a window that starts after the oldest span kept is read
    late = dict(live, t0_ns=151 * MS, t1_ns=200 * MS)
    assert cells.reader("copy_wait_ms_per_block.live")(late) == \
        pytest.approx(5.0)
