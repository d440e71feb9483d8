"""Each per-layer reader on a synthetic record and trace."""
import numpy as np
import pytest

from portbench import cells, trace

MS = 1_000_000


def _live():
    # two dispatches of one block, 10 ms each; kernels 2 ms + 1 ms inside
    # the first, 4 ms inside the second and 1 ms outside both
    return dict(kind="live", config={}, t0_ns=0, t1_ns=100 * MS,
                dispatches=[(10 * MS, 20 * MS, 1), (50 * MS, 60 * MS, 1)],
                kernels=[("a", 11 * MS, 13 * MS), ("b", 12 * MS, 14 * MS),
                         ("a", 51 * MS, 55 * MS), ("c", 80 * MS, 81 * MS)],
                listener_ms=list(np.arange(1.0, 21.0)))


def test_live_readers():
    rec = _live()
    assert cells.reader("kernel_ms_per_block.live")(rec) == pytest.approx(
        (2 + 2 + 4 + 1) / 2)
    assert cells.reader("dispatch_idle_pct.live")(rec) == pytest.approx(
        100 * (1 - 7 / 20))
    assert cells.reader("set_listener_ms_p95.live")(rec) == pytest.approx(
        np.percentile(np.arange(1.0, 21.0), 95))
    for name in ("device_idle_pct.render", "span_roofline_pct.render"):
        assert cells.reader(name)(rec) is None
    assert cells.reader("set_listener_ms_p95.live")(
        dict(rec, listener_ms=[])) is None


def test_bake_readers():
    cfg = dict(block_size=8, objects=2, modes=128, shared_bank=True,
               slots=2, sample_rate=44100)
    space = np.ones(128)
    events = [(0, "hit", dict(obj=0, space=space, kind="point",
                              width_us=1.0, amp=1.0, when=8)),
              (0, "drag", dict(op="start", obj=1, space=space))]
    rec = dict(kind="bake", config=cfg, t0_ns=0, t1_ns=100 * MS,
               bakes=[(0, 50 * MS, events)],
               renders=[(10 * MS, 20 * MS, 0, 0, 2, 64)],
               kernels=[("k", 11 * MS, 16 * MS), ("k", 30 * MS, 35 * MS)])
    assert cells.reader("device_idle_pct.render")(rec) == pytest.approx(
        100 * (1 - 10 / 50))
    # blocks 0 and 1: object 1 drags in both, object 0's point force in
    # block 1: 3 excited pairs of chunk C = 16 (two blocks of 8: a
    # 16-sample span takes C = 16, so each block is half a chunk)
    from portbench import roofline
    c = roofline.chunk_size(16)
    want = roofline.span_bound(excited=3 * (8 // c), ringing=2, x=16 // c,
                               c=c, m=128, og=1)["seconds"]
    got = cells.reader("span_roofline_pct.render")(rec)
    assert got == pytest.approx(100 * want / 5e-3)
    assert cells.reader("kernel_ms_per_block.live")(rec) is None


def test_union_and_breakdown():
    assert trace.busy_in([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)],
                         [(0, 100)]) == 30
    assert trace.busy_in([("a", 0, 10)], [(5, 7), (8, 30)]) == 4
    out = trace.breakdown([("x", 10, 20), ("y", 30, 35), ("x", 40, 41)],
                          [[("dispatch", 20, 32)]], 0, 50)
    assert out["device_ops"] == [["x", 11e-9], ["y", 5e-9]]
    assert dict(out["idle_gaps"]) == {"other": 24e-9, "dispatch": 10e-9}
