"""The spatial cell at CPU size: its entry's run checked by the binaural
reference (a sound run passes; its ears swapped or its interaural phase
left out fail), the scene's frozen uint8 quantisation against the
program's compress_map, the head's positions clear of the shell edges,
and the two readers of the session's listener spans."""
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from openpbso_tpu_torch.runtime import profiling as P
from portbench import cells, generator, harness
from portbench.entries import spatial
from portbench.events.head import clear_world
from portbench.scenes import spatial_scene

NAME = "spatial.live.itd"
SEED = 2 ** 31 + 777
MS = 1_000_000


@pytest.fixture(scope="module")
def measured():
    from portbench.tests.conftest import tiny_cell
    cell = tiny_cell(NAME)
    out = harness.measure(cell, SEED, 0.5, False, "cpu",
                          time.perf_counter(), keep_run=True)
    return cell, out


def test_a_sound_run_is_correct(measured):
    cell, out = measured
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"block_ms_p50", "block_ms_p95",
                                   "setup_s"}
    events = out["run"]["items"][0]["events"]
    assert events[0][:2] == (0, "listener")
    assert np.shape(events[0][2]["rows"]) == (3,)     # a world position
    assert out["run"]["items"][0]["audio"].shape[1] == 2


@pytest.mark.parametrize("fault", ["ears swapped", "no interaural phase"])
def test_compare_refuses_a_fault(measured, fault):
    cell, out = measured
    run = dict(out["run"])
    ref_scene = run.pop("ref_scene")
    item = dict(run["items"][0])
    if fault == "ears swapped":
        item["audio"] = item["audio"][:, ::-1]
    else:
        ref = spatial.reference_audio(cell["config"], dict(
            ref_scene, itd=False), item, "cpu")
        item["audio"] = ref
    checks = spatial.compare(cell, ref_scene, dict(run, items=[item]), "cpu")
    assert checks["rel_err"]["value"] > 10 * checks["rel_err"]["limit"]


def test_the_quantisation_is_compress_maps(tiny):
    from openpbso_tpu_torch.ops.ffat_fit import compress_map
    cfg = tiny(NAME)["config"]
    inputs = spatial_scene.make_inputs(cfg, SEED)
    port = spatial_scene.port_scene(cfg, inputs, "cpu")
    for k, mdl in enumerate({id(i.model): i.model
                             for i in port["instances"]}.values()):
        for mode, mp in mdl.ffat_maps.items():
            want = compress_map(mp, jpeg_quality=None).psi
            np.testing.assert_array_equal(
                port["compressed"][k][mode].psi, want)
            np.testing.assert_array_equal(inputs["maps"][k]["psi_c"][mode],
                                          want)


def test_head_positions_clear_the_shell_edges(tiny):
    cell = tiny(NAME)
    cfg = cell["config"]
    inputs = spatial_scene.make_inputs(cfg, SEED)
    first, calls = generator.live_schedule(cell["mix"], cfg, inputs, SEED,
                                           400)
    heads = [first] + [c[1][1][0] for c in calls if c[1][0] ==
                       "set_listener"]
    assert len(heads) == 40
    ears = spatial_scene.ear_offsets(cfg)
    for h in heads:
        rel = h[None, None] + ears[:, None] - inputs["centers"][None]
        np.testing.assert_array_equal(generator.clear_of_edges(rel), rel)
    # a head on an edge's diagonal moves off it, by under a millimetre
    tie = inputs["centers"][0] + np.asarray([1.6, 1.6, 1.6]) - ears[0]
    moved = clear_world(tie, inputs["centers"], ears)
    assert 0 < np.linalg.norm(moved - tie) < 1e-3


def _record(kind="spatial"):
    with profile(activities=[ProfilerActivity.CPU]):
        for k, (lookup, itd) in enumerate([(2, 5), (3, 4), (1, 6)]):
            a = (100 + 20 * k) * MS
            apply = P.begin(P.APPLY, k, t0=a)
            tok = P.begin(P.LOOKUP, t0=a)
            P.end(tok, 2, 1, t1=a + lookup * MS)
            tok = P.begin(P.ITD, t0=a + lookup * MS)
            P.end(tok, 2, 1024, t1=a + (lookup + itd) * MS)
            P.end(apply, 1, t1=a + 12 * MS)
    return dict(kind=kind, config={}, t0_ns=50 * MS, t1_ns=500 * MS)


def test_the_listener_span_readers():
    P.reset()
    try:
        rec = _record()
        got = {m: cells.reader(m)(rec) for m in (
            "lookup_ms_p95.spatial", "itd_ms_p95.spatial")}
        assert got["lookup_ms_p95.spatial"] == pytest.approx(
            np.percentile([2, 3, 1], 95))
        assert got["itd_ms_p95.spatial"] == pytest.approx(
            np.percentile([5, 4, 6], 95))
        # another kind of cell, and a window without the spans
        assert cells.reader("itd_ms_p95.spatial")(dict(rec, kind="live")) \
            is None
        assert cells.reader("lookup_ms_p95.spatial")(
            dict(rec, t0_ns=600 * MS, t1_ns=700 * MS)) is None
    finally:
        P.reset()


def test_readers_of_a_program_without_the_spans(monkeypatch):
    monkeypatch.setattr(P, "NAMES", P.NAMES[:8])
    rec = dict(kind="spatial", config={}, t0_ns=0, t1_ns=MS)
    for m in ("lookup_ms_p95.spatial", "itd_ms_p95.spatial"):
        assert cells.reader(m)(rec) is None
