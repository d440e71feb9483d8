"""The configurations, the traffic generator and the frozen roofline."""
import json
import os

import numpy as np
import pytest

from portbench import cells, generator, roofline, scene

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_configs_parse_with_the_stated_sizes():
    bench = cells.benchmark()
    want = {"hetero-256x1024": False, "shared-256x1024": True}
    assert {c["name"] for c in bench["configs"]} == set(want)
    for c in bench["configs"]:
        cfg = scene.load_config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert c["reduced"] == cfg["reduced"] == []
        assert (cfg["objects"], cfg["modes"], cfg["block_size"],
                cfg["sample_rate"], cfg["dtype"]) == (256, 1024, 512, 44100,
                                                      "float32")
        assert cfg["shared_bank"] is want[c["name"]]
        assert cfg["smooth_transfer"] and cfg["span_path"]
        assert max(cfg["freq_high_hz"]) < 20000.0


def test_every_cell_has_its_files():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell["limits"]["rel_err"]["limit"] > 0
        assert cell["mix"]["entry"] in ("live", "bake")
        assert callable(cells.entry(cell["mix"]["entry"]).run)
        for p in cell["mix"]["events"]:
            fam = generator.family(p["family"])
            assert callable(getattr(fam, cell["mix"]["entry"]))
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(cells.reader(m["name"]))


def _same(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("name", ["hetero.live.rattle", "hetero.live.walk",
                                  "shared.bake.busy", "shared.bake.drag"])
def test_traffic_is_deterministic_by_seed(name, tiny):
    cell = tiny(name)
    cfg, mix = cell["config"], cell["mix"]
    inputs = scene.make_inputs(cfg, 2 ** 31 + 7)
    assert _same(inputs, scene.make_inputs(cfg, 2 ** 31 + 7))
    other = scene.make_inputs(cfg, 2 ** 31 + 8)
    assert not np.array_equal(inputs["omega_sq"], other["omega_sq"])
    if mix["entry"] == "live":
        make = lambda s: generator.live_schedule(mix, cfg, inputs, s, 200)  # noqa: E731
    else:
        make = lambda s: generator.bake_timeline(mix, cfg, inputs, s, 3)  # noqa: E731
    a, b, c = make(5 ** 15), make(5 ** 15), make(5 ** 15 + 1)
    assert _same(a, b) and not _same(a, c)
    if mix["entry"] == "live":
        kinds = lambda sched: sorted(x[1][0] for x in sched[1])  # noqa: E731
        assert kinds(a) == kinds(c)          # the same work, in another order
    else:
        assert len(a[1]["events"]) == len(c[1]["events"])
        assert (len(a[1].get("sustained", []))
                == len(c[1].get("sustained", [])))


def test_listener_rows_clear_the_shell_edges():
    rel = np.array([[1.0, 1.0, 0.5], [2.0, -2.0 + 1e-9, 0.1],
                    [0.3, 0.2, 1.6]])
    out = generator.clear_of_edges(rel)
    mag = np.sort(np.abs(out), axis=1)
    assert np.all(mag[:, 2] - mag[:, 1] >= generator.EDGE_MARGIN * mag[:, 2]
                  * 0.999)
    assert np.array_equal(out[2], rel[2])


def test_roofline_reckoning_at_two_shapes():
    # one 64-block span, shared 1024 modes, C = 512: 300 excited (object,
    # chunk) pairs, 256 ringing objects
    b = roofline.span_bound(excited=300, ringing=256, x=64, c=512, m=1024,
                            og=1)
    flops = 300 * (2 * 512 * 2048 + 2 * 2048 * 512 + 512 * 513) \
        + 256 * 64 * (2 * 2048 * 512 + 8 * 1024)
    byts = 4 * (2 * 513 * 1024 + 4 * 256 * 1024 + 256 * 1024
                + 300 * (1024 + 512) + 2 * 32768)
    assert (b["flops"], b["bytes"]) == (flops, byts)
    assert b["seconds"] == pytest.approx(flops / 495e12)
    assert b["bound_by"] == "operations"
    # a one-block span of a per-object table, C = 64: bytes bound it
    b = roofline.span_bound(excited=10, ringing=3, x=8, c=64, m=1024,
                            og=256)
    assert b["bound_by"] == "bytes"
    assert b["seconds"] == pytest.approx(b["bytes"] / 3.35e12)
    assert roofline.chunk_size(64 * 512) == 512
    assert roofline.chunk_size(512) == 64
    assert roofline.chunk_size(3 * 512) == 192


def test_benchmark_json_has_its_keys_and_bounds():
    bench = cells.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    ends = {m["name"] for m in bench["end_to_end"]}
    assert ends == {"block_ms_p50", "block_ms_p95", "render_rt_factor",
                    "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in ends and m["workloads"]
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert len(json.dumps(bench)) < 64 * 1024
