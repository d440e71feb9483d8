"""The harness end to end at CPU size: the last line's shape, the check by
the plain reference (sound runs pass; the control and each fault a cell
can have fail), and that nothing it loads is JAX or the JAX package."""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import check, harness
from portbench.run import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["hetero.live.rattle", "hetero.live.walk", "shared.bake.busy",
         "shared.bake.drag"]
SEED = 2 ** 31 + 12345


def _measure(cell, keep_run=False):
    return harness.measure(cell, SEED, 0.5, False, "cpu",
                           time.perf_counter(), keep_run=keep_run)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_the_line_has_its_shape(name, tiny):
    out = _measure(tiny(name), keep_run=True)
    run = out.pop("run")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["metrics"]["setup_s"]["value"] > 0
    json.dumps(out)
    # the program's audio is what the reference replayed, event for event
    if name.startswith("hetero.live"):
        events = run["items"][0]["events"]
        kinds = {e[1] for e in events}
        assert {"hit", "listener", "drag"} <= kinds
        assert events[0][:2] == (0, "listener")


def _faulty(monkeypatch, fault, name):
    """Break the timed path underneath the harness."""
    from openpbso_tpu_torch.runtime import engine, session, solver
    if fault == "state unchanged":
        # every step the session takes: a span, a block, a ramped block
        for name_ in ("step_span", "step_block", "step_block_xfade"):
            def frozen(state, *a, _step=getattr(session, name_), **kw):
                new, *out = _step(state, *a, **kw)
                return (dataclasses.replace(new, z_re=state.z_re,
                                            z_im=state.z_im), *out)
            monkeypatch.setattr(session, name_, frozen)
    elif fault == "half the objects":
        mixdown = solver._mixdown

        def half(sound, gains):
            keep = sound.shape[-2] // 2
            return 2.0 * mixdown(sound[..., :keep, :], gains[:keep])
        monkeypatch.setattr(solver, "_mixdown", half)
    elif fault == "one answer altered":
        if name.startswith("hetero.live"):
            host = engine._host
            count = [0]

            def altered(x):
                out = host(x)
                if out.ndim == 2 and out.shape[1] == 2:    # a block's mix
                    count[0] += 1
                    if count[0] == 12:
                        return -out
                return out
            monkeypatch.setattr(engine, "_host", altered)
        else:
            step = session.step_span
            count = [0]

            def altered(*a, **kw):
                state, mix = step(*a, **kw)
                count[0] += 1
                return state, (-mix if count[0] % 5 == 3 else mix)
            monkeypatch.setattr(session, "step_span", altered)


@pytest.mark.parametrize("fault", ["state unchanged", "half the objects",
                                   "one answer altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, tiny, monkeypatch):
    _faulty(monkeypatch, fault, name)
    out = _measure(tiny(name))
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, tiny):
    cell = tiny(name)
    out = _measure(cell, keep_run=True)
    run = out.pop("run")
    limit = cell["limits"]["rel_err"]["limit"]
    for it in check.items(cell, run):
        ref = check.reference_audio(cell["config"], run["ref_scene"], it,
                                    "cpu")
        low = check.reference_audio(cell["config"], run["ref_scene"], it,
                                    "cpu", control=True)
        assert check.rel_err(low, ref) > limit
        assert check.rel_err(it["audio"], ref) <= limit


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["jax.numpy", "openpbso_tpu_torch.ops",
                              "numpy"]) == ["jax"]
    assert forbidden_modules(["openpbso_tpu.ops.span", "flax.linen",
                              "jaxlib"]) == ["flax", "jax" + "lib",
                                             "openpbso_tpu"]
    assert forbidden_modules(["openpbso_tpu_torch", "jaxtyping",
                              "portbench"]) == []


def test_nothing_the_benchmark_loads_is_jax():
    code = (
        "import sys, os\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import portbench.run as r\n"
        "from portbench import cells, harness, control, check\n"
        "from portbench.reference import replay\n"
        "for w in cells.benchmark()['workloads']:\n"
        "    c = cells.load(w['name'])\n"
        "    [cells.reader(m['name']) for m in c['per_layer']]\n"
        "import openpbso_tpu_torch.runtime.engine\n"
        "import openpbso_tpu_torch.apps.render_timeline\n"
        "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_it_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "hetero.live.rattle", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert np.isfinite(out.returncode)


@pytest.mark.parametrize("name", ["hetero.live.rattle", "hetero.live.walk"])
def test_live_events_apply_at_their_scheduled_blocks(name, tiny):
    from portbench import generator, scene
    cell = tiny(name)
    out = _measure(cell, keep_run=True)
    cfg, s = cell["config"], cell["config"]["block_size"]
    inputs = scene.make_inputs(cfg, SEED)
    n = int(np.ceil(0.5 * cfg["sample_rate"] / s)) + 64
    _, calls = generator.live_schedule(cell["mix"], cfg, inputs, SEED, n)
    ops = {"hit": "hit", "set_listener": "listener",
           "sustained_start": "drag", "sustained_update": "drag"}
    got = [(c // s, op) for c, op, _ in out["run"]["items"][0]["events"][1:]]
    base = got[0][0] - calls[0][0]
    want = [(b + base, ops[call[0]]) for b, call in calls][:len(got)]
    assert len(got) > 20 and got == want
