"""A cell by name: its BENCHMARK.json entry, configuration, traffic mix,
limits and the metrics it reports, each found by the name it is given.

New configurations, mixes, per-layer metrics and limits are new files:
``configs/<config>.json`` (its ``"scene"`` a module of ``scenes/``),
``traffic/<mix>.json`` (its ``"entry"`` a module of ``entries/``, each of
its event families a module of ``events/``), ``metrics/<name>.py`` (a
``read(record)`` function) and ``limits/<cell>.json``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

from . import generator, scene

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load(name: str, bench: dict | None = None) -> dict:
    """The cell ``name``: its workload, config, mix, limits, the end-to-end
    metrics it reports and its per-layer metrics with their readers."""
    bench = bench or benchmark()
    workload = next((w for w in bench["workloads"] if w["name"] == name),
                    None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    with open(os.path.join(HERE, "limits", f"{name}.json")) as fh:
        limits = json.load(fh)
    return dict(name=name, workload=workload, config=scene.load_config(
        workload["config"]), mix=generator.load_mix(workload["traffic"]),
        limits=limits, end_to_end=end_to_end, per_layer=per_layer)


def reader(metric: str):
    """The ``read(record)`` function of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry(name: str):
    """The entry ``entries/<name>.py`` (see harness.py)."""
    return importlib.import_module(f"portbench.entries.{name}")
