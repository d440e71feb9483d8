"""One run of one cell: set-up, the measured window, the check, the line.

``measure`` drives the cell's entry, reads the device's peak memory,
frees the program's state, runs the reference, and returns the result
object the benchmark prints: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with a trace its per-layer
metrics), ``device``, with a trace ``breakdown``, and last ``checks``,
each compared number beside its limit.

An entry is a module of ``entries/``, named by the cell's traffic mix
(``"entry"``), with

- ``run(cell, seed, seconds, tracer, t_proc, device)``: set-up, then the
  window; returns ``setup_s``, ``attempted``, ``failed``, ``values`` (its
  end-to-end readings by metric name), ``items`` (the compared items:
  ``audio``, the recorded ``events``, ``ar_seed``), ``record`` (what the
  per-layer readers read besides the trace) and ``keep`` (the program's
  objects, freed before the check);
- ``host_spans(record)``: what the host was doing, for the breakdown;
- optionally ``compare(cell, ref_scene, run, device)`` in place of
  check.compare.
"""
from __future__ import annotations

import gc

from . import cells, check, scene, trace


def _end_to_end(cell: dict, run: dict) -> dict:
    values = dict(run["values"], setup_s=run["setup_s"])
    out = {}
    for m in cell["end_to_end"]:
        if m["name"] not in values:
            raise KeyError(f"{cell['name']} has no reading of {m['name']}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def measure(cell: dict, seed: int, seconds: float, traced: bool, device,
            t_proc: float, keep_run: bool = False) -> dict:
    """The run's result object; with ``keep_run`` the entry's readings of
    the run too, under ``"run"`` (the control reads them)."""
    import torch
    entry = cells.entry(cell["mix"]["entry"])
    tracer = trace.Tracer() if traced else None
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    run = entry.run(cell, seed, seconds, tracer, t_proc, device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.pop("keep")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": False, "attempted": int(run["attempted"]),
           "failed": int(run["failed"])}
    if traced:
        rec = dict(run["record"], kind=cell["mix"]["entry"],
                   config=cell["config"], kernels=tracer.kernels,
                   t0_ns=tracer.t0_ns, t1_ns=tracer.t1_ns)
        metrics = {}
        for m in cell["per_layer"]:
            value = cells.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        busy = trace.busy_in(tracer.kernels, [(tracer.t0_ns, tracer.t1_ns)])
        dev.update(busy_s=busy / 1e9,
                   window_s=(tracer.t1_ns - tracer.t0_ns) / 1e9)
        out["device"] = dev
        out["breakdown"] = trace.breakdown(tracer.kernels,
                                           entry.host_spans(rec),
                                           tracer.t0_ns, tracer.t1_ns)
    else:
        out["metrics"] = _end_to_end(cell, run)
        out["device"] = dev
    ref_scene = scene.reference_scene(cell["config"], scene.make_inputs(
        cell["config"], seed))
    compare = getattr(entry, "compare", check.compare)
    checks = compare(cell, ref_scene, run, device)
    out["correct"] = check.correct(checks)
    out["checks"] = checks
    if keep_run:
        out["run"] = dict(run, ref_scene=ref_scene)
    return out
