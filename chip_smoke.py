#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openpbso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. environment: a CUDA device is required (there is no CPU fallback);
   prints the card's name and power limit, torch and CUDA versions;
2. build: compiles every csrc/*.cu for sm_90a from this checkout (one nvcc
   per source, in parallel) into openpbso_tpu_torch/_build/ and prints the
   build time;
3. kernel vs plain: step_block_fused on the card against its plain PyTorch
   twin (<= -100 dB) and against the blocked backend (<= -90 dB) for a
   heterogeneous and a shared 256x1024 bank at S=512, a ragged bank and a
   chunk larger than the block; two runs must be bitwise equal; times the
   kernel and the plain twin with CUDA events (median of 30);
4. the per-block path end to end: a ModalSession on a heterogeneous
   256x1024 bank with 1024-mode FFAT maps and per-object listeners renders
   ~2 s of a hit script (point, gaussian and hertz, some future-dated)
   through the fused kernel; checks the output, the kernels' launch counts
   and the blocked backend's render (<= -90 dB), and times synced
   per-block steps;
5. the chunked span: the chunk-scan and Toeplitz-conv kernels against
   their plain twins (<= -100 dB, bitwise repeatable, CUDA-event medians)
   at the span shapes of a shared 256x1024 bank at 512 blocks and a
   heterogeneous one at 1024 blocks, with the ms and real-time factor of
   one full span dispatch at each; then the phase-4 session, built with
   its float64 eigenvalues, renders the same script with render_multi (16
   blocks per span): checked against phase 4's fused render (<= -90 dB)
   and the kernels' launch counts; each kernel is held against its twin
   on the inputs of the render's first busy (and first ring-down)
   dispatch (<= -100 dB); and the span dispatches are timed.

The last two lines of stdout are the kernels' JSON summary and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

O, M, S, CHUNK = 256, 1024, 512, 64
RENDER_BLOCKS = 172          # ~2 s of audio at 44.1 kHz
LAST_HIT_BLOCK = 86          # no hit later than ~1 s
TIMED_RUNS = 30
SPAN_CASES = (("shared", 512), ("hetero", 1024))   # bank, blocks per span
SPAN_DISPATCH = 16           # render_multi's blocks per dispatch
KERNELS = {   # name -> (source, the TPU kernel or XLA stage it replaces)
    "fused_block": ("openpbso_tpu_torch/csrc/fused_block.cu",
                    "openpbso_tpu/ops/pallas_integrator.py:60"),
    "chunk_scan": ("openpbso_tpu_torch/csrc/chunk_scan.cu",
                   "openpbso_tpu/ops/span.py:414"),
    "toeplitz_conv": ("openpbso_tpu_torch/csrc/toeplitz_conv.cu",
                      "openpbso_tpu/ops/span.py:577"),
}


def db_error(test, ref) -> float:
    """20*log10(||test - ref|| / ||ref||) in float64; -inf when equal."""
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.linalg.norm(test - ref))
    if err == 0.0:
        return float("-inf")
    return 20.0 * np.log10(err / float(np.linalg.norm(ref)))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def hetero_modes(o, n_modes):
    """Per-object mode sets, as bench.py --hetero builds them: (lam, b,
    valid) [O, n_modes] in float64."""
    from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data
    from openpbso_tpu_torch.ops.coeffs import lambda_from_modes
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n_modes, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(o)]
    return tuple(np.stack(x) for x in zip(*parts))


def hetero_bank(o, n_modes, s, device, modes=None):
    from openpbso_tpu_torch.ops.coeffs import build_modal_bank
    lam, b, valid = modes if modes is not None else hetero_modes(o, n_modes)
    return build_modal_bank(lam, b, valid, block_size=s, shared=False,
                            device=device)


def shared_modes(n_modes):
    """One mode set for every object: (ceramic material, omega^2)."""
    from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data
    return CERAMIC, synth_mode_data(n_modes, 8, seed=0).omega_squared


def shared_bank(o, n_modes, s, device):
    from openpbso_tpu_torch.ops.coeffs import bank_from_material
    mat, omega_squared = shared_modes(n_modes)
    return bank_from_material(mat.density, omega_squared, mat.alpha,
                              mat.beta, num_objects=o, block_size=s,
                              device=device)


def reset_launches():
    from openpbso_tpu_torch.ops import chunk_scan, fused_integrator
    from openpbso_tpu_torch.ops import toeplitz_conv
    for mod in (fused_integrator, chunk_scan, toeplitz_conv):
        mod.LAUNCHES = 0


def read_launches() -> dict:
    from openpbso_tpu_torch.ops import chunk_scan, fused_integrator
    from openpbso_tpu_torch.ops import toeplitz_conv
    return {"fused_block": fused_integrator.LAUNCHES,
            "chunk_scan": chunk_scan.LAUNCHES,
            "toeplitz_conv": toeplitz_conv.LAUNCHES}


def block_inputs(bank, s, rng):
    import torch
    o, m = bank.num_objects, bank.num_modes
    mask = bank.mask.cpu().numpy()

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=bank.device)
    return (dev(rng.standard_normal((o, m)) * mask),
            dev(rng.standard_normal((o, m)) * mask),
            dev(rng.standard_normal((o, m)) * mask),
            dev(rng.standard_normal((o, s))),
            dev(rng.uniform(0.5, 2.0, (o, m))))


def time_ms(fn, runs=TIMED_RUNS) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def kernel_case(name, bank, s, chunk, rng, timed=False):
    """Phase 3 for one bank: kernel vs plain twin vs blocked."""
    import torch
    from openpbso_tpu_torch.ops import fused_integrator as fi
    from openpbso_tpu_torch.ops.integrator import step_block_blocked
    z_re, z_im, space, tp, tr = block_inputs(bank, s, rng)
    args = (z_re, z_im, bank, space, tp, tr)
    got = fi.step_block_fused(*args, chunk=chunk)[:3]
    again = fi.step_block_fused(*args, chunk=chunk)[:3]
    plain = fi.fused_block_reference(*args, chunk=chunk)
    blocked = step_block_blocked(*args)[:3]
    torch.cuda.synchronize()
    out = {"case": name, "O": bank.num_objects, "M": bank.num_modes,
           "S": s, "chunk": min(chunk, s), "max_abs_err": 0.0}
    for label, k, a, p, b in zip(("z_re", "z_im", "sound"), got, again,
                                 plain, blocked):
        check(torch.equal(k, a), f"{name}: {label} differs between two runs")
        k, p, b = (x.cpu().numpy() for x in (k, p, b))
        check(np.isfinite(k).all(), f"{name}: {label} not finite")
        out[f"{label}_db_vs_plain"] = db_error(k, p)
        out[f"{label}_db_vs_blocked"] = db_error(k, b)
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float(np.max(np.abs(k - p))))
        check(out[f"{label}_db_vs_plain"] <= -100.0,
              f"{name}: {label} {out[f'{label}_db_vs_plain']} dB vs plain")
        check(out[f"{label}_db_vs_blocked"] <= -90.0,
              f"{name}: {label} {out[f'{label}_db_vs_blocked']} dB vs "
              f"blocked")
    if timed:
        out["kernel_ms"] = time_ms(lambda: fi.step_block_fused(
            *args, chunk=chunk))
        out["plain_ms"] = time_ms(lambda: fi.fused_block_reference(
            *args, chunk=chunk))
        out["blocked_ms"] = time_ms(lambda: step_block_blocked(*args))
    print("kernel case:", json.dumps(out), flush=True)
    return out


def hit_script(rng, o, n_modes, block):
    """Point, gaussian and hertz hits on every third object; three in four
    future-dated (block-aligned, no later than LAST_HIT_BLOCK)."""
    kinds = ("point", "gaussian", "hertz")
    hits = []
    for i, obj in enumerate(range(0, o, 3)):
        when = (None if i % 4 == 0
                else int(rng.integers(1, LAST_HIT_BLOCK + 1)) * block)
        hits.append(dict(obj=obj, space=rng.standard_normal(n_modes),
                         kind=kinds[i % 3],
                         width_us=float(rng.uniform(200.0, 2000.0)),
                         amp=float(rng.uniform(0.5, 1.5)), when=when))
    return hits


def new_session(bank, ffat, listeners, hits, backend, lam64=None):
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    sess = ModalSession(bank, ffat, SolverConfig(block_size=S,
                                                 backend=backend),
                        lam64=lam64)
    sess.set_listener(listeners)
    for h in hits:
        sess.hit(h["obj"], h["space"], kind=h["kind"],
                 width_us=h["width_us"], amp=h["amp"], when=h["when"])
    return sess


def phase_session(bank, rng):
    import torch
    from openpbso_tpu_torch.utils.synth import synth_fatcube
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops import fused_integrator as fi
    from openpbso_tpu_torch.ops.ffat import build_ffat
    from openpbso_tpu_torch.ops.forces import (FORCE_GAUSSIAN, FORCE_HERTZ,
                                               FORCE_POINT, slot_duration)
    t = time.perf_counter()
    freqs = np.geomspace(120.0, 15000.0, M)
    ffat = build_ffat({i: synth_fatcube(i, float(freqs[i]), n=16)
                       for i in range(M)}, M, device=bank.device)
    print(f"ffat maps: {M} modes in {time.perf_counter() - t} s", flush=True)
    listeners = rng.uniform(-1.0, 1.0, (O, 3)) * 2.0
    listeners[:, 2] += 1.0
    hits = hit_script(rng, O, M, S)

    # blocks that are not idle: every block before the last slot expires
    # (a future-dated slot keeps the scene live until it has fired)
    code = {"point": FORCE_POINT, "gaussian": FORCE_GAUSSIAN,
            "hertz": FORCE_HERTZ}
    last_expiry = 0
    for h in hits:
        width = (1.0 if h["kind"] == "point"
                 else max(1, int(h["width_us"] / 1e6 * SAMPLE_RATE)))
        last_expiry = max(last_expiry, (h["when"] or 0)
                          + slot_duration(code[h["kind"]], width, S))
    busy = sum(1 for b in range(RENDER_BLOCKS) if b * S < last_expiry)
    check(0 < busy < RENDER_BLOCKS, f"hit script leaves {busy} busy blocks")

    sess = new_session(bank, ffat, listeners, hits, "auto")
    check(sess.decay_eligible(), "fused session is not decay-eligible")
    reset_launches()
    mix = sess.render(RENDER_BLOCKS)
    counts = read_launches()
    launches = counts["fused_block"]
    check(counts["chunk_scan"] == counts["toeplitz_conv"] == 0,
          f"the per-block path launched span kernels: {counts}")
    check(mix.shape == (RENDER_BLOCKS * S, 2), f"mix shape {mix.shape}")
    check(bool(np.isfinite(mix).all()), "mix not finite")
    peak = float(np.abs(mix).max())
    check(peak > 0.0, "mix is silent")
    check(launches == busy and launches > 0,
          f"kernel launches {launches} != busy blocks {busy}")
    after = mix[(LAST_HIT_BLOCK + 4) * S:(LAST_HIT_BLOCK + 24) * S]
    tail = mix[-20 * S:]
    e_after, e_tail = float(np.sum(after ** 2)), float(np.sum(tail ** 2))
    check(e_tail < e_after, f"tail energy {e_tail} >= {e_after}")

    ref = new_session(bank, ffat, listeners, hits, "blocked").render(
        RENDER_BLOCKS)
    db_blocked = db_error(mix, ref)
    check(db_blocked <= -90.0, f"session mix {db_blocked} dB vs blocked")

    # synced per-block dispatch, split into full and idle decay blocks
    timed = new_session(bank, ffat, listeners, hits, "auto")
    full_ms, decay_ms = [], []
    for _ in range(RENDER_BLOCKS):
        decay = timed._idle() and timed.decay_eligible()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, blk, _ = timed.step()
        blk.cpu()
        (decay_ms if decay else full_ms).append(
            1e3 * (time.perf_counter() - t))
    summary = {
        "blocks": RENDER_BLOCKS, "busy_blocks": busy, "launches": launches,
        "peak": peak, "energy_after_hits": e_after, "energy_tail": e_tail,
        "db_vs_blocked": db_blocked,
        "full_blocks": len(full_ms),
        "full_ms_median": statistics.median(full_ms),
        "full_ms_mean": statistics.fmean(full_ms),
        "decay_blocks": len(decay_ms),
        "decay_ms_median": statistics.median(decay_ms),
        "decay_ms_mean": statistics.fmean(decay_ms),
        "all_ms_mean": statistics.fmean(full_ms + decay_ms),
    }
    print("session:", json.dumps(summary), flush=True)
    return dict(launches=launches, ffat=ffat, listeners=listeners,
                hits=hits, mix=mix, last_expiry=last_expiry)


def span_kernel_case(name, bank, lam64, n_blocks, seed):
    """Phase 5a for one bank: the chunk-scan and Toeplitz-conv kernels at
    the shapes a span of n_blocks gives them (one slot, one listener),
    against their twins, then one full span dispatch timed."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops import chunk_scan as k1
    from openpbso_tpu_torch.ops import toeplitz_conv as k2
    from openpbso_tpu_torch.ops.forces import FORCE_GAUSSIAN
    from openpbso_tpu_torch.ops.span import build_span_tables
    from openpbso_tpu_torch.runtime.solver import default_gains, step_span
    from openpbso_tpu_torch.runtime.state import make_solver_state
    dev = bank.device
    t = time.perf_counter()
    tables = build_span_tables(lam64, n_blocks * S, num_modes=bank.num_modes,
                               device=dev)
    table_s = time.perf_counter() - t
    c, x, m = tables.chunk, tables.n_chunks, bank.num_modes
    check(tables.shared == (name == "shared"), f"{name}: table layout")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    scan_args = (randn(O, m), randn(O, m), tables.b_re[:, c],
                 tables.b_im[:, c], x, randn(O, x, m), randn(O, x, m))
    conv_args = (randn(O, 1, 1, c), randn(O, 1, x, c))
    out = {"case": name, "O": O, "M": m, "n_blocks": n_blocks, "chunk": c,
           "n_chunks": x, "table_build_s": table_s}
    for label, kernel, twin, args, runs in (
            ("chunk_scan", k1.chunk_scan, k1.chunk_scan_reference,
             scan_args, 10),
            ("toeplitz_conv", k2.toeplitz_conv, k2.toeplitz_conv_reference,
             conv_args, TIMED_RUNS)):
        got, again, plain = (fn(*args) for fn in (kernel, kernel, twin))
        torch.cuda.synchronize()
        if label == "toeplitz_conv":
            got, again, plain = (got,), (again,), (plain,)
        err, dbs = 0.0, []
        for k, a, p in zip(got, again, plain):
            check(torch.equal(k, a), f"{name}: {label} differs between runs")
            check(bool(torch.isfinite(k).all()), f"{name}: {label} not finite")
            err = max(err, float((k - p).abs().max()))
            dbs.append(db_error(k.cpu().numpy(), p.cpu().numpy()))
        check(max(dbs) <= -100.0, f"{name}: {label} {max(dbs)} dB vs plain")
        del got, again, plain
        out[label] = {"db_vs_plain": max(dbs), "max_abs_err": err,
                      "ms": time_ms(lambda: kernel(*args)),
                      "plain_ms": time_ms(lambda: twin(*args), runs=runs)}
    del scan_args, conv_args

    # one full span dispatch, as bench.py's span headline drives it: a
    # gaussian hit planted on every object, the one-slot bucket
    state = make_solver_state(O, m, num_slots=8, device=dev)
    state.slots.ftype[:, 0] = FORCE_GAUSSIAN
    state.slots.width[:, 0] = 40.0
    state.slots.space[:, 0] = randn(O, m)
    gains = default_gains(O, device=dev)
    spans = []
    for i in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, mix = step_span(state, bank, tables, gains,
                               n_blocks=n_blocks, block_size=S, num_slots=1)
        b.record()
        spans.append((a, b))
        if i == 0:
            check(bool(torch.isfinite(mix).all())
                  and float(mix.abs().max()) > 0, f"{name}: span mix")
    torch.cuda.synchronize()
    span_ms = statistics.median(a.elapsed_time(b) for a, b in spans[2:])
    out["span_ms"] = span_ms
    out["span_rtf"] = n_blocks * S / SAMPLE_RATE / (span_ms / 1e3)
    print("span kernel case:", json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def capture_span_kernel_inputs():
    """While open, keep a copy of the arguments of the first chunk_scan
    call with injections ("busy"), the first without ("decay") and the
    first toeplitz_conv call that the span module makes, so the kernels can
    be held against their twins on a real dispatch's own inputs."""
    import torch
    from openpbso_tpu_torch.ops import span as span_mod
    captured = {}

    def capturing(fn, label):
        def call(*args):
            key = (label, "decay" if label == "chunk_scan" and args[5] is None
                   else "busy")
            if key not in captured:
                captured[key] = [a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args]
            return fn(*args)
        return call
    originals = span_mod.chunk_scan, span_mod.toeplitz_conv
    span_mod.chunk_scan = capturing(originals[0], "chunk_scan")
    span_mod.toeplitz_conv = capturing(originals[1], "toeplitz_conv")
    try:
        yield captured
    finally:
        span_mod.chunk_scan, span_mod.toeplitz_conv = originals


def check_dispatch_inputs(captured) -> dict:
    """Each captured dispatch's kernel call against its twin (<= -100 dB)."""
    import torch
    from openpbso_tpu_torch.ops import chunk_scan as k1
    from openpbso_tpu_torch.ops import toeplitz_conv as k2
    pairs = {"chunk_scan": (k1.chunk_scan, k1.chunk_scan_reference),
             "toeplitz_conv": (k2.toeplitz_conv, k2.toeplitz_conv_reference)}
    want = {("chunk_scan", "busy"), ("chunk_scan", "decay"),
            ("toeplitz_conv", "busy")}
    check(set(captured) == want, f"captured span calls {sorted(captured)}")
    out = {}
    for (label, kind), args in sorted(captured.items()):
        kernel, twin = pairs[label]
        got, plain = kernel(*args), twin(*args)
        if label == "toeplitz_conv":
            got, plain = (got,), (plain,)
        torch.cuda.synchronize()
        db = max(db_error(k.cpu().numpy(), p.cpu().numpy())
                 for k, p in zip(got, plain))
        check(db <= -100.0, f"{label} ({kind} dispatch) {db} dB vs plain")
        out[f"{label}_{kind}"] = {"db_vs_plain": db,
                                  "shapes": [list(a.shape) for a in args
                                             if isinstance(a, torch.Tensor)]}
    return out


def phase_span_session(bank, lam64, per_block):
    """Phase 5b: phase 4's session and script, built with lam64, rendered
    by render_multi through the span kernels."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    ffat, listeners, hits = (per_block[k] for k in ("ffat", "listeners",
                                                    "hits"))
    sizes = {SPAN_DISPATCH, RENDER_BLOCKS % SPAN_DISPATCH} - {0}
    n_dispatch = math.ceil(RENDER_BLOCKS / SPAN_DISPATCH)
    busy = sum(1 for d in range(n_dispatch)
               if d * SPAN_DISPATCH * S < per_block["last_expiry"])
    check(0 < busy < n_dispatch, f"{busy} of {n_dispatch} spans are busy")

    sess = new_session(bank, ffat, listeners, hits, "auto", lam64=lam64)
    t = time.perf_counter()
    for n in sizes:
        sess.span_tables_for(n)
    table_s = time.perf_counter() - t
    with capture_span_kernel_inputs() as dispatch_inputs:
        reset_launches()
        t = time.perf_counter()
        mix = sess.render_multi(RENDER_BLOCKS,
                                blocks_per_dispatch=SPAN_DISPATCH)
        render_s = time.perf_counter() - t
        counts = read_launches()
    check(mix.shape == (RENDER_BLOCKS * S, 2), f"span mix shape {mix.shape}")
    check(bool(np.isfinite(mix).all()) and float(np.abs(mix).max()) > 0,
          "span mix not finite or silent")
    want = {"fused_block": 0, "chunk_scan": n_dispatch,
            "toeplitz_conv": busy}
    check(counts == want, f"span launches {counts} != {want}")
    db_fused = db_error(mix, per_block["mix"])
    check(db_fused <= -90.0, f"span mix {db_fused} dB vs the fused render")
    dispatch_db = check_dispatch_inputs(dispatch_inputs)

    # synced span dispatches, as render_multi issues them
    timed = new_session(bank, ffat, listeners, hits, "auto", lam64=lam64)
    for n in sizes:
        timed.span_tables_for(n)
    busy_ms, idle_ms = [], []
    done = 0
    while done < RENDER_BLOCKS:
        n = min(SPAN_DISPATCH, RENDER_BLOCKS - done)
        idle = timed._idle()
        torch.cuda.synchronize()
        t = time.perf_counter()
        timed._step_span(n).cpu()
        (idle_ms if idle else busy_ms).append(1e3 * (time.perf_counter() - t))
        done += n
    audio_s = RENDER_BLOCKS * S / SAMPLE_RATE
    summary = {
        "blocks": RENDER_BLOCKS, "blocks_per_dispatch": SPAN_DISPATCH,
        "dispatches": n_dispatch, "busy_dispatches": busy,
        "launches": counts, "db_vs_fused_render": db_fused,
        "kernel_db_vs_plain_on_dispatch_inputs": dispatch_db,
        "table_build_s": table_s,
        "first_render_multi_s": render_s,   # includes first-use set-up
        "busy_span_ms": busy_ms, "idle_span_ms": idle_ms,
        "busy_span_ms_median": statistics.median(busy_ms),
        "idle_span_ms_median": statistics.median(idle_ms),
        "span_rtf": audio_s / (1e-3 * sum(busy_ms + idle_ms)),
    }
    print("span session:", json.dumps(summary), flush=True)
    return counts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU (no CPU fallback)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from openpbso_tpu_torch.ops import _build
    t = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t} s ({_build.library_path()})",
          flush=True)
    if _build.build_log:
        print(_build.build_log.strip(), flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    t = time.perf_counter()
    modes = hetero_modes(O, M)
    hetero = hetero_bank(O, M, S, dev, modes)
    print(f"hetero bank {O}x{hetero.num_modes}: "
          f"{time.perf_counter() - t} s", flush=True)
    prod = kernel_case("hetero", hetero, S, CHUNK, rng, timed=True)
    shared = shared_bank(O, M, S, dev)
    kernel_case("shared", shared, S, CHUNK, rng, timed=True)
    kernel_case("ragged", hetero_bank(5, 40, 256, dev), 256, CHUNK, rng)
    kernel_case("chunk>S", hetero_bank(3, 24, 32, dev), 32, CHUNK, rng)

    per_block = phase_session(hetero, rng)

    from openpbso_tpu_torch.ops.coeffs import lambda_from_modes
    mat, omega_squared = shared_modes(M)
    shared_lam = lambda_from_modes(mat.density, omega_squared, mat.alpha,
                                   mat.beta)[0]
    span_cases = {}
    for i, (name, n_blocks) in enumerate(SPAN_CASES):
        bank, lam = ((shared, shared_lam) if name == "shared"
                     else (hetero, modes[0]))
        span_cases[name] = span_kernel_case(name, bank, lam, n_blocks,
                                            args.seed + i)
    span_launches = phase_span_session(hetero, modes[0], per_block)

    head = span_cases[SPAN_CASES[0][0]]
    kernels = [dict(name="fused_block", launches=per_block["launches"],
                    max_abs_err=prod["max_abs_err"], ms=prod["kernel_ms"],
                    plain_ms=prod["plain_ms"])]
    kernels += [dict(name=k, launches=span_launches[k],
                     max_abs_err=head[k]["max_abs_err"], ms=head[k]["ms"],
                     plain_ms=head[k]["plain_ms"])
                for k in ("chunk_scan", "toeplitz_conv")]
    for k in kernels:
        k.update(route="cuda", source=KERNELS[k["name"]][0],
                 replaces=KERNELS[k["name"]][1])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
