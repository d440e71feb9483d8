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
   twin (<= -110 dB: both mode contractions are 3xTF32 products on the
   tensor cores) and against the blocked backend (<= -90 dB) for a
   heterogeneous and a shared 256x1024 bank at S=512, a ragged bank and a
   chunk larger than the block; two runs must be bitwise equal; times the
   kernel and the plain twin with CUDA events (median of 30), the kernel's
   device time and the host's enqueue of one step;
4. the per-block path end to end: a ModalSession on a heterogeneous
   256x1024 bank with 1024-mode FFAT maps and per-object listeners renders
   ~2 s of a hit script (point, gaussian and hertz, some future-dated)
   through the fused kernel; checks the output, the kernels' launch counts
   and the blocked backend's render (<= -90 dB), and times synced
   per-block steps;
5. the chunked span: (a) the chunk-scan kernel against its plain twin
   (<= -100 dB) and the Toeplitz-conv kernel against its twin (<= -110
   dB: the 3xTF32 split on the tensor cores), both bitwise repeatable and
   timed with CUDA events (medians), the conv also beside one cuDNN
   conv1d call that computes the same function and against its FP32 and
   3xTF32 bounds, at the span shapes of a shared 256x1024 bank at 512
   blocks and a heterogeneous one at 1024 blocks, with the ms and
   real-time factor of one full span dispatch at each; (b) the phase-4
   session, built with its float64 eigenvalues, renders the same script
   with render_multi (16 blocks per span): checked against phase 4's fused
   render (<= -90 dB) and the kernels' launch counts; each kernel is held
   against its twin on the inputs of the render's first busy (and first
   ring-down) dispatch; and the span dispatches are timed; (c) the conv at
   the span's short chunks: a 3-block span (C = 192) and a one-block span
   with a full slot bucket (C = 64, K = 16, X = 8);
6. the sustained AR(2) channel: (a) the ar_noise kernel against its
   threefry twin (bits bitwise, normals <= -120 dB) at the --sustained
   span shape 256 x 512 blocks x 512 and at 16 blocks across the rebase
   modulo, the ar_block kernel against its twin (bitwise, given the
   kernel's normals) with a quarter of the objects inactive, and
   toeplitz_conv as the AR noise convolution (as in 5a), all bitwise
   repeatable and timed with CUDA events; (b) one sustained span dispatch
   as bench.py --sustained drives it (shared 256x1024, 512 blocks, every
   object dragging, the drag-only bucket, a span-covering AR table), then with
   one object retuned (per-object table); (c) phase 4's session and script
   plus drags on 32 objects (start ~0.2 s, update ~0.6 s, a sigma/mu retune
   ~0.7 s, end ~1.5 s), rendered per block (fused + ar_block) and by
   render_multi (ar_noise, chunk_scan, toeplitz_conv): the two agree to
   <= -60 dB, every kernel of each path launched, and each of ar_noise and
   ar_block held against its twin on the inputs of the first drag dispatch.

Every timed kernel also gets its device time: the torch.profiler duration
of one launch, median over 30 calls (CUDA events time the host's enqueue
as well where it is the longer). The last two lines of stdout are the
kernels' JSON summary (each kernel's launches on its path, error, ms,
device ms, plain and library ms, and its bound from bench/roofline.py at
the timed shape) and {"ok": true, "device": {...}}.
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
SUS_SPAN_BLOCKS = 512        # bench.py --sustained: one span of 512 blocks
DRAGGED = 32                 # objects dragged in phase 6c
DRAG_EVENTS = (16, 48, 64, 128)   # blocks of start, update, retune, end
TOEPLITZ_DB = -110.0         # the 3xTF32 conv against its FP32 twin
FUSED_DB = -110.0            # the 3xTF32 fused step against its FP32 twin
TOEPLITZ_SHAPES = (   # the span's short chunks: label, (O, L, K, X, C)
    ("3-block span", (O, 1, 1, 8, 192)),
    ("one-block span, full slot bucket", (O, 1, 16, 8, 64)),
)
CUDA_NAMES = {   # name -> the CUDA kernel its wrapper launches
    "fused_block": "fused_block_kernel", "chunk_scan": "chunk_scan_kernel",
    "toeplitz_conv": "toeplitz_conv_tc", "ar_noise": "ar_noise_kernel",
    "ar_block": "ar_block_kernel"}
KERNELS = {   # name -> (source, the TPU kernel or XLA stage it replaces)
    "fused_block": ("openpbso_tpu_torch/csrc/fused_block.cu",
                    "openpbso_tpu/ops/pallas_integrator.py:60"),
    "chunk_scan": ("openpbso_tpu_torch/csrc/chunk_scan.cu",
                   "openpbso_tpu/ops/span.py:414"),
    "toeplitz_conv": ("openpbso_tpu_torch/csrc/toeplitz_conv.cu",
                      "openpbso_tpu/ops/span.py:577"),
    "ar_noise": ("openpbso_tpu_torch/csrc/ar_noise.cu",
                 "openpbso_tpu/ops/forces.py:378"),
    "ar_block": ("openpbso_tpu_torch/csrc/ar_block.cu",
                 "openpbso_tpu/ops/forces.py:607"),
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


def kernel_modules() -> dict:
    """kernel name -> the wrapper module holding its LAUNCHES count."""
    from openpbso_tpu_torch.ops import (ar_block, ar_noise, chunk_scan,
                                        fused_integrator, toeplitz_conv)
    return {"fused_block": fused_integrator, "chunk_scan": chunk_scan,
            "toeplitz_conv": toeplitz_conv, "ar_noise": ar_noise,
            "ar_block": ar_block}


def reset_launches():
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


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


def device_ms(fn, kernel, runs=TIMED_RUNS) -> float:
    """Device time (ms) of one launch of the CUDA kernel ``kernel`` that
    ``fn`` makes, from torch.profiler's trace of ``runs`` calls: the median
    duration. The tracer may drop a few records of a long window; raises
    when it holds fewer than half the launches or more than one a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    check(runs // 2 <= len(times) <= runs,
          f"the profiler saw {len(times)} launches of {kernel} in {runs} "
          "calls")
    return statistics.median(times) / 1e3


def enqueue_ms(fn, runs=TIMED_RUNS) -> float:
    """The host's time to enqueue one call (no synchronisation inside)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(runs):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * host / runs


def toeplitz_case(label, g, f, timed=True) -> dict:
    """toeplitz_conv against its twin on (g, f): <= TOEPLITZ_DB and two
    runs bitwise equal; timed beside the twin and one cuDNN conv1d call
    that computes the same function (the yardstick, never called by the
    port), with its achieved TFLOP/s and its shares of the FP32 (CUDA
    cores) and 3xTF32 (tensor cores) bounds of bench/roofline.py."""
    import torch
    from openpbso_tpu_torch.bench import roofline
    from openpbso_tpu_torch.bench.toeplitz_ab import conv1d_call
    from openpbso_tpu_torch.ops import toeplitz_conv as k2
    got, again, plain = (fn(g, f) for fn in (
        k2.toeplitz_conv, k2.toeplitz_conv, k2.toeplitz_conv_reference))
    torch.cuda.synchronize()
    check(torch.equal(got, again),
          f"toeplitz_conv ({label}) differs between two runs")
    check(bool(torch.isfinite(got).all()),
          f"toeplitz_conv ({label}) not finite")
    o, nl, k, c = g.shape
    out = {"case": label, "O": o, "L": nl, "K": k, "X": f.shape[2], "C": c,
           "db_vs_plain": db_error(got.cpu().numpy(), plain.cpu().numpy()),
           "max_abs_err": float((got - plain).abs().max())}
    check(out["db_vs_plain"] <= TOEPLITZ_DB,
          f"toeplitz_conv ({label}) {out['db_vs_plain']} dB vs plain")
    del got, again, plain
    if timed:
        call, _ = conv1d_call(g, f)
        out["ms"] = time_ms(lambda: k2.toeplitz_conv(g, f))
        out["device_ms"] = device_ms(lambda: k2.toeplitz_conv(g, f),
                                     CUDA_NAMES["toeplitz_conv"])
        out["plain_ms"] = time_ms(lambda: k2.toeplitz_conv_reference(g, f))
        out["library_ms"] = time_ms(call)
        bound = roofline.toeplitz_conv(o, nl, k, f.shape[2], c)
        out.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                   tflops=bound["flops"] / out["ms"] / 1e9,
                   share_fp32_bound=bound["fp32_ms"] / out["ms"],
                   share_3xtf32_bound=bound["tf32x3_ms"] / out["ms"],
                   share_bound=bound["bound_ms"] / out["ms"])
    print("toeplitz_conv case:", json.dumps(out), flush=True)
    return out


def phase_toeplitz_shapes(seed, device) -> dict:
    """Phase 5c: toeplitz_conv at the span's short-chunk shapes."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for label, (o, nl, k, x, c) in TOEPLITZ_SHAPES:
        g = torch.randn((o, nl, k, c), generator=gen, device=device)
        f = torch.randn((o, k, x, c), generator=gen, device=device)
        out[label] = toeplitz_case(label, g, f)
    return out


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
        check(out[f"{label}_db_vs_plain"] <= FUSED_DB,
              f"{name}: {label} {out[f'{label}_db_vs_plain']} dB vs plain")
        check(out[f"{label}_db_vs_blocked"] <= -90.0,
              f"{name}: {label} {out[f'{label}_db_vs_blocked']} dB vs "
              f"blocked")
    if timed:
        def step():
            return fi.step_block_fused(*args, chunk=chunk)
        out["kernel_ms"] = time_ms(step)
        out["device_ms"] = device_ms(step, CUDA_NAMES["fused_block"])
        out["enqueue_ms"] = enqueue_ms(step)
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
    check(all(n == 0 for k, n in counts.items() if k != "fused_block"),
          f"the per-block path launched other kernels: {counts}")
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
    got, again, plain = (fn(*scan_args) for fn in (
        k1.chunk_scan, k1.chunk_scan, k1.chunk_scan_reference))
    torch.cuda.synchronize()
    err, dbs = 0.0, []
    for k, a, p in zip(got, again, plain):
        check(torch.equal(k, a), f"{name}: chunk_scan differs between runs")
        check(bool(torch.isfinite(k).all()), f"{name}: chunk_scan not finite")
        err = max(err, float((k - p).abs().max()))
        dbs.append(db_error(k.cpu().numpy(), p.cpu().numpy()))
    check(max(dbs) <= -100.0, f"{name}: chunk_scan {max(dbs)} dB vs plain")
    del got, again, plain
    out["chunk_scan"] = {
        "db_vs_plain": max(dbs), "max_abs_err": err,
        "ms": time_ms(lambda: k1.chunk_scan(*scan_args)),
        "device_ms": device_ms(lambda: k1.chunk_scan(*scan_args),
                               CUDA_NAMES["chunk_scan"]),
        "plain_ms": time_ms(lambda: k1.chunk_scan_reference(*scan_args),
                            runs=10)}
    out["toeplitz_conv"] = toeplitz_case(f"{name} span", *conv_args)
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
    """Each captured dispatch's kernel call against its twin: chunk_scan
    <= -100 dB, toeplitz_conv through toeplitz_case."""
    import torch
    from openpbso_tpu_torch.ops import chunk_scan as k1
    want = {("chunk_scan", "busy"), ("chunk_scan", "decay"),
            ("toeplitz_conv", "busy")}
    check(set(captured) == want, f"captured span calls {sorted(captured)}")
    out = {}
    for (label, kind), args in sorted(captured.items()):
        shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
        if label == "toeplitz_conv":
            out[f"{label}_{kind}"] = dict(
                toeplitz_case(f"{kind} dispatch", *args), shapes=shapes)
            continue
        got, plain = k1.chunk_scan(*args), k1.chunk_scan_reference(*args)
        torch.cuda.synchronize()
        db = max(db_error(k.cpu().numpy(), p.cpu().numpy())
                 for k, p in zip(got, plain))
        check(db <= -100.0, f"{label} ({kind} dispatch) {db} dB vs plain")
        out[f"{label}_{kind}"] = {"db_vs_plain": db, "shapes": shapes}
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
            "toeplitz_conv": busy, "ar_noise": 0, "ar_block": 0}
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


def drag_channel(o, seed, device):
    """A sustained channel: every fourth object inactive and a ringing
    history."""
    import torch
    from openpbso_tpu_torch.ops.forces import make_sustained_state
    st = make_sustained_state(o, M, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    st.active[:] = torch.as_tensor(np.arange(o) % 4 != 3)
    st.ar_hist[:] = torch.as_tensor(rng.standard_normal((o, 2)) * 0.01)
    return st


def noise_case(key, block_start, n_blocks, timed=False) -> dict:
    """ar_noise against its threefry twin: the bits bitwise, the normals
    <= -120 dB, two runs bitwise equal."""
    import torch
    from openpbso_tpu_torch.ops import ar_noise as ka
    idx0, period = ka.block_counter(block_start, S)
    got, again = (ka.ar_noise(key, block_start, n_blocks, S)
                  for _ in range(2))
    bits = ka.ar_noise(key, block_start, n_blocks, S, bits=True)
    plain = ka.ar_noise_reference(key, idx0, n_blocks, period, S)
    bits_equal = torch.equal(bits, ka.ar_noise_reference(
        key, idx0, n_blocks, period, S, bits=True))
    torch.cuda.synchronize()
    label = f"ar_noise {list(got.shape)} from {block_start}"
    check(torch.equal(got, again), f"{label}: differs between two runs")
    check(bits_equal, f"{label}: bits differ from the twin's")
    check(bool(torch.isfinite(got).all()), f"{label}: not finite")
    out = {"shape": list(got.shape), "block_start": block_start,
           "bits_bitwise": bits_equal,
           "normals_bitwise": bool(torch.equal(got, plain)),
           "db_vs_plain": db_error(got.cpu().numpy(), plain.cpu().numpy()),
           "max_abs_err": float((got - plain).abs().max())}
    check(out["db_vs_plain"] <= -120.0,
          f"{label}: normals {out['db_vs_plain']} dB vs plain")
    del got, again, bits, plain
    if timed:
        out["ms"] = time_ms(lambda: ka.ar_noise(key, block_start, n_blocks,
                                                S))
        out["device_ms"] = device_ms(
            lambda: ka.ar_noise(key, block_start, n_blocks, S),
            CUDA_NAMES["ar_noise"])
        out["plain_ms"] = time_ms(lambda: ka.ar_noise_reference(
            key, idx0, n_blocks, period, S), runs=5)
    return out


def block_case(st, block_start, timed=False) -> dict:
    """ar_block against its twin: bitwise given the kernel's own normals,
    <= -100 dB with the twin's, two runs bitwise equal."""
    import torch
    from openpbso_tpu_torch.ops import ar_block as kb
    from openpbso_tpu_torch.ops import ar_noise as ka
    args = (st.key, st.a, st.ar_hist, st.sigma, st.mu, st.active)
    idx, _ = ka.block_counter(block_start, S)
    got, again = (kb.ar_block(*args, block_start, S) for _ in range(2))
    noise = ka.ar_noise(st.key, block_start, 1, S)[:, 0]
    given = kb.ar_block_reference(*args, idx, S, noise=noise)
    own = kb.ar_block_reference(*args, idx, S)
    torch.cuda.synchronize()
    label = f"ar_block from {block_start}"
    dbs = []
    for name, k, a, g, r in zip(("profile", "hist"), got, again, given, own):
        check(torch.equal(k, a), f"{label}: {name} differs between runs")
        check(torch.equal(k, g), f"{label}: {name} differs from the twin "
              "on the kernel's normals")
        check(bool(torch.isfinite(k).all()), f"{label}: {name} not finite")
        dbs.append(db_error(k.cpu().numpy(), r.cpu().numpy()))
    inactive = ~st.active
    check(bool((got[0][inactive] == 0).all())
          and torch.equal(got[1][inactive], st.ar_hist[inactive]),
          f"{label}: inactive objects not left alone")
    check(max(dbs) <= -100.0, f"{label}: {max(dbs)} dB vs the twin")
    out = {"objects": st.key.shape[0],
           "active": int(st.active.sum()), "block_start": block_start,
           "bitwise_vs_plain_given_normals": True,
           "db_vs_plain_own_normals": max(dbs),
           "max_abs_err": max(float((k - g).abs().max())
                              for k, g in zip(got, given))}
    if timed:
        def step():
            return kb.ar_block(*args, block_start, S)
        out["ms"] = time_ms(step)
        out["device_ms"] = device_ms(step, CUDA_NAMES["ar_block"])
        out["enqueue_ms"] = enqueue_ms(step)
        out["plain_ms"] = time_ms(lambda: kb.ar_block_reference(
            *args, idx, S), runs=5)
    return out


def phase_ar_kernels(seed, device) -> dict:
    """Phase 6a: the two AR kernels and the noise-conv use of
    toeplitz_conv against their twins at the shapes the channel gives
    them."""
    import torch
    from openpbso_tpu_torch.config import REBASE_PERIOD
    from openpbso_tpu_torch.ops import ar_noise as ka
    from openpbso_tpu_torch.ops.forces import ar_impulse_g
    st = drag_channel(O, seed, device)
    out = {"ar_noise": noise_case(st.key, 0, SUS_SPAN_BLOCKS, timed=True),
           "ar_noise_wrap": noise_case(st.key, REBASE_PERIOD - 8 * S, 16),
           "ar_block": block_case(st, 3 * S, timed=True),
           "ar_block_wrap": block_case(st, REBASE_PERIOD + 5 * S)}
    # the noise convolution of sustained_span: K = 1, C = S, X = 512
    g = torch.as_tensor(ar_impulse_g((0.783, 0.116), S)[:, :S],
                        dtype=torch.float32, device=st.key.device)
    args = (g.expand(O, S)[:, None, None, :],
            ka.ar_noise(st.key, 0, SUS_SPAN_BLOCKS, S)[:, None])
    out["toeplitz_conv_noise"] = toeplitz_case("AR noise conv", *args)
    print("ar kernels:", json.dumps(out), flush=True)
    return out


def phase_sustained_span(bank, lam64, seed) -> dict:
    """Phase 6b: one sustained span dispatch as bench.py --sustained drives
    it (bench.py:159-176): every object dragging, the drag-only bucket, a
    span-covering shared AR table (grp 512); then one object retuned, a
    per-object table capped at 32 blocks."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops.forces import FORCE_GAUSSIAN, ar_impulse_g
    from openpbso_tpu_torch.ops.span import build_span_tables
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import default_gains, step_span
    from openpbso_tpu_torch.runtime.state import make_solver_state
    dev, m, n_blocks = bank.device, bank.num_modes, SUS_SPAN_BLOCKS
    tables = build_span_tables(lam64, n_blocks * S, num_modes=m, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = make_solver_state(O, m, num_slots=8, seed=seed, device=dev)
    state.slots.ftype[:, 0] = FORCE_GAUSSIAN
    state.slots.width[:, 0] = 40.0
    state.slots.space[:, 0] = torch.randn((O, m), generator=gen, device=dev)
    state.sustained.active[:] = True
    state.sustained.space[:] = torch.randn((O, m), generator=gen, device=dev)
    gains = default_gains(O, device=dev)
    a = np.tile([[0.783, 0.116]], (O, 1))
    out = {"O": O, "M": m, "n_blocks": n_blocks, "chunk": tables.chunk}
    for case in ("shared", "per_object"):
        if case == "per_object":
            a[7] = (0.9, 0.05)
            state.sustained.a[7] = torch.tensor(a[7], device=dev)
        shared = case == "shared"
        grp = (ModalSession.AR_GROUP_CAP_SHARED if shared
               else ModalSession.AR_GROUP_CAP_PER_OBJECT)
        ar_g = torch.as_tensor(ar_impulse_g(a[:1] if shared else a, grp * S),
                               dtype=torch.float32, device=dev)
        st, spans = state, []
        for i in range(7):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            st, mix = step_span(st, bank, tables, gains, n_blocks=n_blocks,
                                block_size=S, num_slots=0,
                                with_sustained=True, ar_g=ar_g)
            t1.record()
            spans.append((t0, t1))
            if i == 0:
                check(bool(torch.isfinite(mix).all())
                      and float(mix.abs().max()) > 0,
                      f"sustained span ({case}): mix")
        torch.cuda.synchronize()
        ms = statistics.median(t0.elapsed_time(t1) for t0, t1 in spans[2:])
        out[case] = {"ar_table": list(ar_g.shape), "group": grp,
                     "span_ms": ms,
                     "span_rtf": n_blocks * S / SAMPLE_RATE / (ms / 1e3)}
    print("sustained span:", json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def capture_ar_kernel_inputs():
    """While open, keep a copy of the arguments of the first ar_noise and
    ar_block calls the forces module makes."""
    import torch
    from openpbso_tpu_torch.ops import forces as forces_mod
    captured = {}

    def capturing(fn, label):
        def call(*args):
            if label not in captured:
                captured[label] = [a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in args]
            return fn(*args)
        return call
    originals = forces_mod.ar_noise, forces_mod.ar_block
    forces_mod.ar_noise = capturing(originals[0], "ar_noise")
    forces_mod.ar_block = capturing(originals[1], "ar_block")
    try:
        yield captured
    finally:
        forces_mod.ar_noise, forces_mod.ar_block = originals


def phase_sustained_session(bank, lam64, per_block) -> dict:
    """Phase 6c: phase 4's session and hit script plus drags, rendered per
    block and by span; returns the launch counts of each path."""
    import torch
    from openpbso_tpu_torch.config import SAMPLE_RATE
    from openpbso_tpu_torch.ops import ar_block as kb
    from openpbso_tpu_torch.ops import ar_noise as ka
    ffat, listeners, hits = (per_block[k] for k in ("ffat", "listeners",
                                                    "hits"))
    rng = np.random.default_rng(7)
    dragged = list(range(1, O, O // DRAGGED))[:DRAGGED]
    starts = rng.standard_normal((DRAGGED, M))
    updates = rng.standard_normal((DRAGGED, M))
    start_b, update_b, retune_b, end_b = DRAG_EVENTS
    segments = (start_b, update_b - start_b, retune_b - update_b,
                end_b - retune_b, RENDER_BLOCKS - end_b)

    def run(sess, render):
        out, seconds = [], []
        events = (
            lambda: [sess.sustained_start(o, v)
                     for o, v in zip(dragged, starts)],
            lambda: [sess.sustained_update(o, v)
                     for o, v in zip(dragged, updates)],
            lambda: sess.set_ar_params(dragged[0], sigma=0.003, mu=0.1),
            lambda: [sess.sustained_end(o) for o in dragged],
            lambda: None)
        for n, event in zip(segments, events):
            t = time.perf_counter()
            out.append(render(n))
            seconds.append(time.perf_counter() - t)
            event()
        return np.concatenate(out), seconds

    result = {"dragged": DRAGGED, "events_at_blocks": list(DRAG_EVENTS)}
    sess = new_session(bank, ffat, listeners, hits, "auto")
    with capture_ar_kernel_inputs() as block_inputs:
        reset_launches()
        block_mix, block_s = run(sess, sess.render)
        block_counts = read_launches()
    span_sess = new_session(bank, ffat, listeners, hits, "auto",
                            lam64=lam64)
    t = time.perf_counter()
    span_sess.span_tables_for(SPAN_DISPATCH)
    result["table_build_s"] = time.perf_counter() - t
    with capture_ar_kernel_inputs() as span_inputs:
        reset_launches()
        span_mix, span_s = run(span_sess, lambda n: span_sess.render_multi(
            n, blocks_per_dispatch=SPAN_DISPATCH))
        span_counts = read_launches()

    # expected launches, from the hit script's expiry and the drag blocks
    drag = [start_b <= b < end_b for b in range(RENDER_BLOCKS)]
    busy = [b * S < per_block["last_expiry"] or drag[b]
            for b in range(RENDER_BLOCKS)]
    check(block_counts == {"fused_block": sum(busy), "ar_block": sum(drag),
                           "ar_noise": 0, "chunk_scan": 0,
                           "toeplitz_conv": 0},
          f"per-block launches {block_counts}")
    dispatches = [b0 + d for b0, n in zip((0,) + DRAG_EVENTS, segments)
                  for d in range(0, n, SPAN_DISPATCH)]
    want = {"fused_block": 0, "ar_block": 0,
            "ar_noise": sum(drag[b] for b in dispatches),
            "chunk_scan": len(dispatches),
            "toeplitz_conv": sum(busy[b] + drag[b] for b in dispatches)}
    check(span_counts == want, f"span launches {span_counts} != {want}")
    for label, mix in (("per-block", block_mix), ("span", span_mix)):
        check(mix.shape == (RENDER_BLOCKS * S, 2)
              and bool(np.isfinite(mix).all())
              and float(np.abs(mix).max()) > 0,
              f"{label} drag mix not finite or silent")
    result["db_span_vs_per_block"] = db_error(span_mix, block_mix)
    print(f"sustained session: span vs per-block render "
          f"{result['db_span_vs_per_block']} dB", flush=True)
    check(result["db_span_vs_per_block"] <= -60.0,
          f"span render {result['db_span_vs_per_block']} dB vs per-block")
    drag_blocks = end_b - start_b
    drag_s = sum(block_s[1:4])
    result.update(
        launches_per_block=block_counts, launches_span=span_counts,
        drag_block_ms_mean=1e3 * drag_s / drag_blocks,
        drag_span_ms_mean=1e3 * sum(span_s[1:4]) / want["ar_noise"],
        per_block_rtf=RENDER_BLOCKS * S / SAMPLE_RATE / sum(block_s),
        span_rtf=RENDER_BLOCKS * S / SAMPLE_RATE / sum(span_s))

    # each kernel against its twin on the first drag dispatch's inputs
    key, start, n_blocks, s = span_inputs["ar_noise"]
    result["ar_noise_first_drag_span"] = noise_case(key, start, n_blocks)
    args = block_inputs["ar_block"]
    idx, _ = ka.block_counter(args[6], S)
    got = kb.ar_block(*args)
    given = kb.ar_block_reference(*args[:6], idx, S,
                                  noise=ka.ar_noise(args[0], args[6], 1,
                                                    S)[:, 0])
    torch.cuda.synchronize()
    check(all(torch.equal(k, g) for k, g in zip(got, given)),
          "ar_block differs from its twin on the first drag block")
    result["ar_block_first_drag_block"] = {"bitwise_vs_plain": True,
                                           "block_start": args[6]}
    print("sustained session:", json.dumps(result), flush=True)
    return {"block": block_counts, "span": span_counts}


def kernel_bounds(hetero_modes_padded, shared_modes_padded, n_chunks,
                  chunk):
    """Each kernel's bound (bench/roofline.py) at the shape its JSON entry
    was timed at: fused_block phase 3's hetero block, chunk_scan and
    toeplitz_conv the shared nb=512 span, ar_noise [O, 512, S] and ar_block
    O objects. The AR kernels' operations are the instructions per sample
    of ar_noise's main loop in the built library's SASS
    (bench/sass_count.py), at the card's maximum SM clock."""
    from openpbso_tpu_torch.bench import roofline, sass_count
    from openpbso_tpu_torch.ops import _build
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    clock_hz = float(clock) * 1e6
    per_sample = sass_count.count(_build.library_path(),
                                  "ar_noise_kernelILb0E")["by_class_per_item"]
    out = {
        "fused_block": roofline.fused_block(O, O, hetero_modes_padded, S,
                                            CHUNK),
        "chunk_scan": roofline.chunk_scan(O, 1, n_chunks,
                                          shared_modes_padded, True),
        "toeplitz_conv": roofline.toeplitz_conv(O, 1, 1, n_chunks, chunk),
        "ar_noise": roofline.ar_noise(O, SUS_SPAN_BLOCKS, S, per_sample,
                                      clock_hz),
        "ar_block": roofline.ar_block(O, S, per_sample, clock_hz),
    }
    print("kernel bounds:", json.dumps(dict(
        out, sm_clock_hz=clock_hz, ar_noise_sass_per_sample=per_sample)),
          flush=True)
    return out


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
    hetero = hetero_bank(O, M, S, None, modes)   # the builders' default
    check(hetero.device.type == "cuda",
          f"a bank built without device= is on {hetero.device}")
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
    phase_toeplitz_shapes(args.seed, dev)

    ar = phase_ar_kernels(args.seed, dev)
    phase_sustained_span(shared, shared_lam, args.seed)
    drag_launches = phase_sustained_session(hetero, modes[0], per_block)

    head = span_cases[SPAN_CASES[0][0]]
    bounds = kernel_bounds(hetero.num_modes, shared.num_modes,
                           head["n_chunks"], head["chunk"])
    kernels = [dict(name="fused_block", launches=per_block["launches"],
                    max_abs_err=prod["max_abs_err"], ms=prod["kernel_ms"],
                    device_ms=prod["device_ms"], plain_ms=prod["plain_ms"],
                    library_ms=None)]
    kernels += [dict(name=k, launches=span_launches[k],
                     max_abs_err=head[k]["max_abs_err"], ms=head[k]["ms"],
                     device_ms=head[k]["device_ms"],
                     plain_ms=head[k]["plain_ms"],
                     library_ms=head[k].get("library_ms"))
                for k in ("chunk_scan", "toeplitz_conv")]
    kernels += [dict(name=k, launches=drag_launches[path][k],
                     max_abs_err=ar[k]["max_abs_err"], ms=ar[k]["ms"],
                     device_ms=ar[k]["device_ms"],
                     plain_ms=ar[k]["plain_ms"], library_ms=None)
                for k, path in (("ar_noise", "span"), ("ar_block", "block"))]
    for k in kernels:
        k.update(route="cuda", source=KERNELS[k["name"]][0],
                 replaces=KERNELS[k["name"]][1],
                 bound_ms=bounds[k["name"]]["bound_ms"],
                 bound_by=bounds[k["name"]]["bound_by"])
    print("device time: " + ", ".join(
        f"{k['name']} {k['device_ms']} ms (events {k['ms']} ms)"
        for k in kernels), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
