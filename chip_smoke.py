#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openpbso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. environment: a CUDA device is required (there is no CPU fallback);
   prints the card's name and power limit, torch and CUDA versions;
2. build: compiles csrc/fused_block.cu for sm_90a from this checkout into
   openpbso_tpu_torch/_build/ and prints the build time;
3. kernel vs plain: step_block_fused on the card against its plain PyTorch
   twin (<= -100 dB) and against the blocked backend (<= -90 dB) for a
   heterogeneous and a shared 256x1024 bank at S=512, a ragged bank and a
   chunk larger than the block; two runs must be bitwise equal; times the
   kernel and the plain twin with CUDA events (median of 30);
4. the slice end to end: a ModalSession on a heterogeneous 256x1024 bank
   with 1024-mode FFAT maps and per-object listeners renders ~2 s of a hit
   script (point, gaussian and hertz, some future-dated) through the fused
   kernel; checks the output, the kernel's launch count and the blocked
   backend's render (<= -90 dB), and times synced per-block steps.

The last two lines of stdout are the kernels' JSON summary and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

O, M, S, CHUNK = 256, 1024, 512, 64
RENDER_BLOCKS = 172          # ~2 s of audio at 44.1 kHz
LAST_HIT_BLOCK = 86          # no hit later than ~1 s
TIMED_RUNS = 30
KERNEL_SOURCE = "openpbso_tpu_torch/csrc/fused_block.cu"
KERNEL_REPLACES = "openpbso_tpu/ops/pallas_integrator.py:60"


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


def hetero_bank(o, n_modes, s, device):
    """Per-object mode sets, as bench.py --hetero builds them."""
    from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data
    from openpbso_tpu_torch.ops.coeffs import (build_modal_bank,
                                               lambda_from_modes)
    lams, bs, valids = [], [], []
    for i in range(o):
        md = synth_mode_data(n_modes, 8, seed=100 + i, f_low=100.0 + i,
                             f_high=15000.0 + 3 * i)
        lam, b, valid = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                          CERAMIC.alpha, CERAMIC.beta)
        lams.append(lam)
        bs.append(b)
        valids.append(valid)
    return build_modal_bank(np.stack(lams), np.stack(bs), np.stack(valids),
                            block_size=s, shared=False, device=device)


def shared_bank(o, n_modes, s, device):
    from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data
    from openpbso_tpu_torch.ops.coeffs import bank_from_material
    md = synth_mode_data(n_modes, 8, seed=0)
    return bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                              block_size=s, device=device)


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


def new_session(bank, ffat, listeners, hits, backend):
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig
    sess = ModalSession(bank, ffat, SolverConfig(block_size=S,
                                                 backend=backend))
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
    fi.LAUNCHES = 0
    mix = sess.render(RENDER_BLOCKS)
    launches = fi.LAUNCHES
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
    return launches


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
    hetero = hetero_bank(O, M, S, dev)
    print(f"hetero bank {O}x{hetero.num_modes}: "
          f"{time.perf_counter() - t} s", flush=True)
    prod = kernel_case("hetero", hetero, S, CHUNK, rng, timed=True)
    kernel_case("shared", shared_bank(O, M, S, dev), S, CHUNK, rng,
                timed=True)
    kernel_case("ragged", hetero_bank(5, 40, 256, dev), 256, CHUNK, rng)
    kernel_case("chunk>S", hetero_bank(3, 24, 32, dev), 32, CHUNK, rng)

    launches = phase_session(hetero, rng)

    print(json.dumps({"kernels": [{
        "name": "fused_block", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": prod["max_abs_err"], "ms": prod["kernel_ms"],
        "plain_ms": prod["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
