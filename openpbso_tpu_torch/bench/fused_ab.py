"""A/B timing of builds of the per-block path's kernels on one NVIDIA GPU:
the fused block step and the AR block.

    python -m openpbso_tpu_torch.bench.fused_ab \\
        [--variant NAME=PATH.cu ...] [--ar-variant NAME=PATH.cu ...] \\
        [--out chiprun_out/fused_ab.json]

Each variant's source (by default this checkout's csrc/fused_block.cu,
named "v5") is built alone with nvcc for sm_90a into its own library under
openpbso_tpu_torch/_build/ab/ and called through its C interface: a library
that exports ``fused_block_row_floats`` takes tile-major tables and no
scratch (one clustered launch); an older one (v4b, two launches) takes the
[Og, C+1, M] tables and the [O, T, S] and [O, T, C] scratch it reduces in
its second launch. At each
shape of the per-block path (256 objects x 1024 modes, S = 512, C = 64,
heterogeneous and shared tables) every variant is held against the plain
twin (dB, bitwise repeatable), then the variants are timed in turns, in
the order A B .. B A: each turn the median of 30 CUDA-event-timed calls
(outputs allocated per call, as the wrapper does) and the device time of
one call from torch.profiler's trace (the sum over the variant's kernels
of each one's median). Beside them the twin and the bound of
bench/roofline.py. Then the same for each --ar-variant (default: this
checkout's csrc/ar_block.cu, "v2"; a source beside a copy of
csrc/threefry.cuh) at the AR block of 256 objects, S = 512, a quarter of
them inactive: bitwise against the twin given the normals, events,
device time and the host's enqueue. Prints one JSON line per shape and
writes all of them to --out. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

SHAPES = (   # name, objects, modes, block, chunk, heterogeneous
    ("hetero", 256, 1024, 512, 64, True),
    ("shared", 256, 1024, 512, 64, False),
)
RUNS = 30
TILE = 128   # modes per block of both designs at these shapes


def build(name: str, src: str) -> str:
    from ..ops import _build
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{name}.so")
    flags = [f for f in _build.COMPILE_FLAGS if f != "-c"]
    proc = subprocess.run([_build.find_nvcc(), *flags, "-shared", "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(f"build {name} ({src}):\n{proc.stdout}{proc.stderr}".strip(),
          flush=True)
    return lib


class Variant:
    def __init__(self, name: str, src: str):
        self.name = name
        self.lib = ctypes.CDLL(build(f"fused_{name}", src))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.clustered = hasattr(self.lib, "fused_block_row_floats")
        self.lib.fused_block_step.argtypes = (
            [p, p, ll, i] + [p] * 11 + [i] * 5 + [p] if self.clustered
            else [p, p, ll] + [p] * 13 + [i] * 5 + [p])
        self.lib.fused_block_step.restype = i

    def __call__(self, z_re, z_im, bank, space, f, transfer, chunk):
        import torch
        o, m = z_re.shape
        s = f.shape[-1]
        if self.clustered:
            from ..ops.fused_integrator import _kernel_tables
            tr, ti = _kernel_tables(bank, chunk, TILE,
                                    self.lib.fused_block_row_floats(TILE))
        else:
            tr, ti = bank.chunk_tables(chunk)
        stride = 0 if tr.shape[0] == 1 else tr.stride(0)
        b_re, b_im, mask = bank.b_re, bank.b_im, bank.mask
        z_re_out, z_im_out = torch.empty_like(z_re), torch.empty_like(z_im)
        sound = torch.empty_like(f)
        rows = [b_re, b_im, space, transfer, mask, z_re, z_im, f, z_re_out,
                z_im_out, sound]
        ptrs = [x.data_ptr() for x in rows]
        stream = torch.cuda.current_stream().cuda_stream
        if self.clustered:
            err = self.lib.fused_block_step(
                tr.data_ptr(), ti.data_ptr(), stride, tr.shape[1], *ptrs,
                o, m, s, chunk, TILE, stream)
        else:
            tiles = -(-m // TILE)
            hom = torch.empty((o, tiles, s), device=z_re.device)
            g = torch.empty((o, tiles, chunk), device=z_re.device)
            err = self.lib.fused_block_step(
                tr.data_ptr(), ti.data_ptr(), stride, *ptrs,
                hom.data_ptr(), g.data_ptr(), o, m, s, chunk, TILE, stream)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")
        return z_re_out, z_im_out, sound


class ARVariant:
    def __init__(self, name: str, src: str):
        self.name = name
        self.lib = ctypes.CDLL(build(f"ar_block_{name}", src))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.lib.ar_block.argtypes = [p] * 6 + [ll, p, p, i, i, p]
        self.lib.ar_block.restype = i

    def __call__(self, key, a, hist, sigma, mu, active, block_index, s):
        import torch
        o = key.shape[0]
        profile = torch.empty((o, s), device=key.device)
        hist_out = torch.empty_like(hist)
        err = self.lib.ar_block(
            key.data_ptr(), a.data_ptr(), hist.data_ptr(), sigma.data_ptr(),
            mu.data_ptr(), active.data_ptr(), block_index,
            profile.data_ptr(), hist_out.data_ptr(), o, s,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")
        return profile, hist_out


def time_ms(fn, runs=RUNS) -> float:
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


def device_ms(fn, runs=RUNS) -> float:
    """Device time of one call from torch.profiler: for each CUDA kernel
    the calls launched, its median duration times its launches per call,
    summed."""
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
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        raise RuntimeError("the profiler recorded no CUDA kernel")
    return sum(statistics.median(t) * len(t) / runs
               for t in by_name.values()) / 1e3


def db_error(test, ref) -> float:
    err = float((test.double() - ref.double()).norm())
    if err == 0.0:
        return float("-inf")
    import math
    return 20.0 * math.log10(err / float(ref.double().norm()))


def inputs(o, n, s, hetero, seed, dev):
    """A bank as chip_smoke.py builds it and the block inputs of its
    phase 3, from a seed."""
    import torch
    from ..ops.coeffs import build_modal_bank, lambda_from_modes
    from ..utils.synth import CERAMIC, synth_mode_data
    offsets = range(o) if hetero else [0] * o
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in offsets]
    lam, b, v = (np.stack(x) for x in zip(*parts))
    bank = build_modal_bank(lam, b, v, block_size=s, device=dev)
    rng = np.random.default_rng(seed)
    m = bank.num_modes
    mask = bank.mask.cpu().numpy()
    arrays = [rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, s)),
              rng.uniform(0.5, 2.0, (o, m))]
    zr, zi, sp, f, tr = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                         for x in arrays)
    return bank, (zr, zi, bank, sp, f, tr)


def run_shape(shape, variants, seed, dev) -> dict:
    import torch
    from ..ops.fused_integrator import fused_block_reference
    from . import roofline
    name, o, n, s, chunk, hetero = shape
    bank, args = inputs(o, n, s, hetero, seed, dev)
    twin = fused_block_reference(*args, chunk=chunk)
    res = {"shape": name, "O": o, "M": bank.num_modes, "S": s, "C": chunk}
    for v in variants:
        got, again = v(*args, chunk), v(*args, chunk)
        torch.cuda.synchronize()
        res[v.name] = {
            "bitwise_repeatable": all(torch.equal(a, b)
                                      for a, b in zip(got, again)),
            "db_vs_twin": max(db_error(a, t) for a, t in zip(got, twin)),
            "max_abs_err": max(float((a - t).abs().max())
                               for a, t in zip(got, twin)),
            "ms_turns": [], "device_ms_turns": []}
        del got, again
    del twin
    for v in variants + variants[::-1]:
        res[v.name]["ms_turns"].append(time_ms(lambda: v(*args, chunk)))
        res[v.name]["device_ms_turns"].append(
            device_ms(lambda: v(*args, chunk)))
    res["plain_ms"] = time_ms(lambda: fused_block_reference(
        *args, chunk=chunk), runs=10)
    og = bank.pow_re.shape[0]
    res["bound"] = roofline.fused_block(o, og, bank.num_modes, s, chunk)
    for v in variants:
        r = res[v.name]
        r["ms"] = statistics.fmean(r["ms_turns"])
        r["device_ms"] = statistics.fmean(r["device_ms_turns"])
        r["share_bound"] = res["bound"]["bound_ms"] / r["device_ms"]
    return res


def enqueue_ms(fn, runs=RUNS) -> float:
    """The host's time to enqueue one call (no synchronisation inside)."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(runs):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * host / runs


def run_ar_block(variants, seed, dev, o=256, s=512) -> dict:
    import torch
    from ..ops import ar_noise as ka
    from ..ops.ar_block import ar_block_reference
    from ..ops.forces import make_sustained_state
    from . import roofline, sass_count
    from ..ops import _build
    st = make_sustained_state(o, 8, seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    st.active[:] = torch.as_tensor(np.arange(o) % 4 != 3)
    st.ar_hist[:] = torch.as_tensor(rng.standard_normal((o, 2)) * 0.01)
    args = (st.key, st.a, st.ar_hist, st.sigma, st.mu, st.active)
    start = 3 * s
    idx, _ = ka.block_counter(start, s)
    given = ar_block_reference(*args, idx, s,
                               noise=ka.ar_noise(st.key, start, 1, s)[:, 0])
    res = {"shape": "ar_block", "O": o, "S": s}
    for v in variants:
        got, again = v(*args, idx, s), v(*args, idx, s)
        torch.cuda.synchronize()
        res[v.name] = {
            "bitwise_vs_twin": all(torch.equal(a, g)
                                   for a, g in zip(got, given)),
            "bitwise_repeatable": all(torch.equal(a, b)
                                      for a, b in zip(got, again)),
            "ms_turns": [], "device_ms_turns": [], "enqueue_ms_turns": []}
    for v in variants + variants[::-1]:
        def call(v=v):
            return v(*args, idx, s)
        res[v.name]["ms_turns"].append(time_ms(call))
        res[v.name]["device_ms_turns"].append(device_ms(call))
        res[v.name]["enqueue_ms_turns"].append(enqueue_ms(call))
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    per_sample = sass_count.count(_build.library_path(),
                                  "ar_noise_kernelILb0E")["by_class_per_item"]
    res["bound"] = roofline.ar_block(o, s, per_sample, clock)
    for v in variants:
        r = res[v.name]
        for key in ("ms", "device_ms", "enqueue_ms"):
            r[key] = statistics.fmean(r[key + "_turns"])
        r["share_bound"] = res["bound"]["bound_ms"] / r["device_ms"]
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH.cu (default: v5=csrc/fused_block.cu)")
    parser.add_argument("--ar-variant", action="append", default=[],
                        help="NAME=PATH.cu (default: v2=csrc/ar_block.cu)")
    parser.add_argument("--shape", action="append", default=[],
                        choices=[sh[0] for sh in SHAPES],
                        help="time only these fused shapes (default: all)")
    parser.add_argument("--skip-ar", action="store_true",
                        help="leave out the AR block")
    parser.add_argument("--out", default="chiprun_out/fused_ab.json")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fused_ab: no CUDA device", file=sys.stderr)
        return 1
    import openpbso_tpu_torch  # noqa: F401  (the precision pin)
    from ..ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    specs = args.variant or [
        f"v5={os.path.join(_build.CSRC, 'fused_block.cu')}"]
    variants = [Variant(*spec.split("=", 1)) for spec in specs]
    dev = torch.device("cuda")
    results = []
    for i, shape in enumerate(SHAPES):
        if args.shape and shape[0] not in args.shape:
            continue
        res = run_shape(shape, variants, args.seed + i, dev)
        res["card"] = smi
        print(json.dumps(res), flush=True)
        results.append(res)
        torch.cuda.empty_cache()
    ar_specs = args.ar_variant or [
        f"v2={os.path.join(_build.CSRC, 'ar_block.cu')}"]
    if not args.skip_ar:
        _build.load()   # the checkout's ar_noise draws the twin's normals
        res = run_ar_block([ARVariant(*spec.split("=", 1))
                            for spec in ar_specs], args.seed, dev)
        res["card"] = smi
        print(json.dumps(res), flush=True)
        results.append(res)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
