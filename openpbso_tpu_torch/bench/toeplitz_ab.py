"""A/B timing of builds of the Toeplitz-conv kernel on one NVIDIA GPU.

    python -m openpbso_tpu_torch.bench.toeplitz_ab \\
        [--variant NAME=PATH.cu[@VARIANT] ...] [--shapes 1block,4block]
        [--out PATH.json]

Each variant's source (by default this checkout's csrc/toeplitz_conv.cu,
named "conv") is built alone with nvcc for sm_90a into its own library
under openpbso_tpu_torch/_build/ab/ (csrc/ on the include path; a source
named twice is built once)
and called through its C interface: this checkout's takes a variant
(ops/toeplitz_conv.py::variant_for's for the shape, or the one named
after ``@``: v3 or short; a shape the variant cannot take is reported
and not timed), an older one exporting ``toeplitz_conv_blocks`` the
16-byte-copy flag, the oldest neither. At each shape of the span's
callers every variant is held against the plain twin (dB, bitwise
repeatable), then the variants are timed in turns, in the order A B .. B
A, each turn one chain of 100 launches between two CUDA events
(chain_ms); beside them the twin, one ``torch.nn.functional.conv1d`` call
that computes the same function (cuDNN, TF32 off by the port's precision
pin), one ``torch.matmul`` against the materialised Toeplitz operand
(made ahead, at the short shapes) and the bound of bench/roofline.py.
``--shapes`` keeps the shapes whose names hold one of its comma-separated
words. Prints one JSON line per shape and writes all of them to --out.
Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

SHAPES = (   # name, O, L, K, X, C, g: random or the AR impulse response
    ("shared_nb512", 256, 1, 1, 512, 512, "randn"),
    ("hetero_nb1024", 256, 1, 1, 1024, 512, "randn"),
    ("noise_conv", 256, 1, 1, 512, 512, "ar"),
    ("session_16blocks", 256, 1, 1, 16, 512, "randn"),
    # the live stream's short spans: one- and four-block (X = 8 chunks of
    # 64 and 256 samples), a plain stream's K = 1 and a full bucket's 17,
    # a three-block span, a binaural scene's two listener rows, a chunk
    # count past the short variant's eight
    ("span_1block_k1", 256, 1, 1, 8, 64, "randn"),
    ("span_1block_k17", 256, 1, 17, 8, 64, "randn"),
    ("span_4block_k1", 256, 1, 1, 8, 256, "randn"),
    ("span_4block_k17", 256, 1, 17, 8, 256, "randn"),
    ("span_3block", 256, 1, 1, 8, 192, "randn"),
    ("span_1block_k16", 256, 1, 16, 8, 64, "randn"),
    ("span_1block_l2_k17", 256, 2, 17, 8, 64, "randn"),
    ("span_x16_k17_c256", 256, 1, 17, 16, 256, "randn"),
) + tuple((f"span_{n}block_k{k}", 256, 1, k, 8, c, "randn")
          for n, c in ((1, 64), (4, 256)) for k in (2, 3, 5, 8))
RUNS = 30


def build(name: str, src: str) -> str:
    from ..ops import _build
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{name}.so")
    flags = [f for f in _build.COMPILE_FLAGS if f != "-c"]
    proc = subprocess.run([_build.find_nvcc(), *flags, "-I", _build.CSRC,
                           "-shared", "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(f"build {name} ({src}):\n{proc.stdout}{proc.stderr}".strip(),
          flush=True)
    return lib


_BUILT = {}   # source path -> its library (variants forced on one build)


class Variant:
    def __init__(self, name: str, src: str):
        self.name = name
        src, _, self.forced = src.partition("@")
        if src not in _BUILT:
            _BUILT[src] = build(name, src)
        self.lib = ctypes.CDLL(_BUILT[src])
        with open(src) as fh:
            text = fh.read()
        p, i = ctypes.c_void_p, ctypes.c_int
        # this checkout's interface takes a variant; the one before it the
        # 16-byte-copy flag (it exports toeplitz_conv_blocks); the first
        # neither
        self.variants = "int variant" in text
        self.vec4_flag = hasattr(self.lib, "toeplitz_conv_blocks")
        self.lib.toeplitz_conv.argtypes = (
            [p] * 3 + [i] * (5 + self.vec4_flag + self.variants) + [p])
        self.lib.toeplitz_conv.restype = i

    def __call__(self, g, f):
        import torch
        from ..ops import toeplitz_conv as k2
        o, nl, k, c = g.shape
        x = f.shape[2]
        out = torch.empty((o, nl, x, c), dtype=torch.float32, device=g.device)
        ints = [o, nl, k, x, c]
        if self.vec4_flag:
            ints.append(int(c % 4 == 0))
        if self.variants:
            ints.append(k2.VARIANTS.index(
                self.forced or k2.variant_for(o, nl, k, x, c)))
        err = self.lib.toeplitz_conv(g.data_ptr(), f.data_ptr(),
                                     out.data_ptr(), *ints,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")
        return out


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


CHAIN = 100                  # launches in one chain_ms chain
SLEEP_CYCLES = 20_000_000    # ~10 ms of the card's clock: the host's lead


def chain_ms(fn, n=CHAIN) -> float:
    """One call's device time (ms): one chain of ``n`` calls between two
    CUDA events, divided by n. A sleep kernel on the stream first lets the
    host enqueue the whole chain ahead of the card, so the calls run back
    to back and none waits on the host's enqueue, which one event pair a
    call would time along with a short kernel."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def db_error(test, ref) -> float:
    err = float((test.double() - ref.double()).norm())
    if err == 0.0:
        return float("-inf")
    import math
    return 20.0 * math.log10(err / float(ref.double().norm()))


def conv1d_call(g, f):
    """The same function as one cuDNN call: f as [X, O K, C], g flipped as
    [O L, K, C], groups = O, the first C of the 2C - 1 outputs."""
    import torch.nn.functional as F
    o, nl, k, c = g.shape
    x = f.shape[2]
    fin = f.permute(2, 0, 1, 3).reshape(x, o * k, c).contiguous()
    w = g.flip(-1).reshape(o * nl, k, c).contiguous()

    def call():
        return F.conv1d(fin, w, padding=c - 1, groups=o)

    def result():
        return call()[..., :c].reshape(x, o, nl, c).permute(1, 2, 0, 3)
    return call, result


def toeplitz_matmul_call(g, f):
    """The same function as one torch.matmul against the materialised
    Toeplitz operand (made here, ahead of the call): f as [O, 1, X, K C]
    times T [O, L, K C, C], T[o, l, k C + j, c] = g[o, l, k, c - j] for j
    <= c."""
    import torch
    o, nl, k, c = g.shape
    x = f.shape[2]
    idx = torch.arange(c, device=g.device)
    delta = idx[None, :] - idx[:, None]                    # [j, c]: c - j
    t = (g[..., delta.clamp(min=0)] * (delta >= 0)).reshape(o, nl, k * c, c)
    fin = f.permute(0, 2, 1, 3).reshape(o, 1, x, k * c).contiguous()

    def call():
        return torch.matmul(fin, t)
    return call


def inputs(o, nl, k, x, c, kind, seed, dev):
    import torch
    from ..ops.forces import ar_impulse_g
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = torch.randn((o, k, x, c), generator=gen, device=dev)
    if kind == "ar":
        row = torch.as_tensor(ar_impulse_g((0.783, 0.116), c)[:, :c],
                              dtype=torch.float32, device=dev)
        g = row.expand(o * nl * k, c).reshape(o, nl, k, c).contiguous()
    else:
        g = torch.randn((o, nl, k, c), generator=gen, device=dev)
    return g, f


def run_shape(shape, variants, seed, dev) -> dict:
    import torch
    from ..ops.toeplitz_conv import toeplitz_conv_reference, variant_for
    from . import roofline
    name, o, nl, k, x, c, kind = shape
    g, f = inputs(o, nl, k, x, c, kind, seed, dev)
    twin = toeplitz_conv_reference(g, f)
    res = {"shape": name, "O": o, "L": nl, "K": k, "X": x, "C": c, "g": kind,
           "variant": variant_for(o, nl, k, x, c)}
    taken = []
    for v in variants:
        try:
            got, again = v(g, f), v(g, f)
        except RuntimeError as err:   # a forced variant refused the shape
            res[v.name] = {"refused": str(err)}
            continue
        torch.cuda.synchronize()
        res[v.name] = {"bitwise_repeatable": bool(torch.equal(got, again)),
                       "db_vs_twin": db_error(got, twin),
                       "max_abs_err": float((got - twin).abs().max()),
                       "ms_turns": []}
        taken.append(v)
        del got, again
    call, result = conv1d_call(g, f)
    res["library_db_vs_twin"] = db_error(result(), twin)
    short = x <= 16 and c <= 256
    if short:
        mm = toeplitz_matmul_call(g, f)
        res["matmul_db_vs_twin"] = db_error(mm(), twin)
    del twin
    order = taken + taken[::-1]
    for v in order:
        res[v.name]["ms_turns"].append(chain_ms(lambda: v(g, f)))
    for v in taken:
        res[v.name]["ms"] = statistics.fmean(res[v.name]["ms_turns"])
    res["plain_ms"] = time_ms(lambda: toeplitz_conv_reference(g, f), runs=10)
    res["library_ms"] = chain_ms(call)
    if short:
        res["matmul_ms"] = chain_ms(mm)
        del mm
    res["bound"] = roofline.toeplitz_conv(o, nl, k, x, c)
    for v in taken:
        ms = res[v.name]["ms"]
        res[v.name]["tflops"] = res["bound"]["flops"] / ms / 1e9
        res[v.name]["share_fp32_bound"] = res["bound"]["fp32_ms"] / ms
        res[v.name]["share_3xtf32_bound"] = res["bound"]["tf32x3_ms"] / ms
        res[v.name]["share_bound"] = res["bound"]["bound_ms"] / ms
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH.cu[@VARIANT] (default: "
                        "conv=csrc/toeplitz_conv.cu)")
    parser.add_argument("--shapes", default="",
                        help="keep shapes whose names hold one of these "
                        "comma-separated words")
    parser.add_argument("--out", default="chiprun_out/toeplitz_ab.json")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("toeplitz_ab: no CUDA device", file=sys.stderr)
        return 1
    import openpbso_tpu_torch  # noqa: F401  (the precision pin)
    from ..ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    specs = args.variant or [
        f"conv={os.path.join(_build.CSRC, 'toeplitz_conv.cu')}"]
    variants = [Variant(*spec.split("=", 1)) for spec in specs]
    dev = torch.device("cuda")
    results = []
    words = [w for w in args.shapes.split(",") if w]
    for i, shape in enumerate(SHAPES):
        if words and not any(w in shape[0] for w in words):
            continue
        res = run_shape(shape, variants, args.seed + i, dev)
        res["card"] = smi
        print(json.dumps(res), flush=True)
        results.append(res)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
