"""A/B timing of builds of the span's contraction kernels on one NVIDIA GPU.

    python -m openpbso_tpu_torch.bench.span_ab \\
        [--variant NAME=PATH.cu[@VARIANT] ...] [--restarts 4,8,16]
        [--shapes 1block,4block] [--out span_ab.json]

Each variant's source (by default this checkout's csrc/span_inject.cu and
csrc/span_reduce.cu, named "inject" and "reduce") is built alone with nvcc
for sm_90a (csrc/ on the include path) into its own library under
openpbso_tpu_torch/_build/ab/ and called through its own C interface: a
library that exports ``span_inject`` is timed at the injection shapes, one
that exports ``span_reduce`` at the reduction shapes. A source that takes
the table's planes (this checkout's: ops/span.py::span_planes, made once a
shape, and the variant that ops/span_*.py::variant_for picks for the
shape, or the one named after ``@``: mma16, mma64, wgmma, stacked for
span_inject, mma16, mma64, wgmma, fp32, split, cluster for span_reduce;
a source without the named variant refuses it) is called
with them; an older one (the first version's, which reads the table
alone) without. At each shape every variant is held against the plain
twin (dB, bitwise repeatable; a variant that cannot take the shape is
reported and not timed), then the variants of that kernel are timed in
turns, in the order A B .. B A, each turn one chain of 100 launches
between two CUDA events (toeplitz_ab.chain_ms), beside the bound of
bench/roofline.py. ``--shapes`` keeps the shapes whose names hold one of
its comma-separated words.
``--restarts`` also gives, for each variant that takes the planes, its dB
at each of those restart intervals (k8 steps; ops/span_*.py::RESTART_K8).
Prints one JSON line per shape and writes all of them to --out. Fails
without a CUDA device.

Compare the first version with this one:

    git show 99d047a:openpbso_tpu_torch/csrc/span_inject.cu \
        > _scratch/ab/v1_inject.cu
    python -m openpbso_tpu_torch.bench.span_ab \\
        --variant v1=_scratch/ab/v1_inject.cu \\
        --variant v2=openpbso_tpu_torch/csrc/span_inject.cu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

from .toeplitz_ab import chain_ms, db_error

# name, O, Og (1: shared), K, X (rows: chunks), C
INJECT_SHAPES = (
    ("shared_nb512", 256, 1, 1, 512, 512),
    ("hetero_nb1024", 256, 256, 1, 1024, 512),
    ("hetero_nb16", 256, 256, 1, 16, 512),
    ("shared_nb16", 256, 1, 1, 16, 512),
    ("span_1block_k17", 256, 256, 17, 8, 64),
    ("hetero_nb16_k4", 256, 256, 4, 16, 512),
    ("span_4block_k17", 256, 256, 17, 8, 256),
    ("span_1block_k2", 256, 256, 2, 8, 64),
    ("span_1block_k3", 256, 256, 3, 8, 64),
    ("span_1block_k5", 256, 256, 5, 8, 64),
)
REDUCE_SHAPES = (   # name, O, Og, L, R, C, add, complex rows
    ("hom_shared_nb512", 256, 1, 1, 512, 512, True, False),
    ("hom_hetero_nb1024", 256, 256, 1, 1024, 512, True, False),
    ("hom_hetero_nb16", 256, 256, 1, 16, 512, True, False),
    ("g_hetero", 256, 256, 1, 1, 512, False, False),
    ("g_1block_k17", 256, 256, 1, 17, 64, False, False),
    ("g_4block_k17", 256, 256, 1, 17, 256, False, False),
    ("hom_1block", 256, 256, 1, 8, 64, True, False),
    ("hom_4block", 256, 256, 1, 8, 256, True, False),
    ("g_1block_k5", 256, 256, 1, 5, 64, False, False),
    # a shared table's g at the span's chunks (C), slots (K) and listener
    # rows (L = 1 real, L = 2 complex: the binaural ITD scene's), and its
    # hom at the short spans' X chunks
) + tuple((f"gs_c{c}_k{k}_l{nl}", 256, 1, nl, k, c, False, nl == 2)
          for c in (64, 256, 512) for k in (1, 17) for nl in (1, 2)) + (
    ("homs_c64_x8", 256, 1, 1, 8, 64, True, False),
    ("homs_c256_x8", 256, 1, 1, 8, 256, True, False),
    ("homs_c512_x16_l2", 256, 1, 2, 16, 512, True, True),
)
M = 1024


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
            self.planes = "lo_re" in fh.read()   # this version's interface
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.kind = "inject" if hasattr(self.lib, "span_inject") else "reduce"
        if self.kind == "inject":
            self.lib.span_inject.argtypes = (
                [p] * 9 + [ll] + [p] * 2 + [i] * 9 + [p] if self.planes
                else [p] * 5 + [ll] + [p] * 2 + [i] * 7 + [p])
            self.lib.span_inject.restype = i
        else:
            self.lib.span_reduce.argtypes = (
                [p] * 8 + [ll] + [p] * 2 + [i] * 10 + [p] if self.planes
                else [p] * 6 + [ll] + [p] * 2 + [i] * 8 + [p])
            self.lib.span_reduce.restype = i

    def __call__(self, args, planes):
        import torch
        from ..ops import span_inject as k3
        from ..ops import span_reduce as k4
        stream = torch.cuda.current_stream().cuda_stream
        if self.kind == "inject":
            f, be_re, be_im, b_re, b_im = args
            o, k, n = f.shape
            c = b_re.shape[1] - 1
            out = [torch.empty((o, n // c, M), device=f.device)
                   for _ in range(2)]
            stride = 0 if b_re.shape[0] == 1 else b_re.stride(0)
            head = [f.data_ptr(), be_re.data_ptr(), be_im.data_ptr(),
                    b_re.data_ptr(), b_im.data_ptr()]
            tail = [o, k, n // c, c, M, 1, 1]
            if self.planes:
                v = self.forced or k3.variant_for(o, k, n // c, c, M,
                                                  b_re.shape[0])
                head += [planes.bt_re.data_ptr(), planes.bt_im.data_ptr(),
                         planes.bt_lo_re.data_ptr(),
                         planes.bt_lo_im.data_ptr()]
                tail += [k3.VARIANTS.index(v), k3.RESTART_K8]
            err = self.lib.span_inject(*head, stride, out[0].data_ptr(),
                                       out[1].data_ptr(), *tail, stream)
        else:
            t_re, t_im, v_re, v_im, b_re, b_im, off, add = args
            o, nl, _ = t_re.shape
            r = v_re.shape[1]
            c = b_re.shape[1] - 1
            out = torch.empty((o, nl, r, c), device=v_re.device)
            stride = 0 if b_re.shape[0] == 1 else b_re.stride(0)
            head = [t_re.data_ptr(),
                    None if t_im is None else t_im.data_ptr(),
                    v_re.data_ptr(), v_im.data_ptr(), b_re.data_ptr(),
                    b_im.data_ptr()]
            tail = [o, nl, r, c, M, off, 1, 1]
            if self.planes:
                v = self.forced or k4.variant_for(o, nl, r, c, M,
                                                  b_re.shape[0])
                head += [planes.lo_re.data_ptr(), planes.lo_im.data_ptr()]
                tail += [k4.VARIANTS.index(v), k4.RESTART_K8]
            err = self.lib.span_reduce(
                *head, stride, None if add is None else add.data_ptr(),
                out.data_ptr(), *tail, stream)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")
        return out


def inputs(kind, shape, seed, dev):
    """Random operands at ``shape``; a power table of |lam| < 1."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)
    if kind == "inject":
        _, o, og, k, x, c = shape
    else:
        _, o, og, k, x, c, add, cplx = shape
    mag = torch.rand((og, 1, M), generator=gen, device=dev) * 0.01 + 0.99
    ang = torch.rand((og, 1, M), generator=gen, device=dev) * 3.0
    pw = torch.arange(c + 1, device=dev, dtype=torch.float32)[None, :, None]
    b_re = (mag ** pw * torch.cos(ang * pw)).contiguous()
    b_im = (mag ** pw * torch.sin(ang * pw)).contiguous()
    if kind == "inject":
        return (randn(o, k, x * c), randn(o, k, M), randn(o, k, M), b_re,
                b_im)
    return (randn(o, k, M), randn(o, k, M) if cplx else None, randn(o, x, M),
            randn(o, x, M), b_re, b_im, 1 if add else 0,
            randn(o, k, x, c) if add else None)


def run_shape(kind, shape, variants, seed, dev, restarts=()) -> dict:
    import torch
    from ..ops import span_inject as k3
    from ..ops import span_reduce as k4
    from ..ops.span import span_planes
    from . import roofline
    args = inputs(kind, shape, seed, dev)
    if kind == "inject":
        twin = k3.span_inject_reference(*args)
        _, o, og, k, x, c = shape
        bound = roofline.span_inject(o, og, k, x, c, M)
        variant = k3.variant_for(o, k, x, c, M, og)
    else:
        twin = [k4.span_reduce_reference(*args)]
        _, o, og, nl, r, c, add, cplx = shape
        bound = roofline.span_reduce(o, og, nl, r, c, M, add, cplx=cplx)
        variant = k4.variant_for(o, nl, r, c, M, og)
    planes = span_planes(*(args[3:5] if kind == "inject" else args[4:6]))
    res = {"shape": shape[0], "kernel": kind, "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"], "variant": variant}
    mod = k3 if kind == "inject" else k4
    taken = []
    for v in variants:
        try:
            got, again = v(args, planes), v(args, planes)
        except RuntimeError as err:   # a forced variant refused the shape
            res[v.name] = {"refused": str(err)}
            continue
        got = got if kind == "inject" else [got]
        again = again if kind == "inject" else [again]
        torch.cuda.synchronize()
        res[v.name] = {
            "bitwise_repeatable": all(torch.equal(a, b)
                                      for a, b in zip(got, again)),
            "db_vs_twin": max(db_error(a, t) for a, t in zip(got, twin))}
        if v.planes and restarts:
            kept, sweep = mod.RESTART_K8, {}
            for k8 in restarts:
                mod.RESTART_K8 = k8
                out = v(args, planes)
                sweep[k8] = max(db_error(a, t) for a, t in zip(
                    out if kind == "inject" else [out], twin))
            mod.RESTART_K8 = kept
            res[v.name]["db_by_restart_k8"] = sweep
        taken.append(v)
    del twin
    order = taken + taken[::-1]
    times = {v.name: [] for v in taken}
    for v in order:
        times[v.name].append(chain_ms(lambda: v(args, planes)))
    for v in taken:
        res[v.name]["ms"] = times[v.name]
        res[v.name]["share"] = bound["bound_ms"] / min(times[v.name])
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    import torch
    from ..ops import _build
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH.cu[@VARIANT] (repeatable)")
    parser.add_argument("--restarts", default="",
                        help="restart intervals (k8 steps) to give dB at")
    parser.add_argument("--shapes", default="",
                        help="keep shapes whose names hold one of these "
                        "comma-separated words")
    parser.add_argument("--out", default="span_ab.json")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_ab: no CUDA device", file=sys.stderr)
        return 1
    specs = [v.split("=", 1) for v in args.variant] or [
        ("inject", os.path.join(_build.CSRC, "span_inject.cu")),
        ("reduce", os.path.join(_build.CSRC, "span_reduce.cu"))]
    variants = [Variant(name, src) for name, src in specs]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    out = {"card": smi, "shapes": []}
    for kind, shapes in (("inject", INJECT_SHAPES),
                         ("reduce", REDUCE_SHAPES)):
        vs = [v for v in variants if v.kind == kind]
        if not vs:
            continue
        words = [w for w in args.shapes.split(",") if w]
        for i, shape in enumerate(shapes):
            if words and not any(w in shape[0] for w in words):
                continue
            out["shapes"].append(run_shape(
                kind, shape, vs, args.seed + i, dev,
                [int(k) for k in args.restarts.split(",") if k]))
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
