"""The least time an NVIDIA H100 SXM could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the device memory rate,
and the operations it does on its inputs over the peak rate of their type.
Rates are the data sheet's for the H100 SXM at its 700 W limit (dense, no
sparsity). Integer work is bounded per SM and clock by its pipes (the
Hopper architecture white paper): 64 INT32 lanes for the ALU's integer
operations (IADD3, LOP3, SHF, ...), 128 FP32 lanes for the floating-point
operations and IMAD, and the issue of four schedulers of one warp
instruction each, at the SM clock the caller passes, normally the card's
maximum as ``nvidia-smi --query-gpu=clocks.max.sm`` reads it. These are
reckonings from shapes; a kernel's share of its bound is bound_ms / ms.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # CUDA cores
TF32_FLOPS = 495e12         # tensor cores
SMS = 132
INT32_LANES_PER_SM = 64     # the ALU's integer operations
FMA_LANES_PER_SM = 128      # FP32 operations and IMAD
ISSUE_LANES_PER_SM = 128    # 4 schedulers x one 32-thread instruction


def integer_ms(n: int, per_item: dict, sm_clock_hz: float) -> float:
    """Least time for n items of per_item instructions by class (as
    bench/sass_count.py counts them: "int" on the ALU, "imad" and "fp32"
    on the FMA pipe, every class on the issue)."""
    lanes_clocks = max(
        per_item.get("int", 0.0) / INT32_LANES_PER_SM,
        (per_item.get("imad", 0.0) + per_item.get("fp32", 0.0))
        / FMA_LANES_PER_SM,
        sum(per_item.values()) / ISSUE_LANES_PER_SM)
    return 1e3 * n * lanes_clocks / (SMS * sm_clock_hz)


def _bound(bytes_, ops_ms, **extra) -> dict:
    bytes_ms = 1e3 * bytes_ / HBM_BYTES_PER_S
    out = dict(bytes=bytes_, bytes_ms=bytes_ms, ops_ms=ops_ms, **extra)
    out["bound_ms"] = max(bytes_ms, ops_ms)
    out["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return out


def toeplitz_conv(o: int, nl: int, k: int, x: int, c: int) -> dict:
    """The triangle's O L K X C(C+1)/2 multiply-adds; the kernel runs each
    as three TF32 products on the tensor cores (fp32_ms: the same work on
    the CUDA cores in FP32)."""
    macs = o * nl * k * x * c * (c + 1) // 2
    flops = 2 * macs
    bytes_ = 4 * (o * nl * k * c + o * k * x * c + o * nl * x * c)
    return _bound(bytes_, 1e3 * 3 * flops / TF32_FLOPS, flops=flops,
                  fp32_ms=1e3 * flops / FP32_FLOPS,
                  tf32x3_ms=1e3 * 3 * flops / TF32_FLOPS)


def span_inject(o: int, og: int, k: int, x: int, c: int, m: int) -> dict:
    """inj[o, x, m] = sum_k be_k sum_j lam^(C-1-j) f[o, k, xC + j],
    complex: 2 x rows x depth x columns FLOPs with O K X rows, depth C and
    2M columns (re and im); the kernel runs each multiply-add as three
    TF32 products on the tensor cores (fp32_ms: the same work on the CUDA
    cores). Reads f, be (re, im) and the table's C rows (re, im; Og = 1
    for a shared bank), writes inj (re, im)."""
    flops = 2 * (o * k * x) * c * (2 * m)
    bytes_ = 4 * (o * k * x * c + 2 * o * k * m + 2 * og * c * m
                  + 2 * o * x * m)
    return _bound(bytes_, 1e3 * 3 * flops / TF32_FLOPS, flops=flops,
                  fp32_ms=1e3 * flops / FP32_FLOPS,
                  tf32x3_ms=1e3 * 3 * flops / TF32_FLOPS)


def span_reduce(o: int, og: int, nl: int, r: int, c: int, m: int,
                add: bool, cplx: bool = False) -> dict:
    """out[o, l, r, c] = sum_m w_pr B_re + w_pi B_im (+ add): 2 x rows x
    depth x columns FLOPs with O L R rows, depth 2M and C columns, as
    three TF32 products each (fp32_ms: on the CUDA cores); the weights'
    products are formed on the way in and not counted. Reads the transfer
    rows (re, and im with ``cplx``), v (re, im), the table's C rows (re,
    im) and ``add``, writes out."""
    flops = 2 * (o * nl * r) * (2 * m) * c
    bytes_ = 4 * ((1 + cplx) * o * nl * m + 2 * o * r * m + 2 * og * c * m
                  + (1 + add) * o * nl * r * c)
    return _bound(bytes_, 1e3 * 3 * flops / TF32_FLOPS, flops=flops,
                  fp32_ms=1e3 * flops / FP32_FLOPS,
                  tf32x3_ms=1e3 * 3 * flops / TF32_FLOPS)


def chunk_scan(o: int, og: int, x: int, m: int, injections: bool) -> dict:
    """z_{x+1} = lam^C z_x + inj[x]: one complex multiply-add (8 flops)
    per (object, chunk, mode); reads z, lam^C and the injections, writes
    the final state and every start state."""
    bytes_ = 4 * (2 * o * m + 2 * og * m + (2 * o * x * m if injections
                                            else 0)
                  + 2 * o * m + 2 * o * x * m)
    return _bound(bytes_, 1e3 * 8 * o * x * m / FP32_FLOPS)


def fused_block(o: int, og: int, m: int, s: int, c: int) -> dict:
    """One S-sample block in S/C chunks: reads the [Og, C+1, M] tables (re,
    im), seven [O, M] rows and the [O, S] profile, writes z' and the sound;
    about 2 (K+1) C + 2 K C multiply-adds per mode (K = S/C) and the
    within-chunk convolution of the profile."""
    k = s // c
    bytes_ = 4 * (2 * og * (c + 1) * m + 7 * o * m + o * s
                  + 2 * o * m + o * s)
    flops = 2 * (o * m * (2 * (k + 1) * c + 2 * k * c)
                 + o * k * c * (c + 1) // 2)
    return _bound(bytes_, 1e3 * flops / FP32_FLOPS, flops=flops)


def ar_noise(o: int, x: int, s: int, per_sample: dict,
             sm_clock_hz: float) -> dict:
    """One threefry2x32 and the normal map per sample: the instructions
    counted per sample in the built kernel's SASS (bench/sass_count.py, both
    sides of a branch counted); writes [O, X, S] floats."""
    n = o * x * s
    return _bound(4 * n + 8 * 2 * o,
                  integer_ms(n, per_sample, sm_clock_hz), samples=n)


CHAIN_CLOCKS = 4   # latency of one dependent FP32 add or multiply


def ar_block(o: int, s: int, per_sample: dict, sm_clock_hz: float) -> dict:
    """Draws its own S normals per object (ar_noise's per-sample
    instructions) and runs the AR(2) recurrence; reads the key, tuning and
    history rows, writes the [O, S] profile and the history. The
    recurrence is a chain of S x 3 dependent FP32 operations (a0 h0, + a1
    h1, + sigma n, in the twin's rounding order) of CHAIN_CLOCKS each,
    whatever the number of objects: its time at the SM clock bounds the
    kernel too."""
    n = o * s
    bytes_ = 8 * 2 * o + 4 * (2 * o + 2 * o + o + o) + o + 4 * (n + 2 * o)
    issue_ms = integer_ms(n, per_sample, sm_clock_hz)
    chain_ms = 1e3 * s * 3 * CHAIN_CLOCKS / sm_clock_hz
    return _bound(bytes_, max(issue_ms, chain_ms), samples=n,
                  issue_ms=issue_ms, chain_ms=chain_ms)
