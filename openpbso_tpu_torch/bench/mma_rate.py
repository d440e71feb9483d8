"""The card's mma.sync TF32 rate, the ceiling of the Toeplitz-conv kernel.

    python -m openpbso_tpu_torch.bench.mma_rate

Builds bench/mma_rate.cu for sm_90a and times, with CUDA events, warps
that each issue 1 to 8 independent chains of mma.sync.m16n8k8 TF32 (2048
floating-point operations each) at several warps per SM. Prints one JSON
line per configuration with its TFLOP/s; fails without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys

ITERS = 4096


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    from .toeplitz_ab import build, time_ms
    lib = ctypes.CDLL(build("mma_rate", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "mma_rate.cu")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_tf32_rate.argtypes = [p, i, i, i, i, p]
    lib.mma_tf32_rate.restype = i
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 1024, device="cuda")
    for warps_per_sm in (4, 8, 16, 32):
        for ilp in (1, 2, 4, 8):
            blocks, threads = sms * warps_per_sm // 4, 128

            def run():
                err = lib.mma_tf32_rate(out.data_ptr(), blocks, threads, ilp,
                                        ITERS,
                                        torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"mma_tf32_rate: CUDA error {err}")
            ms = time_ms(run, runs=10)
            flops = 2048.0 * blocks * (threads // 32) * ilp * ITERS
            print(json.dumps({"warps_per_sm": warps_per_sm, "ilp": ilp,
                              "ms": ms, "tflops": flops / ms / 1e9}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
