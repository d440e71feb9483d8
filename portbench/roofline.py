"""The least time an NVIDIA H100 SXM could take for a span dispatch's work.

Frozen from openpbso_tpu_torch/bench/roofline.py's formulas for the span's
stages (span_inject, span_reduce's g and hom, chunk_scan, toeplitz_conv),
with two changes, so that no float32-accurate implementation can read
over 100%:

- each multiply-add is counted once, at the tensor cores' TF32 peak
  (495 TFLOP/s, the highest rate float32 data can be multiplied at), not
  as the three TF32 products one implementation splits it into;
- the work is what the dispatch's inputs need, not what a slot table
  pads it to: per chunk, one excitation row for each object that has any
  (an object's excitation within a block is rank one, so its producing
  slots and its drag are one row), and the free response of each object
  that has ever been excited.

Bytes are the dispatch's inputs read once and outputs written once: the
chunk table lam^0..lam^C (re, im), the state in and out, the transfer
rows, the excitation rows and their profiles, and the mix, in float32;
at 3.35 TB/s. A span of N = X C samples, M modes, Og tables:

    injections  2 E C (2M)       g      2 E (2M) C      Toeplitz  E C (C+1)
    hom         2 R X (2M) C     scan   8 R X M
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
CHANNELS = 2          # the mix's output channels


def span_bound(*, excited: int, ringing: int, x: int, c: int, m: int,
               og: int) -> dict:
    """The bound of one span dispatch: ``excited`` (object, chunk) pairs
    with an excitation row, ``ringing`` objects with a non-zero state, X
    chunks of C samples."""
    flops = (excited * (2 * c * 2 * m + 2 * 2 * m * c + c * (c + 1))
             + ringing * x * (2 * 2 * m * c + 8 * m))
    n = x * c
    bytes_ = 4 * (2 * og * (c + 1) * m + 2 * 2 * ringing * m + ringing * m
                  + excited * (m + c) + CHANNELS * n)
    ops_s, bytes_s = flops / TF32_FLOPS, bytes_ / HBM_BYTES_PER_S
    return dict(flops=flops, bytes=bytes_, seconds=max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes")


def chunk_size(span: int) -> int:
    """The chunk C of a span of ``span`` samples: the largest divisor of the
    span up to min(512, max(64, span // 8)), the port's choose_radix today
    (frozen here: the bound's shapes do not follow a later change)."""
    target = min(512, max(64, span // 8))
    for r in range(min(target, span), 0, -1):
        if span % r == 0:
            return r
    return 1
