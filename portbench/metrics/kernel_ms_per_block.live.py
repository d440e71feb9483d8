"""Device kernel time per block: every CUDA kernel's duration in the
traced window (the profiler's), summed, over the blocks the engine
synthesised in that window."""


def read(record):
    if record["kind"] != "live":
        return None
    blocks = sum(n for _, _, n in record["dispatches"])
    lo, hi = record["t0_ns"], record["t1_ns"]
    ns = sum(min(e, hi) - max(s, lo) for _, s, e in record["kernels"]
             if e > lo and s < hi)
    if not blocks or ns <= 0:
        return None
    return ns / 1e6 / blocks
