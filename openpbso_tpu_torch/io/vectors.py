"""ASCII / binary (complex) vector IO.

Parity with the reference's templated helpers (io.h:24-90), which the
offline pipeline uses to exchange per-mode pressure vectors with the
wavesolver: whitespace ASCII floats, raw little-endian binary, and complex
vectors stored as interleaved (re, im) pairs. The port's own copy of
openpbso_tpu/io/vectors.py.
"""
from __future__ import annotations

import numpy as np


def read_vector_ascii(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).ravel()


def write_vector_ascii(path: str, v: np.ndarray) -> None:
    np.savetxt(path, np.asarray(v, np.float64).ravel(), fmt="%.17g")


def read_vector_binary(path: str, dtype=np.float64) -> np.ndarray:
    return np.fromfile(path, dtype=np.dtype(dtype).newbyteorder("<"))


def write_vector_binary(path: str, v: np.ndarray,
                        dtype=np.float64) -> None:
    np.asarray(v, dtype).astype(np.dtype(dtype).newbyteorder("<"),
                                copy=False).tofile(path)


def read_complex_vector(path: str, *, binary: bool = True,
                        dtype=np.float64) -> np.ndarray:
    """ReadComplexVector (io.h:24-64) -> complex128.

    Binary layout: one int32 scalar count (= 2 * number of complex
    entries) followed by interleaved (re, im) ``dtype`` pairs
    (io.h:30-40). ASCII: one "re im" whitespace pair per line
    (io.h:43-63).
    """
    if not binary:
        raw = np.loadtxt(path, dtype=np.float64, ndmin=2)
        if raw.shape[1] < 2:
            raise ValueError(f"ASCII complex vector needs 're im' pairs "
                             f"per line: {path}")
        return raw[:, 0] + 1j * raw[:, 1]
    with open(path, "rb") as f:
        count = int(np.fromfile(f, dtype="<i4", count=1)[0])
        raw = np.fromfile(f, dtype=np.dtype(dtype).newbyteorder("<"),
                          count=count).astype(np.float64)
    if raw.size != count or count % 2:
        raise ValueError(f"truncated/odd complex vector file: {path}")
    return raw[0::2] + 1j * raw[1::2]


def write_complex_vector(path: str, v: np.ndarray, *, binary: bool = True,
                         dtype=np.float64) -> None:
    """WriteComplexVector (io.h:66-90): int32 count header + interleaved
    pairs (binary) or fixed-point 16-digit "re im" lines (ASCII,
    io.h:82-87)."""
    v = np.asarray(v, np.complex128).ravel()
    if not binary:
        with open(path, "w") as f:
            for z in v:
                f.write(f"{z.real:.16f} {z.imag:.16f}\n")
        return
    raw = np.empty(2 * v.size, np.float64)
    raw[0::2] = v.real
    raw[1::2] = v.imag
    with open(path, "wb") as f:
        np.asarray([2 * v.size], "<i4").tofile(f)
        raw.astype(np.dtype(dtype).newbyteorder("<"), copy=False).tofile(f)
