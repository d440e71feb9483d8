"""AR(2) contact-force model fitting (reference scripts/ar.py prototype).

The reference ships a numpy prototype that generates AR(2) force noise to
eyeball its spectrum against forces.h. This module goes further: it both
*generates* AR(2) traces (cross-validating ops/forces.py) and *estimates*
AR(2) parameters (a1, a2, sigma, mu) from a recorded force/audio trace via
Yule-Walker — the missing half of the Pai et al. 2001 "scanning physical
interaction behavior" pipeline that the live ImGui sliders stand in for in
the reference (real_time_modal_sound.cpp:800-813). The port's own copy of
openpbso_tpu/ml/ar_model.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ARParams:
    a: tuple[float, float] = (0.783, 0.116)
    sigma: float = 0.00148
    mu: float = 0.142


def generate(params: ARParams, n: int, seed: int = 0) -> np.ndarray:
    """mu + AR(2) noise, matching forces.h:107-128 sample for sample."""
    rng = np.random.default_rng(seed)
    buf = np.zeros(3)
    idx = 0
    out = np.empty(n)
    a1, a2 = params.a
    for i in range(n):
        mu_t = a1 * buf[(idx + 2) % 3] + a2 * buf[(idx + 1) % 3]
        mu_t += params.sigma * rng.standard_normal()
        buf[idx] = mu_t
        idx = (idx + 1) % 3
        out[i] = params.mu + mu_t
    return out


def estimate(trace: np.ndarray) -> ARParams:
    """Yule-Walker AR(2) fit of a (stationary segment of a) force trace."""
    x = np.asarray(trace, np.float64)
    mu = float(x.mean())
    d = x - mu
    n = len(d)
    if n < 8:
        raise ValueError("trace too short for AR(2) estimation")
    r = np.array([d @ d, d[:-1] @ d[1:], d[:-2] @ d[2:]]) / n
    if r[0] <= 0.0:
        # constant/silent trace: zero variance makes the Yule-Walker
        # system singular — a clear error beats LinAlgError
        raise ValueError("trace has zero variance (constant/silent "
                         "segment); AR(2) estimation needs fluctuation")
    # Yule-Walker: [r0 r1; r1 r0] [a1 a2]^T = [r1 r2]^T
    mat = np.array([[r[0], r[1]], [r[1], r[0]]])
    rhs = np.array([r[1], r[2]])
    try:
        a1, a2 = np.linalg.solve(mat, rhs)
    except np.linalg.LinAlgError as e:
        raise ValueError(f"degenerate autocorrelation (r={r.tolist()}); "
                         "the segment is not AR(2)-identifiable") from e
    sigma2 = r[0] - a1 * r[1] - a2 * r[2]
    return ARParams((float(a1), float(a2)),
                    float(np.sqrt(max(sigma2, 0.0))), mu)


def spectrum(params: ARParams, n_freq: int = 512,
             sample_rate: float = 44100.0) -> tuple[np.ndarray, np.ndarray]:
    """Theoretical AR(2) power spectrum (for comparing against rendered
    sustained-force audio, the reference's eyeball check)."""
    w = np.linspace(0, np.pi, n_freq)
    a1, a2 = params.a
    h = 1.0 / np.abs(1 - a1 * np.exp(-1j * w) - a2 * np.exp(-2j * w)) ** 2
    return w * sample_rate / (2 * np.pi), params.sigma ** 2 * h
