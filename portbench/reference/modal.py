"""The modal oscillator bank of the plain reference.

Every mode m of object o is the complex first-order recurrence of the
upstream modal integrator (openpbso modal_integrator.h):

    z[n] = lam z[n-1] + b Q[n],    q[n] = Im z[n],
    lam = eps e^{i theta},         b = c3 (cot theta + i),

with omega = sqrt(omega^2 / density), xi = (alpha / omega + beta omega) / 2,
eps = exp(-xi omega h), theta = h omega sqrt(1 - xi^2) and c3 the
integrator's input coefficient times the upstream's gain of 1e9. Modes
with xi >= 1 (overdamped) do not sound. Worked out here in float64 from
the undivided eigenvalues omega^2 that the benchmark generated, never from
anything the program derived.
"""
from __future__ import annotations

import numpy as np
import torch


def coefficients(omega_sq: np.ndarray, density: float, alpha: float,
                 beta: float, rate: float, gain: float):
    """(lam, b, valid) as complex128 / bool arrays of omega_sq's shape."""
    h = 1.0 / rate
    w2 = np.asarray(omega_sq, np.float64) / density
    omega = np.sqrt(np.maximum(w2, 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        xi = 0.5 * (alpha / omega + beta * omega)
        valid = (omega > 0) & (xi < 1.0) & np.isfinite(xi)
        xi = np.where(valid, xi, 0.0)
        omega = np.where(valid, omega, 1.0)
        omega_d = omega * np.sqrt(1.0 - xi * xi)
        eps = np.exp(-xi * omega * h)
        theta = omega_d * h
        gamma = np.arcsin(xi)
        c3 = 2.0 * (eps * np.cos(theta + gamma)
                    - eps ** 2 * np.cos(2.0 * theta + gamma))
        c3 = c3 / (3.0 * omega * omega_d) * gain
        lam = eps * np.exp(1j * theta)
        b = c3 * (np.cos(theta) / np.sin(theta) + 1j)
    return (np.where(valid, lam, 0.0), np.where(valid, b, 0.0), valid)


def powers(lam: np.ndarray, count: int, dtype: torch.dtype,
           device) -> tuple[torch.Tensor, torch.Tensor]:
    """lam^d for d in [0, count) as real and imaginary [G, M, count]
    tensors, from |lam|^d and d arg(lam) in float64 on the device."""
    lam_t = torch.as_tensor(np.ascontiguousarray(lam), device=device)
    mag = lam_t.abs()
    ang = torch.angle(lam_t)
    d = torch.arange(count, dtype=torch.float64, device=device)
    logmag = torch.where(mag > 0, mag.clamp_min(1e-300).log(),
                         torch.full_like(mag, -torch.inf))
    magd = torch.exp(logmag[..., None] * d)
    magd = torch.where((mag[..., None] == 0) & (d == 0),
                       torch.ones_like(magd), torch.nan_to_num(magd))
    angd = ang[..., None] * d
    return ((magd * torch.cos(angd)).to(dtype),
            (magd * torch.sin(angd)).to(dtype))
