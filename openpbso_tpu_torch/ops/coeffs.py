"""Modal oscillator bank: host float64 coefficients, device float32 tables.

Counterpart of openpbso_tpu/ops/coeffs.py. Each mode is the first-order
complex recurrence ``z_k = lam z_{k-1} + b Q_k`` (q_k = Im z_k) with
``lam = eps e^{i theta}`` and ``b = c3 (cot theta + i)``; the block form
needs the lam-power tables ``lam^d``. All transcendental math is float64
numpy, copied here from the reference so the port never imports jax; the
device only sees exact float32 casts of the float64 tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MODAL_GAIN, SAMPLE_RATE
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModalBank:
    """Per-(object, mode) oscillator parameters, device-resident.

    Shapes are ``[O, M]`` (padded M; padding and invalid modes have mask 0
    and lam = b = 0). ``pow_re/pow_im`` hold ``lam^d`` for d in [0, S] as
    ``[O, M, S+1]``, or ``[1, M, S+1]`` when every object shares one mode
    set.
    """
    lam_re: torch.Tensor
    lam_im: torch.Tensor
    b_re: torch.Tensor
    b_im: torch.Tensor
    mask: torch.Tensor
    pow_re: torch.Tensor | None
    pow_im: torch.Tensor | None
    # chunk -> ([Og, C+1, M] re, im): the fused kernel's table layout,
    # built once per (bank, chunk) by chunk_tables()
    _chunk_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                           repr=False, compare=False)

    @property
    def num_objects(self) -> int:
        return self.lam_re.shape[0]

    @property
    def num_modes(self) -> int:
        return self.lam_re.shape[1]

    @property
    def block_size(self) -> int | None:
        return None if self.pow_re is None else self.pow_re.shape[-1] - 1

    @property
    def shared_tables(self) -> bool:
        return self.pow_re is not None and self.pow_re.shape[0] == 1

    @property
    def device(self) -> torch.device:
        return self.lam_re.device

    def chunk_tables(self, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``lam^0..lam^chunk`` as contiguous ``[Og, chunk+1, M]`` (powers
        outer, modes inner: one row per power is one coalesced read).
        Slices of the block tables, so exact; cached on the bank."""
        tables = self._chunk_cache.get(chunk)
        if tables is None:
            if self.pow_re is None or self.pow_re.shape[-1] < chunk + 1:
                raise ValueError(
                    f"bank tables missing or shorter than chunk {chunk}")
            tables = tuple(
                t[..., : chunk + 1].transpose(1, 2).contiguous()
                for t in (self.pow_re, self.pow_im))
            self._chunk_cache[chunk] = tables
        return tables


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def lambda_from_modes(density: float, omega_squared: np.ndarray, alpha: float,
                      beta: float, h: float = 1.0 / SAMPLE_RATE
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lam, b, valid) in float64/complex128 for one material + mode set.

    omega = sqrt(omega_squared/density), xi = 0.5(alpha/omega + beta*omega),
    a = 2 xi omega, bq = omega^2, eps = exp(-a h/2), theta = h sqrt(bq -
    a^2/4); lam = eps e^{i theta}, Im(b) = c3, Re(b) = c3 cot(theta). Modes
    with xi >= 1 (overdamped) are invalid and zeroed.
    """
    omega_squared = np.asarray(omega_squared, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        omega = np.sqrt(omega_squared / density)
        xi = 0.5 * (alpha / omega + beta * omega)
        a = 2.0 * xi * omega
        bq = omega ** 2
        disc = bq - a * a / 4.0
        valid = (omega > 0) & (disc > 0) & np.isfinite(disc)
        disc = np.where(valid, disc, 1.0)
        omega_s = np.where(valid, omega, 1.0)
        eps = np.exp(-a / 2.0 * h)
        theta = h * np.sqrt(disc)
        gamma = np.arcsin(a / (2.0 * np.sqrt(bq)))
        omega_d = np.sqrt(disc)
        c3 = 2.0 * (eps * np.cos(theta + gamma)
                    - eps ** 2 * np.cos(2.0 * theta + gamma))
        c3 = c3 / (3.0 * omega_s * omega_d) * MODAL_GAIN
        lam = eps * np.exp(1j * theta)
        b = c3 * (np.cos(theta) / np.sin(theta) + 1j)
    lam = np.where(valid, lam, 0.0)
    b = np.where(valid, b, 0.0)
    return lam, b, valid


def _power_table(lam: np.ndarray, powers) -> np.ndarray:
    """[..., len(powers)] complex128 table of lam^d in exact-angle polar
    form (d*log|lam|, d*arg lam), so the angle does not accumulate rounding
    across hundreds of powers. ``powers``: int (arange(powers+1)) or an
    explicit exponent array."""
    mag = np.abs(lam)
    ang = np.angle(lam)
    if np.isscalar(powers) or np.ndim(powers) == 0:
        d = np.arange(int(powers) + 1, dtype=np.float64)
    else:
        d = np.asarray(powers, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        logmag = np.where(mag > 0, np.log(mag), -np.inf)
        magd = np.exp(logmag[..., None] * d)  # mag^d (0^0 -> 1 below)
    magd = np.where((mag[..., None] == 0) & (d == 0), 1.0,
                    np.nan_to_num(magd, nan=0.0))
    angd = ang[..., None] * d
    return magd * np.exp(1j * angd)


def _to_device(x: np.ndarray, dtype: torch.dtype,
               device: torch.device | str | None) -> torch.Tensor:
    """Exact cast of a float64 host array (cast on the host, then one
    copy to the device), C-contiguous whatever the host layout."""
    return torch.as_tensor(np.ascontiguousarray(x)).to(dtype).to(device)


def build_modal_bank(
    lam: np.ndarray,
    b: np.ndarray,
    valid: np.ndarray,
    *,
    block_size: int | None = None,
    pad_modes_to: int = 128,
    shared: bool | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> ModalBank:
    """Assemble a device ModalBank from per-(object, mode) lam/b arrays.

    ``lam/b/valid`` may be [M] (one object) or [O, M]; modes are padded to
    a multiple of ``pad_modes_to``. When ``shared`` (or every object has the
    same lam) the power tables are stored once, ``[1, M, S+1]``.
    ``device`` None is the CUDA device (device.resolve_device).
    """
    device = resolve_device(device)
    lam = np.atleast_2d(np.asarray(lam))
    b = np.atleast_2d(np.asarray(b))
    valid = np.atleast_2d(np.asarray(valid))
    o, m = lam.shape
    mp = round_up(max(m, 1), pad_modes_to)
    pad = ((0, 0), (0, mp - m))
    lam = np.pad(lam, pad)
    b = np.pad(b, pad)
    mask = np.pad(valid.astype(np.float64), pad)
    lam = lam * mask
    b = b * mask

    pow_re = pow_im = None
    if block_size is not None:
        if shared is None:
            shared = o == 1 or all(
                np.array_equal(lam[0], lam[i]) for i in range(1, o))
        tbl = _power_table(lam[:1] if shared else lam, block_size)
        pow_re = _to_device(tbl.real, dtype, device)
        pow_im = _to_device(tbl.imag, dtype, device)
    return ModalBank(
        lam_re=_to_device(lam.real, dtype, device),
        lam_im=_to_device(lam.imag, dtype, device),
        b_re=_to_device(b.real, dtype, device),
        b_im=_to_device(b.imag, dtype, device),
        mask=_to_device(mask, dtype, device),
        pow_re=pow_re,
        pow_im=pow_im,
    )


def bank_from_material(
    density: float,
    omega_squared: np.ndarray,
    alpha: float,
    beta: float,
    *,
    num_objects: int = 1,
    block_size: int | None = None,
    h: float = 1.0 / SAMPLE_RATE,
    pad_modes_to: int = 128,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> ModalBank:
    """A bank where ``num_objects`` instances share one mode set."""
    device = resolve_device(device)
    lam, b, valid = lambda_from_modes(density, omega_squared, alpha, beta, h)
    lam = np.broadcast_to(lam, (num_objects, lam.shape[-1]))
    b = np.broadcast_to(b, (num_objects, b.shape[-1]))
    valid = np.broadcast_to(valid, (num_objects, valid.shape[-1]))
    return build_modal_bank(lam, b, valid, block_size=block_size,
                            pad_modes_to=pad_modes_to, shared=True,
                            dtype=dtype, device=device)
