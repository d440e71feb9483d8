"""Golden oracle: float64 numpy re-derivation of the reference runtime math.

The port's own copy of openpbso_tpu/utils/oracle.py. The reference ships
no test suite (SURVEY.md section 4), so this module *is* the correctness
contract: a direct, scalar-faithful implementation of

- IIR coefficient construction   (reference modal_integrator.h:48-100)
- the per-sample recurrence       (reference modal_integrator.h:104-123)
- force time profiles             (reference forces.h:81-137)
- FFAT cubemap lookup             (reference ffat_solver.h:677-803, 1180-1214)
- the block synthesis loop        (reference modal_solver.h:181-276)

It is deliberately written in plain numpy with the same operation ordering as
the reference so its float64 outputs can stand in for the C++ binary. All
device backends are validated against it at <= -60 dB.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import MODAL_GAIN, SAMPLE_RATE, UNIT_TRANSFER
from ..io.fatcube import FatcubeMap

# ---------------------------------------------------------------------------
# coefficients + recurrence
# ---------------------------------------------------------------------------


def iir_coefficients(density: float, omega_squared: np.ndarray, alpha: float,
                     beta: float, h: float) -> tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
    """(c1, c2, c3) per mode, per reference modal_integrator.h:48-100.

    omega_squared are the *undivided* eigenvalues (omega^2 * density).
    c3 includes the reference's arbitrary 1E9 gain.
    """
    omega_squared = np.asarray(omega_squared, np.float64)
    omega = np.sqrt(omega_squared / density)
    xi = 0.5 * (alpha / omega + beta * omega)
    a = 2.0 * xi * omega
    b = omega ** 2
    eps = np.exp(-a / 2.0 * h)
    theta = h * np.sqrt(b - a * a / 4.0)
    gamma = np.arcsin(a / (2.0 * np.sqrt(b)))
    omega_d = np.sqrt(b - a ** 2 / 4.0)
    c1 = 2.0 * eps * np.cos(theta)
    c2 = -(eps ** 2)
    c3 = 2.0 * (eps * np.cos(theta + gamma)
                - eps ** 2 * np.cos(2.0 * theta + gamma))
    c3 = c3 / (3.0 * omega * omega_d) * MODAL_GAIN
    return c1, c2, c3


class OracleIntegrator:
    """Ring-buffer IIR stepping, per reference modal_integrator.h:104-123."""

    def __init__(self, c1: np.ndarray, c2: np.ndarray, c3: np.ndarray):
        self.c1, self.c2, self.c3 = c1, c2, c3
        n = c1.shape[0]
        self._q = [np.zeros(n) for _ in range(3)]
        self._ptr = 0

    def step(self, force: np.ndarray | None = None) -> np.ndarray:
        q_km1 = self._q[self._ptr % 3]
        q_km2 = self._q[(self._ptr + 2) % 3]
        q_k = self.c1 * q_km1 + self.c2 * q_km2
        if force is not None:
            q_k = q_k + self.c3 * force
        self._q[(self._ptr + 1) % 3] = q_k
        self._ptr = (self._ptr + 1) % 3
        return q_k


# ---------------------------------------------------------------------------
# force time profiles
# ---------------------------------------------------------------------------


class OraclePointForce:
    """Unit impulse at the first sample of the first block (forces.h:81-90)."""

    def __init__(self):
        self.used = False

    def add(self, buf: np.ndarray) -> bool:
        if self.used:
            return False
        buf[0] += 1.0
        self.used = True
        return True


class OracleGaussianForce:
    """Truncated Gaussian profile (forces.h:33-48, 92-105).

    ``width`` is in microseconds; the profile is
    exp(-0.5((t - center)/w)^2) with w in samples, center=(cutoff-0.5)*w,
    truncated after cutoff*2*w samples (cutoff=5).
    """

    def __init__(self, width_us: float, sample_rate: int = SAMPLE_RATE):
        self.width = width_us
        self.width_samples = max(1, int(width_us / 1e6 * sample_rate))
        self.cutoff = 5
        self.center = int((self.cutoff - 0.5) * self.width_samples)
        self.count = 0

    def add(self, buf: np.ndarray) -> bool:
        if self.width == 0 or self.count >= self.cutoff * 2 * self.width_samples:
            return False
        n = buf.shape[0]
        t = self.count + np.arange(n) - self.center
        buf += np.exp(-0.5 * (t / self.width_samples) ** 2)
        self.count += n
        return True


class OracleHertzForce:
    """Hertzian contact pulse sin(pi t/tau)^{3/2} over one contact time.

    Not in the reference's forces.h; included for the BASELINE.json Hertz
    contact-train configs (same block-level lifecycle as the other forces).
    """

    def __init__(self, duration_us: float, sample_rate: int = SAMPLE_RATE):
        self.tau = max(1, int(duration_us / 1e6 * sample_rate))
        self.count = 0

    def add(self, buf: np.ndarray) -> bool:
        if self.count >= self.tau:
            return False
        n = buf.shape[0]
        t = self.count + np.arange(n)
        live = t < self.tau
        buf[live] += np.sin(np.pi * t[live] / self.tau) ** 1.5
        self.count += n
        return True


class OracleARForce:
    """AR(2) sustained contact force (forces.h:107-137, Pai et al. 2001).

    mu_tilde_k = a1 mu_tilde_{k-1} + a2 mu_tilde_{k-2} + sigma*N(0,1);
    output mu + mu_tilde_k. The RNG stream differs from C++
    std::normal_distribution by design (stochastic signal: spectra are
    compared, not samples).
    """

    def __init__(self, a=(0.783, 0.116), sigma=0.00148, mu=0.142, seed=0):
        self.a = list(a)
        self.sigma = sigma
        self.mu = mu
        self.buf = [0.0, 0.0, 0.0]
        self.idx = 0
        self.rng = np.random.default_rng(seed)

    def set_param(self, a, sigma, mu):
        self.buf = [0.0, 0.0, 0.0]
        self.a, self.sigma, self.mu = list(a), sigma, mu

    def add(self, buf: np.ndarray) -> bool:
        n = len(self.buf)
        for i in range(buf.shape[0]):
            mu_t = 0.0
            for j in range(2):
                mu_t += self.a[j] * self.buf[(self.idx + n - j - 1) % n]
            mu_t += self.sigma * self.rng.standard_normal()
            self.buf[self.idx] = mu_t
            self.idx = (self.idx + 1) % n
            buf[i] += self.mu + mu_t
        return True


# ---------------------------------------------------------------------------
# FFAT cubemap lookup
# ---------------------------------------------------------------------------


def ffat_intersect(m: FatcubeMap, p: np.ndarray):
    """Ray p->center vs shell bbox: surface point + (face,u,v) cell.

    Per reference ffat_solver.h:677-712 (slab test, nearest-plane face pick,
    floor cell index with clamping).
    """
    s = m.shell
    d = s.center - p
    with np.errstate(divide="ignore", invalid="ignore"):
        t_min = (s.bbox_low - p) / d
        t_max = (s.bbox_top - p) / d
    t_enter = np.fmin(t_min, t_max)
    t_en = np.max(t_enter)
    surf = p + t_en * d
    face = -1
    min_dist = np.inf
    for dd in range(3):
        if abs(s.bbox_low[dd] - surf[dd]) < min_dist:
            min_dist = abs(s.bbox_low[dd] - surf[dd])
            face = dd * 2 + 1
        if abs(s.bbox_top[dd] - surf[dd]) < min_dist:
            min_dist = abs(s.bbox_top[dd] - surf[dd])
            face = dd * 2
    dk = face // 2
    di, dj = (dk + 1) % 3, (dk + 2) % 3
    nu, nv = int(s.n_elements[face, 0]), int(s.n_elements[face, 1])
    u = int(np.floor((surf[di] - s.low_corners[face, di]) / s.cell_size))
    v = int(np.floor((surf[dj] - s.low_corners[face, dj]) / s.cell_size))
    u = min(max(u, 0), nu - 1)
    v = min(max(v, 0), nv - 1)
    return surf, (face, u, v)


def ffat_interpolate(m: FatcubeMap, surf: np.ndarray, cell):
    """Bilinear stencil + weights with edge clamping (ffat_solver.h:737-803)."""
    s = m.shell
    face = cell[0]
    dk = face // 2
    di, dj = (dk + 1) % 3, (dk + 2) % 3
    nu, nv = int(s.n_elements[face, 0]), int(s.n_elements[face, 1])
    h = s.cell_size
    low = s.low_corners[face]
    x_float = (surf[di] - (low[di] + 0.5 * h)) / h
    y_float = (surf[dj] - (low[dj] + 0.5 * h)) / h
    x = int(np.floor(x_float))
    y = int(np.floor(y_float))
    if x < 0:
        x, xp, tx = 0, 0, 0.0
    elif x < nu - 1:
        xp, tx = x + 1, x_float - x
    else:
        x, xp, tx = nu - 1, nu - 1, 0.0
    if y < 0:
        y, yp, ty = 0, 0, 0.0
    elif y < nv - 1:
        yp, ty = y + 1, y_float - y
    else:
        y, yp, ty = nv - 1, nv - 1, 0.0
    tx = min(max(tx, 0.0), 1.0)
    ty = min(max(ty, 0.0), 1.0)
    stencil = [(face, x, y), (face, xp, y), (face, x, yp), (face, xp, yp)]
    weights = [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty]
    return stencil, weights


def ffat_map_val(m: FatcubeMap, p: np.ndarray,
                 use_compressed: bool = False) -> float:
    """|p(x)| transfer amplitude at listener position p.

    Per reference FFAT_Map<T,3>::GetMapVal (ffat_solver.h:1180-1214):
    intersect + bilinear on the outer shell, then |Psi/(k r)| with
    r = |p - center| (FFAT_Solver<T,3>::Reconstruct, ffat_solver.h:899-906).
    """
    del use_compressed  # psi already holds the (de)compressed values
    surf, cell = ffat_intersect(m, p)
    stencil, weights = ffat_interpolate(m, surf, cell)
    s = m.shell
    psi = 0.0
    for (face, u, v), w in zip(stencil, weights):
        idx = int(s.strides[face]) + u * int(s.n_elements[face, 1]) + v
        psi += w * m.psi[idx]
    kr = m.k * np.linalg.norm(p - m.center)
    return abs(psi / kr)


# ---------------------------------------------------------------------------
# block synthesis loop (the ModalSolver::step equivalent)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OracleForceEntry:
    space: np.ndarray   # [M] modal amplitudes (the ForceMessage .data)
    profile: object     # one of the Oracle*Force profile objects


class OracleSolver:
    """Single-object block synthesizer mirroring modal_solver.h:181-276."""

    def __init__(self, c1, c2, c3, block_size: int,
                 transfer: np.ndarray | None = None):
        self.integrator = OracleIntegrator(c1, c2, c3)
        self.n_modes = c1.shape[0]
        self.block = block_size
        self.active: list[OracleForceEntry] = []
        self.transfer = (transfer if transfer is not None
                         else np.full(self.n_modes, UNIT_TRANSFER))

    def hit(self, space: np.ndarray, profile) -> None:
        self.active.append(OracleForceEntry(np.asarray(space, np.float64),
                                            profile))

    def step(self) -> tuple[np.ndarray, np.ndarray]:
        """One block: returns (sound [S], qnorm [M])."""
        time_buf = np.zeros(self.block)
        space_buf = np.zeros(self.n_modes)
        still = []
        for entry in self.active:
            if entry.profile.add(time_buf):
                space_buf += entry.space
                still.append(entry)
        self.active = still
        sound = np.zeros(self.block)
        qsq = np.zeros(self.n_modes)
        for i in range(self.block):
            q = self.integrator.step(space_buf * time_buf[i])
            sound[i] = q @ self.transfer
            qsq += q * q
        return sound, np.sqrt(qsq)

    def render(self, n_blocks: int) -> np.ndarray:
        return np.concatenate([self.step()[0] for _ in range(n_blocks)])
