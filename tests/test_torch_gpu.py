"""GPU-only tests of the port: the CUDA kernel against its plain twin.

They skip without a CUDA device. This file imports no jax, so it also runs
on a GPU machine that has no JAX installed (tests/conftest.py imports jax;
skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from openpbso_tpu_torch.ops import fused_integrator as fi
from openpbso_tpu_torch.ops.coeffs import build_modal_bank, lambda_from_modes
from openpbso_tpu_torch.ops.integrator import step_block_blocked
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _db(test, ref) -> float:
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.linalg.norm(test - ref)
    return -np.inf if err == 0 else 20 * np.log10(err / np.linalg.norm(ref))


def _bank(o, n, s, shared, device):
    """Per-object frequency ranges make a heterogeneous bank; one range
    for every object makes build_modal_bank store the tables once."""
    offsets = [0] * o if shared else range(o)
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n, 8, seed=7, f_low=100.0 + i, f_high=15000.0 + 3 * i).omega_squared,
        CERAMIC.alpha, CERAMIC.beta) for i in offsets]
    lam, b, v = (np.stack(x) for x in zip(*parts))
    return build_modal_bank(lam, b, v, block_size=s, device=device)


def _inputs(bank, s, seed=0):
    rng = np.random.default_rng(seed)
    o, m = bank.num_objects, bank.num_modes
    mask = bank.mask.cpu().numpy()
    arrays = [rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, m)) * mask,
              rng.standard_normal((o, s)),
              rng.uniform(0.5, 2.0, (o, m))]
    zr, zi, sp, tp, tr = (torch.as_tensor(a, dtype=torch.float32,
                                          device=bank.device) for a in arrays)
    return zr, zi, bank, sp, tp, tr


@pytest.mark.parametrize("o,n,s,chunk,shared", [
    (5, 40, 256, 64, False),      # ragged: 40 modes padded to 128
    (4, 200, 512, 64, True),      # shared tables, read with stride 0
    (3, 300, 512, 256, False),    # chunk wider than a block's threads
    (2, 24, 32, 64, False),       # chunk > S clamps to one chunk
])
def test_kernel_matches_twin(cuda, o, n, s, chunk, shared):
    bank = _bank(o, n, s, shared, cuda)
    assert bank.shared_tables == shared
    args = _inputs(bank, s)
    before = fi.LAUNCHES
    got = fi.step_block_fused(*args, chunk=chunk)[:3]
    again = fi.step_block_fused(*args, chunk=chunk)[:3]
    assert fi.LAUNCHES == before + 2
    ref = fi.fused_block_reference(*args, chunk=chunk)
    blocked = step_block_blocked(*args)[:3]
    for k, a, r, b in zip(got, again, ref, blocked):
        assert torch.equal(k, a)                       # deterministic
        assert _db(k.cpu(), r.cpu()) <= -100
        assert _db(k.cpu(), b.cpu()) <= -90


def test_matmul_precision_pin_at_production_shape(cuda):
    """TF32 would keep ~10 mantissa bits (about -60 dB here); the pinned
    float32 product must stay near float32 rounding."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((256, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 512)).astype(np.float32)
    got = (torch.from_numpy(a).to(cuda) @ torch.from_numpy(b).to(cuda)).cpu()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert _db(got, ref) <= -120


def test_session_steps_through_the_kernel(cuda):
    bank = _bank(6, 40, 256, False, cuda)
    assert not bank.shared_tables
    sessions = {name: ModalSession(bank, config=SolverConfig(
        block_size=256, backend=name)) for name in ("auto", "blocked")}
    rng = np.random.default_rng(2)
    for obj in range(6):
        space = rng.standard_normal(40)
        for sess in sessions.values():
            sess.hit(obj, space, kind="gaussian", width_us=600.0,
                     when=256 * (obj % 3))
    before = fi.LAUNCHES
    mix = sessions["auto"].render(10)
    busy = fi.LAUNCHES - before
    # slots expire at 260, 516 and 772: blocks at 0, 256, 512, 768 are busy
    assert busy == 4
    assert np.isfinite(mix).all() and np.abs(mix).max() > 0
    assert _db(mix, sessions["blocked"].render(10)) <= -90
