"""The port against the committed goldens of the compiled C++ reference.

``tests/golden/cpp_reference_{point,gaussian}_1s.npy`` were written by the
reference's own ModalIntegrator and Force classes in double precision (86
blocks of 513 samples, 24 modes, unit 1e7 transfer; tests/test_cpp_reference.py
holds the JAX package to them), and ``impulse_24modes_quarter_sec.npy`` pins
the float64 oracle's impulse render (tests/test_golden.py). Here the port's
per-block backends render the same cases on the CPU, the fused backend
through its plain twin, at the reference's block of 513 and at the card's
S = 512 with chunks of 64. Both goldens are responses to one force that
starts at sample 0, so a render at another block size is the same waveform,
cut to the golden's length.
"""
import os

import numpy as np
import pytest
import torch

from openpbso_tpu.utils.oracle import OracleGaussianForce, OraclePointForce
from openpbso_tpu_torch.config import UNIT_TRANSFER
from openpbso_tpu_torch.ops.coeffs import bank_from_material
from openpbso_tpu_torch.ops.fused_integrator import step_block_fused
from openpbso_tpu_torch.ops.integrator import (step_block_blocked,
                                               step_block_scan)
from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
N_MODES = 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def golden(name):
    return np.load(os.path.join(GOLDEN_DIR, name)).astype(np.float64)


def render(step, kind, width_us, block, n_samples, dtype=torch.float32,
           device="cpu"):
    """The golden's case through one per-block backend: 24 synthetic modes
    struck with a seeded direction, the force profile from the oracle's
    force classes, the unit transfer. Returns the first n_samples."""
    md = synth_mode_data(N_MODES, 8, seed=0)
    space = np.random.default_rng(3).standard_normal(N_MODES)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, block_size=block,
                              dtype=dtype, device=device)
    m = bank.num_modes
    sp = torch.zeros((1, m), dtype=dtype, device=device)
    sp[0, :N_MODES] = torch.as_tensor(space).to(dtype)
    tr = torch.full((1, m), UNIT_TRANSFER, dtype=dtype, device=device)
    zr = zi = torch.zeros((1, m), dtype=dtype, device=device)
    prof = (OraclePointForce() if kind == "point"
            else OracleGaussianForce(width_us))
    alive = True
    out = []
    for _ in range(-(-n_samples // block)):
        tbuf = np.zeros(block)
        if alive:
            alive = prof.add(tbuf)
        tp = torch.as_tensor(tbuf).to(dtype).to(device)[None]
        zr, zi, sound, _ = step(zr, zi, bank, sp if alive else sp * 0, tp,
                                tr, False)
        out.append(sound[0].cpu().numpy())
    return np.concatenate(out)[:n_samples]


CPP = [("point", 0.0, "cpp_reference_point_1s.npy"),
       ("gaussian", 250.0, "cpp_reference_gaussian_1s.npy")]


@pytest.mark.parametrize("kind,width,name", CPP)
@pytest.mark.parametrize("backend,step,bar", [
    # the bars of tests/test_cpp_reference.py: the -60 dB contract, and
    # the blocked form's -100 dB headroom
    ("blocked", step_block_blocked, -100.0),
    ("fused", step_block_fused, -60.0),      # chunk min(64, 513) -> C = 27
    ("scan", step_block_scan, -60.0),        # the float32 recurrence
])
def test_backend_vs_cpp_reference(kind, width, name, backend, step, bar,
                                  dberr):
    ref = golden(name)
    if backend == "fused":
        step = lambda *a: step_block_fused(*a, chunk=27)   # noqa: E731
    got = render(step, kind, width, 513, ref.shape[0])
    err = dberr(got, ref)
    assert err <= bar, f"{backend} {kind}: {err:.1f} dB vs the C++ reference"


@pytest.mark.parametrize("kind,width,name", CPP)
def test_fused_at_the_cards_block_vs_cpp_reference(kind, width, name, dberr):
    """S = 512 in chunks of 64, the shape the kernel runs on the card."""
    ref = golden(name)
    got = render(step_block_fused, kind, width, 512, ref.shape[0])
    err = dberr(got, ref)
    assert err <= -100.0, f"fused {kind}: {err:.1f} dB vs the C++ reference"


def test_blocked_float64_matches_impulse_golden(dberr):
    """tests/test_golden.py's case: 25 blocks of 441 in float64."""
    ref = golden("impulse_24modes_quarter_sec.npy")
    got = render(step_block_blocked, "point", 0.0, 441, ref.shape[0],
                 dtype=torch.float64)
    assert dberr(got, ref) <= -140.0


def test_fused_float32_matches_impulse_golden(dberr):
    ref = golden("impulse_24modes_quarter_sec.npy")
    got = render(step_block_fused, "point", 0.0, 512, ref.shape[0])
    assert dberr(got, ref) <= -100.0
