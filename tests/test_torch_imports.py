"""The port never imports jax nor anything of the JAX package, and
chip_smoke.py never falls back to the CPU."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RENDER_WITHOUT_JAX = r"""
import importlib, pkgutil, sys
import numpy as np
import openpbso_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from openpbso_tpu_torch.ops.coeffs import bank_from_material
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data
md = synth_mode_data(16, 4)
bank = bank_from_material(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                          CERAMIC.beta, num_objects=2, block_size=64,
                          device="cpu")
sess = ModalSession(bank, config=SolverConfig(block_size=64, backend="pallas"))
sess.hit(1, np.ones(16), kind="gaussian", width_us=300.0)
mix = sess.render(2)
assert mix.shape == (128, 2) and np.abs(mix).max() > 0
print(len(names), "jax" in sys.modules, reference_modules())
"""

# prepended to each script: the modules of the JAX package it has loaded
_DEF_REFERENCE_MODULES = r"""
import sys
def reference_modules():
    return ",".join(sorted(n for n in sys.modules if n == "openpbso_tpu"
                           or n.startswith("openpbso_tpu."))) or "none"
"""

_CHIP_SMOKE_WITHOUT_JAX = r"""
import chip_smoke
chip_smoke.kernel_modules()
chip_smoke.hetero_modes(2, 8)
chip_smoke.shared_modes(8)
print("jax" in sys.modules, reference_modules())
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"     # small tensors; the suite runs workers
    return env


def test_port_imports_and_renders_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _DEF_REFERENCE_MODULES
         + _RENDER_WITHOUT_JAX], capture_output=True, text=True, env=_env(),
        cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules, jax_loaded, reference = proc.stdout.split()
    assert int(n_modules) >= 20
    assert jax_loaded == "False"
    assert reference == "none"


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py, imported as a module (main not run), and the port
    modules its phases import lazily load neither jax nor openpbso_tpu."""
    proc = subprocess.run(
        [sys.executable, "-c", _DEF_REFERENCE_MODULES
         + _CHIP_SMOKE_WITHOUT_JAX], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "none"]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_exits_nonzero_without_a_gpu(where, tmp_path):
    """On a machine without CUDA, and in a directory that holds nothing of
    the repo but the script, chip_smoke.py must fail and print no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    if where == "repo":
        cwd, env = ROOT, _env()
    else:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd, env = str(tmp_path), dict(os.environ)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
