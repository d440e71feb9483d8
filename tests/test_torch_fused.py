"""Port parity: the fused per-block step (openpbso_tpu_torch.ops.fused_integrator).

On the CPU the wrapper runs its plain twin, fused_block_reference, which is
held against the JAX Pallas kernel run in interpret mode (the way the JAX
package's own tests run it) and against the JAX blocked backend. The CUDA
kernel itself is compared with the twin on a GPU by tests/test_torch_gpu.py
and chip_smoke.py.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.ops.integrator import step_block_blocked as j_blocked
from openpbso_tpu.ops.pallas_integrator import step_block_pallas
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.convert import bank_from_numpy
from openpbso_tpu_torch.ops import fused_integrator as fi

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


j_pallas = partial(step_block_pallas, interpret=True)


def _jax_bank(o, n, s, hetero):
    if not hetero:
        md = synth_mode_data(n, 8, seed=5)
        return bank_from_material(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                                  block_size=s, dtype=jnp.float32)
    parts = [lambda_from_modes(CERAMIC.density, synth_mode_data(
        n, 8, seed=100 + i, f_low=100.0 + i,
        f_high=15000.0 + 3 * i).omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for i in range(o)]
    lam, b, v = (np.stack(x) for x in zip(*parts))
    return build_modal_bank(lam, b, v, block_size=s, shared=False,
                            dtype=jnp.float32)


def _case(o, n, s, hetero=False, seed=5):
    jb = _jax_bank(o, n, s, hetero)
    tb = bank_from_numpy(jax.tree.map(np.asarray, jb))
    m = jb.num_modes
    mask = np.asarray(jb.mask)
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((o, m)) * mask,       # z_re
         rng.standard_normal((o, m)) * mask,       # z_im
         rng.standard_normal((o, m)) * mask,       # space
         rng.standard_normal((o, s)),              # time profile
         rng.uniform(0.5, 2.0, (o, m))]            # transfer
    x = [a.astype(np.float32) for a in x]
    return jb, tb, x


def _run_jax(fn, jb, x, **kw):
    zr, zi, sp, tp, tr = (jnp.asarray(a) for a in x)
    return [np.asarray(r) for r in fn(zr, zi, jb, sp, tp, tr, False, **kw)[:3]]


def _run_port(fn, tb, x, **kw):
    zr, zi, sp, tp, tr = (torch.from_numpy(a) for a in x)
    return [r.numpy() for r in fn(zr, zi, tb, sp, tp, tr, **kw)[:3]]


def _assert_db(got, ref, dberr, bar):
    for name, a, b in zip(("z_re", "z_im", "sound"), got, ref):
        assert dberr(a, b) <= bar, (name, dberr(a, b))


@pytest.mark.parametrize("o,n,s,chunk,hetero", [
    (1, 40, 256, 64, False),
    (3, 40, 256, 64, False),
    (8, 40, 256, 128, False),
    (5, 40, 256, 64, True),
    (2, 24, 32, 64, True),        # chunk > S clamps to one chunk
])
def test_reference_matches_pallas_interpret(o, n, s, chunk, hetero, dberr):
    jb, tb, x = _case(o, n, s, hetero)
    ref = _run_jax(j_pallas, jb, x, chunk=chunk)
    got = _run_port(fi.fused_block_reference, tb, x, chunk=chunk)
    _assert_db(got, ref, dberr, -110)
    # the CPU wrapper is the twin itself
    wrapped = _run_port(fi.step_block_fused, tb, x, chunk=chunk)
    for a, b in zip(wrapped, got):
        np.testing.assert_array_equal(a, b)


def test_reference_matches_jax_blocked(dberr):
    jb, tb, x = _case(5, 40, 256, hetero=True)
    ref = _run_jax(j_blocked, jb, x)
    got = _run_port(fi.step_block_fused, tb, x)
    _assert_db(got, ref, dberr, -90)


def test_chained_blocks_match_pallas(dberr):
    """State threads across three consecutive blocks."""
    jb, tb, x = _case(2, 24, 128, hetero=True)
    jx, tx = list(x), list(x)
    j_sounds, t_sounds = [], []
    for _ in range(3):
        zr, zi, snd = _run_jax(j_pallas, jb, jx, chunk=64)
        jx[:2] = [zr, zi]
        j_sounds.append(snd)
        zr, zi, snd = _run_port(fi.step_block_fused, tb, tx, chunk=64)
        tx[:2] = [zr, zi]
        t_sounds.append(snd)
    assert dberr(np.concatenate(t_sounds, -1),
                 np.concatenate(j_sounds, -1)) <= -100
    assert dberr(np.stack(tx[:2]), np.stack(jx[:2])) <= -100


def test_cpu_run_launches_no_kernel():
    _, tb, x = _case(3, 40, 256, hetero=True)
    before = fi.LAUNCHES
    _run_port(fi.step_block_fused, tb, x)
    assert fi.LAUNCHES == before == 0


def test_contract_errors():
    _, tb, x = _case(2, 24, 96, hetero=True)
    zr, zi, sp, tp, tr = (torch.from_numpy(a) for a in x)
    with pytest.raises(NotImplementedError, match="qnorm"):
        fi.step_block_fused(zr, zi, tb, sp, tp, tr, True)
    with pytest.raises(ValueError, match="complex"):
        fi.step_block_fused(zr, zi, tb, sp, tp, tr, transfer_im=tr)
    with pytest.raises(ValueError, match="multiple of chunk"):
        fi.step_block_fused(zr, zi, tb, sp, tp, tr, chunk=64)   # 96 % 64
    with pytest.raises(ValueError, match="shorter"):   # tables hold 97
        fi.fused_block_reference(zr, zi, tb, sp, torch.zeros(2, 256), tr,
                                 chunk=128)
    with pytest.raises(ValueError, match="shared memory"):
        fi._tile_modes(512, 1024, lambda tm, s, c: 8 * (c + 1) * tm)


def test_tile_choice_fits_shared_memory():
    """The widest mode tile whose shared memory fits is taken."""
    def smem(tm, s, c):       # any size that grows with tile and chunk
        return tm * (c + 1) * 16
    assert fi._tile_modes(512, 64, smem) == 128
    assert fi._tile_modes(512, 128, smem) == 64
    assert fi._tile_modes(512, 256, smem) == 32
