"""Port parity: modal bank construction (openpbso_tpu_torch.ops.coeffs).

The host float64 math is a jax-free copy of the reference's, so it must be
bitwise equal; device tables are float32 casts of the same float64 tables,
so the bank tensors must be bitwise equal to the JAX bank's too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import coeffs as jc
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
from openpbso_tpu_torch.ops import coeffs as tc

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIELDS = ("lam_re", "lam_im", "b_re", "b_im", "mask", "pow_re", "pow_im")


def _modes(n, seed=3):
    return synth_mode_data(n, 8, seed=seed).omega_squared


def _hetero_lam(module, o, n):
    lams, bs, vs = [], [], []
    for i in range(o):
        md = synth_mode_data(n, 8, seed=100 + i, f_low=100.0 + i,
                             f_high=15000.0 + 3 * i)
        lam, b, v = module.lambda_from_modes(
            CERAMIC.density, md.omega_squared, CERAMIC.alpha, CERAMIC.beta)
        lams.append(lam)
        bs.append(b)
        vs.append(v)
    return np.stack(lams), np.stack(bs), np.stack(vs)


def _assert_bank_equal(tb, jb):
    for name in FIELDS:
        a, b = getattr(tb, name), getattr(jb, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == torch.float32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_lambda_from_modes_bitwise():
    # a zero and an overdamped mode exercise the invalid mask
    omega_sq = np.append(_modes(30), [0.0, 1e19])
    ref = jc.lambda_from_modes(CERAMIC.density, omega_sq, CERAMIC.alpha,
                               CERAMIC.beta)
    got = tc.lambda_from_modes(CERAMIC.density, omega_sq, CERAMIC.alpha,
                               CERAMIC.beta)
    assert not ref[2].all()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("powers", [64, np.array([0, 3, 512, 4096])])
def test_power_table_bitwise(powers):
    lam, _, _ = jc.lambda_from_modes(CERAMIC.density, _modes(20),
                                     CERAMIC.alpha, CERAMIC.beta)
    lam = np.append(lam, 0.0)   # a padding mode: 0^0 = 1, 0^d = 0
    np.testing.assert_array_equal(tc._power_table(lam, powers),
                                  jc._power_table(lam, powers))
    assert tc.round_up(129, 128) == jc.round_up(129, 128) == 256


@pytest.mark.parametrize("block_size", [None, 64])
def test_shared_bank_bitwise(block_size):
    args = (CERAMIC.density, _modes(40), CERAMIC.alpha, CERAMIC.beta)
    jb = jc.bank_from_material(*args, num_objects=3, block_size=block_size,
                               dtype=jnp.float32)
    tb = tc.bank_from_material(*args, num_objects=3, block_size=block_size,
                               device="cpu")
    _assert_bank_equal(tb, jb)
    assert tb.shared_tables == jb.shared_tables
    assert tb.block_size == jb.block_size
    assert (tb.num_objects, tb.num_modes) == (3, 128)


def test_hetero_bank_bitwise():
    lam, b, v = _hetero_lam(jc, 4, 40)
    jb = jc.build_modal_bank(lam, b, v, block_size=32, shared=False,
                             dtype=jnp.float32)
    tb = tc.build_modal_bank(lam, b, v, block_size=32, shared=False,
                             device="cpu")
    _assert_bank_equal(tb, jb)
    assert not tb.shared_tables and tb.pow_re.shape == (4, 128, 33)
    # shared=None detects distinct per-object modes
    assert not tc.build_modal_bank(lam, b, v, block_size=32,
                                   device="cpu").shared_tables


def test_chunk_tables_are_cached_exact_slices():
    lam, b, v = _hetero_lam(tc, 2, 24)
    bank = tc.build_modal_bank(lam, b, v, block_size=64, device="cpu")
    tr, ti = bank.chunk_tables(16)
    assert tr.shape == (2, 17, 128) and tr.is_contiguous()
    torch.testing.assert_close(tr, bank.pow_re[..., :17].transpose(1, 2),
                               rtol=0, atol=0)
    torch.testing.assert_close(ti, bank.pow_im[..., :17].transpose(1, 2),
                               rtol=0, atol=0)
    assert bank.chunk_tables(16)[0] is tr
    with pytest.raises(ValueError):
        bank.chunk_tables(64 + 1)
    table_less = tc.build_modal_bank(lam, b, v, device="cpu")
    with pytest.raises(ValueError):
        table_less.chunk_tables(16)


def test_bank_dtype_and_device_follow_arguments():
    bank = tc.bank_from_material(CERAMIC.density, _modes(8), CERAMIC.alpha,
                                 CERAMIC.beta, block_size=16,
                                 dtype=torch.float64, device="cpu")
    assert bank.pow_re.dtype == torch.float64
    assert bank.device == torch.device("cpu")
    ref = jax.tree.map(np.asarray, jc.bank_from_material(
        CERAMIC.density, _modes(8), CERAMIC.alpha, CERAMIC.beta,
        block_size=16, dtype=jnp.float64))
    np.testing.assert_array_equal(bank.pow_im.numpy(), ref.pow_im)
