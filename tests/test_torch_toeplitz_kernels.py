"""Port parity: the chunked span's within-chunk convolution, toeplitz_conv,
at the live stream's short chunks, against the JAX package's Toeplitz
einsum; its routing between the kernel's two variants and the refusals
its wrapper checks before building anything.

The same numpy inputs, made from a seed, go through the JAX package's
Toeplitz gather and einsum (openpbso_tpu/ops/span.py:574-585) and through
the port's wrapper, which runs its plain twin on CPU tensors. The bar is
the existing twin tests' (tests/test_torch_span.py), <= -120 dB in
float32. tests/test_torch_gpu.py and chip_smoke.py hold both CUDA
variants against the twin on a GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu_torch.bench.toeplitz_ab import toeplitz_matmul_call
from openpbso_tpu_torch.ops import toeplitz_conv as k2

O = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_toeplitz(g, fc):
    """openpbso_tpu/ops/span.py:575-585 on g [O, L, K, C]: the Toeplitz
    gather and the listener rows' einsum."""
    o, nl, k, c = g.shape
    delta = np.arange(c)[:, None] - np.arange(c)[None, :]
    t_g = jnp.take(g.reshape(o, nl * k, c), jnp.asarray(delta.clip(0)),
                   axis=-1) * jnp.asarray(delta >= 0, g.dtype)
    return jnp.einsum("olkcj,okxj->olxc", t_g.reshape(o, nl, k, c, c), fc,
                      precision=jax.lax.Precision.HIGHEST)


def _inputs(nl, k, x, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((O, nl, k, c)).astype(np.float32),
            rng.standard_normal((O, k, x, c)).astype(np.float32))


@pytest.mark.parametrize("nl,k,x,c", [
    (1, 17, 8, 64),     # the one-block span, a full bucket and the AR slot
    (2, 17, 8, 64),     # a binaural scene's two listener rows
    (1, 1, 8, 64),      # the plain stream's one slot
    (1, 17, 8, 256),    # the four-block span
    (1, 3, 5, 192),     # a three-block span, ragged chunks
    (2, 2, 3, 30),      # C not a multiple of 16 (nor of 4)
])
def test_toeplitz_twin_matches_jax_at_short_chunks(nl, k, x, c, dberr):
    g, f = _inputs(nl, k, x, c, seed=nl * 1000 + k * 10 + x)
    ref = np.asarray(_jax_toeplitz(jnp.asarray(g), jnp.asarray(f)))
    before = k2.LAUNCHES
    got = k2.toeplitz_conv(torch.from_numpy(g), torch.from_numpy(f))
    assert k2.LAUNCHES == before                  # CPU tensors: the twin
    assert got.shape == (O, nl, x, c) and got.dtype == torch.float32
    assert np.abs(ref).max() > 0
    assert dberr(got.numpy(), ref) <= -120


@pytest.mark.parametrize("args,want", [
    ((256, 1, 17, 8, 64), "short"),     # one-block span, full bucket + AR
    ((256, 1, 16, 8, 64), "short"),     # one-block span, full bucket
    ((256, 1, 2, 8, 64), "short"),      # one-block span, two slots
    ((256, 1, 1, 8, 64), "v3"),         # one-block span, plain stream
    ((256, 1, 17, 8, 256), "short"),    # four-block span, full bucket + AR
    ((256, 1, 8, 8, 256), "short"),     # four-block span, eight slots
    ((256, 1, 5, 8, 256), "v3"),        # four-block span, five slots
    ((256, 1, 1, 8, 256), "v3"),        # four-block span, plain stream
    ((256, 1, 1, 8, 192), "v3"),        # three-block span, plain stream
    ((256, 1, 17, 8, 192), "short"),    # three-block span, full bucket
    ((256, 1, 7, 8, 128), "v3"),        # two-block span, seven slots
    ((256, 2, 17, 8, 64), "short"),     # two listener rows
    ((256, 1, 17, 9, 64), "v3"),        # nine chunks
    ((256, 1, 17, 16, 256), "v3"),      # sixteen chunks
    ((256, 1, 1, 16, 512), "v3"),       # 5b's spans
    ((256, 1, 17, 8, 512), "v3"),       # eight chunks of 512
    ((256, 1, 1, 512, 512), "v3"),      # shared nb=512
])
def test_toeplitz_variant_by_shape(args, want):
    """The variant follows from the shape alone: the same answer every
    time, short for at most 8 chunks of at most 256 samples and enough
    slots (SHORT_SLOTS, the A/B's boundary)."""
    assert k2.variant_for(*args) == want
    assert k2.variant_for(*args) == want
    assert want in k2.VARIANTS


@pytest.mark.parametrize("x,c", [(9, 64), (16, 64), (8, 257), (8, 512)])
def test_short_variant_refuses_long_chunks(x, c):
    """The short variant takes at most 8 chunks of at most 256 samples;
    more raise before anything is built, whatever the device."""
    g, f = (torch.from_numpy(a) for a in _inputs(1, 2, x, c, seed=5))
    with pytest.raises(ValueError, match="short"):
        k2._launch(g, f, "short")


def test_toeplitz_wrapper_refuses_mixed_dtypes_before_building():
    g, f = (torch.from_numpy(a) for a in _inputs(1, 2, 8, 64, seed=6))
    with pytest.raises(ValueError, match="float32"):
        k2._launch(g.double(), f, "short")


@pytest.mark.parametrize("nl,k,x,c", [(1, 17, 8, 64), (2, 3, 5, 24)])
def test_matmul_yardstick_computes_the_toeplitz_conv(nl, k, x, c):
    """float64, so no rounding order can hide a wrong layout of the
    materialised operand."""
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal((O, nl, k, c)))
    f = torch.from_numpy(rng.standard_normal((O, k, x, c)))
    got = toeplitz_matmul_call(g, f)()
    assert got.shape == (O, nl, x, c)
    np.testing.assert_allclose(got.numpy(),
                               k2.toeplitz_conv_reference(g, f).numpy(),
                               rtol=1e-12, atol=1e-12)
