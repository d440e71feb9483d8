"""Port parity: FFAT transfer lookup (openpbso_tpu_torch.ops.ffat)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.ops import ffat as jf
from openpbso_tpu.utils.synth import synth_fatcube
from openpbso_tpu_torch.convert import ffat_from_numpy
from openpbso_tpu_torch.ops import ffat as tf

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


M = 8     # modes 0..5 carry maps, 6 and 7 do not
O = 3


def _maps(seed, center=(0.0, 0.0, 0.0)):
    return {i: synth_fatcube(i, 300.0 * (i + 1), center=center, n=6,
                             seed=seed) for i in range(6)}


def _build(hetero):
    if hetero:
        per_obj = [_maps(s, center=(0.01 * s, -0.02, 0.0)) for s in range(O)]
        return (jf.build_ffat_hetero(per_obj, M, dtype=jnp.float32),
                tf.build_ffat_hetero(per_obj, M, device="cpu"))
    maps = _maps(0)
    return (jf.build_ffat(maps, M, dtype=jnp.float32),
            tf.build_ffat(maps, M, device="cpu"))


def _listeners(shape):
    rng = np.random.default_rng(4)
    p = rng.uniform(-1.5, 1.5, shape)
    p[..., 2] += 0.5
    # include axis-aligned and corner-ward directions
    if len(shape) == 2:
        p[0] = (0.0, 0.0, 1.2)
        p[1] = (0.9, 0.9, 0.9)
    return p.astype(np.float32)


@pytest.mark.parametrize("hetero", [False, True])
def test_build_ffat_matches_jax(hetero):
    jmaps, tmaps = _build(hetero)
    for f in dataclasses.fields(tf.DeviceFFAT):
        np.testing.assert_array_equal(getattr(tmaps.geom, f.name).numpy(),
                                      np.asarray(getattr(jmaps.geom, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(tmaps.cell_size.numpy(),
                                  np.asarray(jmaps.cell_size))
    assert tmaps.geom.shared == (not hetero)


@pytest.mark.parametrize("listener", ["shared", "per_object"])
@pytest.mark.parametrize("hetero", [False, True])
def test_compute_transfer_matches_jax(hetero, listener, dberr):
    jmaps, _ = _build(hetero)
    tmaps = ffat_from_numpy(jax.tree.map(np.asarray, jmaps), device="cpu")
    pos = _listeners((3,) if listener == "shared" else (O, 3))
    ref = np.asarray(jf.compute_transfer(jmaps, jnp.asarray(pos)))
    got = tf.compute_transfer(tmaps, torch.from_numpy(pos))
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert (ref[..., 6:] == 0).all() and (got[..., 6:] == 0).all()
    assert dberr(got.numpy(), ref) <= -120


def test_compressed_texture_is_not_carried():
    maps = _maps(0)
    jmaps = jf.build_ffat(maps, M, dtype=jnp.float32, compressed_maps=maps)
    with pytest.raises(NotImplementedError, match="compressed"):
        ffat_from_numpy(jax.tree.map(np.asarray, jmaps), device="cpu")
