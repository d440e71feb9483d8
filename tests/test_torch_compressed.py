"""Port parity: the compressed FFAT texture (openpbso_tpu_torch.ops.ffat_fit
and the ``psi_c`` texture of ops/ffat.py) against the JAX package.

compress_map is bitwise the JAX package's (both branches); the packed
textures are bitwise; compressed lookups agree to <= -100 dB in float32 and
match the float64 oracle (utils/oracle.py) and the compiled C++ lookup
(tests/golden/cpp_reference_ffat.npz) in float64; the session's live toggle
switches the rows at once, as the JAX session's does
(tests/test_ffat.py:89-152, tests/test_ffat_fit.py:96-187).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpbso_tpu.io.fatcube import FatcubeMap as JMap
from openpbso_tpu.ops import ffat as jf
from openpbso_tpu.ops.coeffs import bank_from_material as j_bank
from openpbso_tpu.ops.ffat_fit import compress_map as j_compress
from openpbso_tpu.runtime.session import ModalSession as JSession
from openpbso_tpu.runtime.solver import SolverConfig as JConfig
from openpbso_tpu.utils.oracle import ffat_map_val
from openpbso_tpu.utils.synth import (CERAMIC, synth_cubemap_shell,
                                      synth_fatcube, synth_mode_data)
from openpbso_tpu_torch.convert import bank_from_numpy, ffat_from_numpy
from openpbso_tpu_torch.io.fatcube import FatcubeMap as TMap
from openpbso_tpu_torch.ops import ffat as tf
from openpbso_tpu_torch.ops.ffat_fit import compress_map as t_compress
from openpbso_tpu_torch.runtime.session import ModalSession as TSession
from openpbso_tpu_torch.runtime.solver import SolverConfig as TConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


M, O = 8, 3     # modes 0..5 carry maps


def _maps(seed, center=(0.0, 0.0, 0.0)):
    return {i: synth_fatcube(i, 300.0 * (i + 1), center=center, n=6,
                             seed=seed) for i in range(6)}


def _tmap(m):
    """The port's FatcubeMap with the JAX one's fields (the two io copies
    are held equal by tests/test_torch_io.py)."""
    return TMap(mode_id=m.mode_id, k=m.k, center=m.center.copy(),
                shell=m.shell, psi=m.psi.copy(),
                is_compressed=m.is_compressed)


def _listeners(shape, seed=4):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.5, 1.5, shape)
    p[..., 2] += 0.5
    return p.astype(np.float32)


@pytest.mark.parametrize("quality", [None, 65, 90])
@pytest.mark.parametrize("seed", [1, 2])
def test_compress_map_matches_jax_bitwise(quality, seed):
    m = synth_fatcube(1, 700.0, n=8, seed=seed)
    ref = j_compress(m, jpeg_quality=quality)
    got = t_compress(_tmap(m), jpeg_quality=quality)
    assert isinstance(got, TMap) and got.is_compressed
    np.testing.assert_array_equal(got.psi, ref.psi)
    np.testing.assert_array_equal(got.center, ref.center)
    assert got.k == ref.k and got.mode_id == ref.mode_id
    assert got.shell is m.shell
    assert not np.array_equal(got.psi, m.psi)    # a lossy texture


def test_compress_map_signed_and_quantization_floor():
    """Negative psi survive both branches; the uint8 stand-in stays within
    half a step of each face's peak (tests/test_ffat_fit.py:96-112)."""
    shell = synth_cubemap_shell(np.zeros(3), 0.2, 6)
    rng = np.random.default_rng(4)
    psi = rng.uniform(-1e6, 1e6, shell.total_quads)
    m = TMap(mode_id=0, k=3.0, center=np.zeros(3), shell=shell, psi=psi)
    u8 = t_compress(m)
    assert np.abs(u8.psi - psi).max() <= np.abs(psi).max() / 255.0 + 1e-9
    assert (u8.psi < 0).any()
    jm = JMap(mode_id=0, k=3.0, center=np.zeros(3), shell=shell, psi=psi)
    np.testing.assert_array_equal(t_compress(m, jpeg_quality=65).psi,
                                  j_compress(jm, jpeg_quality=65).psi)


@pytest.mark.parametrize("hetero", [False, True])
def test_build_ffat_compressed_matches_jax(hetero):
    if hetero:
        per_obj = [_maps(s, center=(0.01 * s, -0.02, 0.0)) for s in range(O)]
        comp = [{i: j_compress(m) for i, m in mp.items()} for mp in per_obj]
        jmaps = jf.build_ffat_hetero(per_obj, M, dtype=jnp.float32,
                                     compressed_maps=comp)
        tmaps = tf.build_ffat_hetero(per_obj, M, device="cpu",
                                     compressed_maps=comp)
    else:
        maps = _maps(0)
        comp = {i: j_compress(m) for i, m in maps.items()}
        jmaps = jf.build_ffat(maps, M, dtype=jnp.float32,
                              compressed_maps=comp)
        tmaps = tf.build_ffat(maps, M, device="cpu", compressed_maps=comp)
    for f in dataclasses.fields(tf.DeviceFFAT):
        np.testing.assert_array_equal(getattr(tmaps.geom, f.name).numpy(),
                                      np.asarray(getattr(jmaps.geom, f.name)),
                                      err_msg=f.name)
    assert not torch.equal(tmaps.geom.psi, tmaps.geom.psi_c)


def test_build_ffat_auto_compression_matches_jax():
    """compressed_maps="auto": every map through compress_map at the
    reference tool's JPEG quality 65."""
    maps = _maps(3)
    jmaps = jf.build_ffat(maps, M, dtype=jnp.float32, compressed_maps="auto")
    tmaps = tf.build_ffat(maps, M, device="cpu", compressed_maps="auto")
    np.testing.assert_array_equal(tmaps.geom.psi_c.numpy(),
                                  np.asarray(jmaps.geom.psi_c))


def test_hetero_texture_needs_every_object():
    """A heterogeneous set keeps the second texture only when every object
    has one, as the JAX package does; an empty dict is no texture."""
    per_obj = [_maps(s) for s in range(O)]
    comp = [{i: j_compress(m) for i, m in per_obj[0].items()}, {}, None]
    tmaps = tf.build_ffat_hetero(per_obj, M, device="cpu",
                                 compressed_maps=comp)
    jmaps = jf.build_ffat_hetero(per_obj, M, compressed_maps=comp)
    assert tmaps.geom.psi_c is None and jmaps.geom.psi_c is None
    assert tf.build_ffat(per_obj[0], M, device="cpu",
                         compressed_maps={}).geom.psi_c is None


@pytest.mark.parametrize("listener", ["shared", "per_object"])
@pytest.mark.parametrize("hetero", [False, True])
def test_compressed_transfer_matches_jax(hetero, listener, dberr):
    if hetero:
        per_obj = [_maps(s, center=(0.01 * s, -0.02, 0.0)) for s in range(O)]
        jmaps = jf.build_ffat_hetero(per_obj, M, dtype=jnp.float32,
                                     compressed_maps="auto")
    else:
        jmaps = jf.build_ffat(_maps(0), M, dtype=jnp.float32,
                              compressed_maps="auto")
    tmaps = ffat_from_numpy(jax.tree.map(np.asarray, jmaps), device="cpu")
    pos = _listeners((3,) if listener == "shared" else (O, 3))
    for compressed in (False, True):
        ref = np.asarray(jf.compute_transfer(jmaps, jnp.asarray(pos),
                                             compressed=compressed))
        got = tf.compute_transfer(tmaps, torch.from_numpy(pos),
                                  compressed=compressed)
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert dberr(got.numpy(), ref) <= -100
    raw = tf.compute_transfer(tmaps, torch.from_numpy(pos))
    comp = tf.compute_transfer(tmaps, torch.from_numpy(pos), compressed=True)
    assert not torch.equal(raw, comp)


def test_compressed_lookup_matches_oracle_and_cpp_golden(dberr):
    """In float64 the compressed texture answers as the scalar oracle does
    on the compressed map; with the raw map installed as the second
    texture, compressed lookups reproduce the C++ GetMapVal golden."""
    maps = {i: synth_fatcube(i, 200.0 * (i + 1), n=10, seed=11)
            for i in range(6)}
    cmaps = {i: t_compress(_tmap(m)) for i, m in maps.items()}
    ffat = tf.build_ffat(maps, 6, dtype=torch.float64, device="cpu",
                         compressed_maps=cmaps)
    rng = np.random.default_rng(6)
    for _ in range(8):
        p = rng.uniform(-1.5, 1.5, 3)
        if np.max(np.abs(p)) < 0.4:
            p[np.argmax(np.abs(p))] = 0.8
        comp = tf.compute_transfer(ffat, torch.from_numpy(p),
                                   compressed=True)[0].numpy()
        ref = np.array([ffat_map_val(cmaps[i], p) for i in range(6)])
        np.testing.assert_allclose(comp, ref, rtol=1e-9, atol=1e-12)

    data = np.load(os.path.join(GOLDEN, "cpp_reference_ffat.npz"))
    m = synth_fatcube(0, 700.0, n=14, seed=11)
    golden = tf.build_ffat({0: m}, 1, dtype=torch.float64, device="cpu",
                           compressed_maps={0: m})
    dev = np.array([tf.compute_transfer(golden, torch.from_numpy(p),
                                        compressed=True)[0, 0].item()
                    for p in data["listeners"]])
    assert dberr(dev, data["values"]) < -200


def test_compressed_without_second_texture_raises():
    tmaps = tf.build_ffat(_maps(0), M, device="cpu")
    assert tmaps.geom.psi_c is None
    with pytest.raises(ValueError, match="compressed"):
        tf.compute_transfer(tmaps, torch.full((3,), 0.8), compressed=True)


def _sessions(compressed=True, num_listeners=1):
    md = synth_mode_data(6, 8, seed=3)
    jbank = j_bank(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                   CERAMIC.beta, num_objects=2, block_size=64,
                   dtype=jnp.float32)
    maps = _maps(5)
    jffat = jf.build_ffat(maps, jbank.num_modes, dtype=jnp.float32,
                          compressed_maps="auto" if compressed else None)
    tbank = bank_from_numpy(jax.tree.map(np.asarray, jbank), device="cpu")
    tffat = ffat_from_numpy(jax.tree.map(np.asarray, jffat), device="cpu")
    js = JSession(jbank, jffat, JConfig(block_size=64, backend="blocked"),
                  num_listeners=num_listeners)
    ts = TSession(tbank, tffat, TConfig(block_size=64, backend="blocked"),
                  num_listeners=num_listeners)
    return js, ts


@pytest.mark.parametrize("num_listeners", [1, 2])
def test_session_toggle_matches_jax(num_listeners, dberr):
    """set_use_compressed re-queries the last listener against the other
    texture at once (tests/test_ffat.py:122-151), in both packages."""
    js, ts = _sessions(num_listeners=num_listeners)
    pos = (np.asarray([0.9, 0.2, 0.1]) if num_listeners == 1
           else np.asarray([[0.9, 0.2, 0.1], [-0.7, 0.4, 0.3]]))
    for s in (js, ts):
        s.set_listener(pos)
    raw = ts.state.transfer.clone()
    for s in (js, ts):
        s.set_use_compressed(True)
    comp = ts.state.transfer.clone()
    assert ts.use_compressed and not torch.equal(raw, comp)
    assert dberr(comp.numpy(), np.asarray(js.state.transfer)) <= -100
    rows = ts.state.transfer
    ts.set_use_compressed(True)                  # no change, no recompute
    assert ts.state.transfer is rows
    ts.set_use_compressed(False)
    torch.testing.assert_close(ts.state.transfer, raw, rtol=0, atol=0)


def test_session_toggle_refusals():
    _, ts = _sessions(compressed=False)
    with pytest.raises(ValueError, match="compressed"):
        ts.set_use_compressed(True)
    ts.set_use_compressed(False)                 # turning it off is fine
    assert not ts.use_compressed


def test_session_toggle_without_listener_waits_for_one():
    """Before any listener the toggle only selects the texture; the next
    move samples it."""
    js, ts = _sessions()
    for s in (js, ts):
        s.set_use_compressed(True)
    assert torch.equal(ts.state.transfer,
                       torch.full_like(ts.state.transfer, 1e7))
    pos = np.asarray([0.4, -0.8, 0.6])
    for s in (js, ts):
        s.set_listener(pos)
    want = tf.compute_transfer(ts.ffat, torch.as_tensor(
        np.tile(pos, (2, 1)), dtype=torch.float32), compressed=True)
    torch.testing.assert_close(ts.state.transfer, want, rtol=0, atol=0)


def test_warmup_runs_both_textures_without_a_trace(monkeypatch):
    """warmup probes the lookup from the texture in use and the other one,
    and leaves state and selection bitwise as it found them."""
    import openpbso_tpu_torch.runtime.session as sess_mod
    _, ts = _sessions(num_listeners=2)
    ts.set_listener(np.asarray([0.9, 0.2, 0.1]))
    calls = []

    def counted(ffat, listener, compressed=False):
        calls.append(compressed)
        return tf.compute_transfer(ffat, listener, compressed=compressed)
    monkeypatch.setattr(sess_mod, "compute_transfer", counted)
    before = ts.state.transfer.clone()
    ts.warmup()
    assert set(calls) == {False, True} and not ts.use_compressed
    assert torch.equal(ts.state.transfer, before)
