"""Port parity: the port's own copies of the JAX package's numpy-only
modules (config, io, utils.synth, models.modal_model) against the
originals, bitwise on seeded inputs."""
import os

import numpy as np
import pytest
import torch

from openpbso_tpu import config as jconfig
from openpbso_tpu.io import fatcube as jfc
from openpbso_tpu.io import material as jmat
from openpbso_tpu.io import meta as jmeta
from openpbso_tpu.io import mode_data as jmd
from openpbso_tpu.io import objmesh as jmesh
from openpbso_tpu.models import modal_model as jmm
from openpbso_tpu.utils import synth as jsynth
from openpbso_tpu_torch import config as tconfig
from openpbso_tpu_torch.io import fatcube as tfc
from openpbso_tpu_torch.io import material as tmat
from openpbso_tpu_torch.io import meta as tmeta
from openpbso_tpu_torch.io import mode_data as tmd
from openpbso_tpu_torch.io import objmesh as tmesh
from openpbso_tpu_torch.models import modal_model as tmm
from openpbso_tpu_torch.utils import synth as tsynth


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _assert_maps_equal(got, ref):
    """A port FatcubeMap against a JAX one, field by field, bitwise."""
    assert jfc.maps_match_bits(got, ref)
    assert type(got) is tfc.FatcubeMap and type(got.shell) is tfc.CubemapShell


@pytest.mark.parametrize("name", [
    "SAMPLE_RATE", "FRAMES_PER_BUFFER", "DEFAULT_BLOCK", "MODAL_GAIN",
    "UNIT_TRANSFER", "OUTPUT_SCALE", "DEFAULT_AUDIBLE_FREQ", "FILE_NOT_EXIST",
    "REBASE_PERIOD", "SOUND_SPEED"])
def test_config_constants_match_jax(name):
    got, ref = getattr(tconfig, name), getattr(jconfig, name)
    assert type(got) is type(ref) and got == ref


@pytest.mark.parametrize("num_modes,num_vertices,seed,f_low,f_high", [
    (24, 8, 0, 120.0, 15000.0),
    (1024, 8, 100, 100.0, 15000.0),
    (7, 42, 3, 250.0, 9000.0),
])
def test_synth_mode_data_matches_jax(num_modes, num_vertices, seed, f_low,
                                     f_high):
    kw = dict(seed=seed, f_low=f_low, f_high=f_high)
    got = tsynth.synth_mode_data(num_modes, num_vertices, **kw)
    ref = jsynth.synth_mode_data(num_modes, num_vertices, **kw)
    np.testing.assert_array_equal(got.omega_squared, ref.omega_squared)
    np.testing.assert_array_equal(got.modes, ref.modes)
    assert got.num_modes == ref.num_modes and got.num_dof == ref.num_dof
    np.testing.assert_array_equal(got.frequencies_hz(2700.0),
                                  ref.frequencies_hz(2700.0))
    for freq in (50.0, 3000.0, 20000.0):
        assert (got.num_modes_audible(2700.0, freq)
                == ref.num_modes_audible(2700.0, freq))


def test_ceramic_material_matches_jax():
    got, ref = tsynth.CERAMIC, jsynth.CERAMIC
    assert (got.density, got.youngs_modulus, got.poisson_ratio, got.alpha,
            got.beta, got.name) == (ref.density, ref.youngs_modulus,
                                    ref.poisson_ratio, ref.alpha, ref.beta,
                                    ref.name)


@pytest.mark.parametrize("mode_id,freq,center,n,seed", [
    (0, 120.0, (0.0, 0.0, 0.0), 20, 0),
    (5, 3100.5, (0.01, -0.02, 0.3), 6, 4),
    (1023, 15000.0, (0.0, 0.0, 0.0), 16, 0),
])
def test_synth_fatcube_writes_and_decodes_as_jax(tmp_path, mode_id, freq,
                                                 center, n, seed):
    got = tsynth.synth_fatcube(mode_id, freq, center=center, n=n, seed=seed)
    ref = jsynth.synth_fatcube(mode_id, freq, center=center, n=n, seed=seed)
    assert jfc.maps_match_bits(got, ref)
    assert tfc.encode_fatcube(got) == jfc.encode_fatcube(ref)
    path = str(tmp_path / f"{mode_id:06d}.fatcube")
    tfc.save_fatcube(path, got)
    assert _read(path) == jfc.encode_fatcube(ref)
    _assert_maps_equal(tfc.load_fatcube(path), jfc.load_fatcube(path))
    _assert_maps_equal(tfc.decode_fatcube(_read(path)), ref)


def test_decode_of_the_reference_golden_fatcube_matches_jax():
    """A file the C++ reference wrote with protobuf (mode 0: the mode id
    field omitted)."""
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "cpp_protobuf_mode0.fatcube")
    _assert_maps_equal(tfc.load_fatcube(path), jfc.load_fatcube(path))


def test_decoder_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="missing shell"):
        tfc.decode_fatcube(b"")
    with pytest.raises(ValueError, match="truncated"):
        tfc.decode_fatcube(jfc.encode_fatcube(
            jsynth.synth_fatcube(1, 500.0, n=4))[:-3])


@pytest.mark.parametrize("comment", ["", "synthetic"])
def test_material_round_trip_matches_jax(tmp_path, comment):
    mat = tmat.ModalMaterial(density=1250.5, youngs_modulus=3.3e9,
                             poisson_ratio=0.37, alpha=2.5, beta=4e-8)
    tpath, jpath = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tmat.write_material(tpath, mat, comment=comment)
    jmat.write_material(jpath, jmat.ModalMaterial(
        density=1250.5, youngs_modulus=3.3e9, poisson_ratio=0.37, alpha=2.5,
        beta=4e-8), comment=comment)
    assert _read(tpath) == _read(jpath)
    got, ref = tmat.read_material(tpath), jmat.read_material(tpath)
    assert (got.density, got.youngs_modulus, got.poisson_ratio, got.alpha,
            got.beta, got.name) == (ref.density, ref.youngs_modulus,
                                    ref.poisson_ratio, ref.alpha, ref.beta,
                                    ref.name)


@pytest.mark.parametrize("num_modes,num_vertices", [(24, 12), (3, 162)])
def test_modes_round_trip_matches_jax(tmp_path, num_modes, num_vertices):
    data = tsynth.synth_mode_data(num_modes, num_vertices, seed=9)
    tpath, jpath = str(tmp_path / "t.modes"), str(tmp_path / "j.modes")
    tmd.write_modes(tpath, data)
    jmd.write_modes(jpath, jsynth.synth_mode_data(num_modes, num_vertices,
                                                  seed=9))
    assert _read(tpath) == _read(jpath)
    got, ref = tmd.read_modes(tpath), jmd.read_modes(tpath)
    np.testing.assert_array_equal(got.omega_squared, ref.omega_squared)
    np.testing.assert_array_equal(got.modes, ref.modes)


def test_read_modes_refuses_a_corrupt_header_as_jax(tmp_path):
    path = str(tmp_path / "bad.modes")
    np.asarray([1 << 30, 1 << 30], dtype="<i4").tofile(path)
    for mod in (tmd, jmd):
        with pytest.raises(ValueError, match="header claims"):
            mod.read_modes(path)


@pytest.mark.parametrize("subdivisions", [0, 1, 2])
def test_mesh_io_matches_jax(tmp_path, subdivisions):
    v, f = tmesh.icosphere(subdivisions=subdivisions, radius=0.05)
    jv, jf = jmesh.icosphere(subdivisions=subdivisions, radius=0.05)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(tmesh.per_vertex_normals(v, f),
                                  jmesh.per_vertex_normals(jv, jf))
    tpath, jpath = str(tmp_path / "t.obj"), str(tmp_path / "j.obj")
    tmesh.write_obj(tpath, v, f)
    jmesh.write_obj(jpath, jv, jf)
    assert _read(tpath) == _read(jpath)
    for got, ref in zip(tmesh.read_obj(tpath), jmesh.read_obj(tpath)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("num_modes,freq_threshold", [(24, 20000.0),
                                                      (12, 2000.0),
                                                      (6, None)])
def test_load_model_on_a_synth_model_dir_matches_jax(tmp_path, num_modes,
                                                     freq_threshold):
    kw = dict(num_modes=num_modes, freq_threshold=freq_threshold, seed=2)
    tdir = tsynth.synth_model_dir(str(tmp_path / "t"), **kw)
    jdir = jsynth.synth_model_dir(str(tmp_path / "j"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, n), tdir)
                   for d, _, names in os.walk(tdir) for n in names)
    assert files == sorted(os.path.relpath(os.path.join(d, n), jdir)
                           for d, _, names in os.walk(jdir) for n in names)
    for rel in files:
        assert _read(os.path.join(tdir, rel)) == _read(os.path.join(jdir, rel))

    paths = tmeta.resolve_model_dir(tdir)
    jpaths = jmeta.resolve_model_dir(tdir)
    assert (paths.obj_file, paths.modes_file, paths.material_file,
            paths.ffat_dir) == (jpaths.obj_file, jpaths.modes_file,
                                jpaths.material_file, jpaths.ffat_dir)
    got, ref = tmm.load_model(paths), jmm.load_model(jpaths)
    assert got.name == ref.name
    assert got.num_modes_audible == ref.num_modes_audible
    for name in ("vertices", "faces", "normals"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    np.testing.assert_array_equal(got.modes.modes, ref.modes.modes)
    np.testing.assert_array_equal(got.modes.omega_squared,
                                  ref.modes.omega_squared)
    assert got.material.density == ref.material.density
    assert sorted(got.ffat_maps) == sorted(ref.ffat_maps)
    for mode_id, m in got.ffat_maps.items():
        _assert_maps_equal(m, ref.ffat_maps[mode_id])
    np.testing.assert_array_equal(got.modal_force_vertex(3),
                                  ref.modal_force_vertex(3))
    face = (np.array([0, 1, 2]), np.array([0.2, 0.3, 0.5]),
            np.array([0.0, 0.6, 0.8]))
    np.testing.assert_array_equal(got.modal_force_face(*face),
                                  ref.modal_force_face(*face))


def test_load_model_refuses_a_dof_mismatch_as_jax(tmp_path):
    root = tsynth.synth_model_dir(str(tmp_path), num_modes=4)
    paths = tmeta.resolve_model_dir(root)
    tmd.write_modes(paths.modes_file, tsynth.synth_mode_data(4, 5))
    for load, resolve in ((tmm.load_model, tmeta.resolve_model_dir),
                          (jmm.load_model, jmeta.resolve_model_dir)):
        with pytest.raises(ValueError, match="DOF mismatch"):
            load(resolve(root))
