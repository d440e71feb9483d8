"""Port parity: the numpy-only offline modules the port keeps its own
copies of (ops/ffat_fit.py's fitting functions, io/vectors.py and the
float64 oracle utils/oracle.py), each bitwise against its original on
the same inputs."""
import numpy as np
import pytest

from openpbso_tpu.io import vectors as j_vec
from openpbso_tpu.io.fatcube import FatcubeMap as JMap
from openpbso_tpu.ops import ffat_fit as j_fit
from openpbso_tpu.utils import oracle as j_or
from openpbso_tpu.utils.synth import CERAMIC
from openpbso_tpu.utils.synth import synth_cubemap_shell as j_shell
from openpbso_tpu.utils.synth import synth_fatcube as j_synth_fatcube
from openpbso_tpu_torch.io import vectors as t_vec
from openpbso_tpu_torch.io.fatcube import FatcubeMap as TMap
from openpbso_tpu_torch.ops import ffat_fit as t_fit
from openpbso_tpu_torch.utils import oracle as t_or
from openpbso_tpu_torch.utils.synth import synth_cubemap_shell as t_shell
from openpbso_tpu_torch.utils.synth import synth_fatcube as t_synth_fatcube

K = 2 * np.pi * 500.0 / 343.0
CENTER = np.zeros(3)


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _same_map(a, b):
    return (a.mode_id == b.mode_id and a.k == b.k
            and a.is_compressed == b.is_compressed
            and np.array_equal(a.center, b.center)
            and np.array_equal(a.psi, b.psi)
            and all(np.array_equal(getattr(a.shell, f),
                                   getattr(b.shell, f))
                    for f in vars(a.shell)))


def _field(points, axes):
    r = np.linalg.norm(points, axis=1)
    dirs = points / r[:, None]
    psi = np.ones(len(points))
    for ax in axes:
        psi = psi + 0.3 * np.tanh(dirs @ ax)
    return -1j * np.exp(-1j * K * r) / (K * r) * psi * 1e6


def test_shell_models_bitwise():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.3, 1.0, (20, 3)) * rng.choice([-1, 1], (20, 3))
    p = rng.standard_normal(20) + 1j * rng.standard_normal(20)
    psi = t_fit.solve_harmonic_shell(K, pts, CENTER, p)
    assert _same(psi, j_fit.solve_harmonic_shell(K, pts, CENTER, p))
    assert _same(t_fit.reconstruct_harmonic_shell(K, pts[3], CENTER, psi[3]),
                 j_fit.reconstruct_harmonic_shell(K, pts[3], CENTER, psi[3]))
    radii = rng.uniform(0.2, 1.0, (10, 3))
    pres = rng.uniform(0.5, 2.0, (10, 3))
    amp = t_fit.solve_amplitude(K, radii, pres)
    assert _same(amp, j_fit.solve_amplitude(K, radii, pres))
    assert _same(t_fit.reconstruct_amplitude(K, 2.0, amp[0]),
                 j_fit.reconstruct_amplitude(K, 2.0, amp[0]))
    assert _same(t_fit.power_scaling(K, radii, pres, amp),
                 j_fit.power_scaling(K, radii, pres, amp))


def test_fit_and_sample_bitwise():
    axes = np.random.default_rng(3).standard_normal((2, 3))
    tsh = [t_shell(CENTER, he, 8) for he in (0.2, 0.3, 0.45)]
    jsh = [j_shell(CENTER, he, 8) for he in (0.2, 0.3, 0.45)]
    pts = t_fit.cubemap_eval_points(tsh[0])
    assert _same(pts, j_fit.cubemap_eval_points(jsh[0]))
    pres = [_field(t_fit.cubemap_eval_points(s), axes) for s in tsh]
    tm = t_fit.fit_ffat_map(5, K, tsh, pres)
    jm = j_fit.fit_ffat_map(5, K, jsh, pres)
    assert isinstance(tm, TMap) and isinstance(jm, JMap)
    assert _same_map(tm, jm)
    probe = np.random.default_rng(4).uniform(-1.5, 1.5, (16, 3))
    assert _same(t_fit.batch_map_val(tm, probe),
                 j_fit.batch_map_val(jm, probe))
    assert _same(t_fit.batch_shell_samples(tsh[1], probe),
                 j_fit.batch_shell_samples(jsh[1], probe))


def test_resample_trimesh_compress_bitwise():
    tm, jm = t_synth_fatcube(2, 700.0, n=8, seed=9), j_synth_fatcube(
        2, 700.0, n=8, seed=9)
    assert _same_map(t_fit.resample_to_uniform(tm, tm.center, 0.3, 6),
                     j_fit.resample_to_uniform(jm, jm.center, 0.3, 6))
    assert _same(t_fit.map_to_trimesh(tm), j_fit.map_to_trimesh(jm))
    assert _same_map(t_fit.compress_map(tm), j_fit.compress_map(jm))


def test_read_n_elements_file_bitwise(tmp_path):
    path = str(tmp_path / "n_elements.txt")
    rows = np.random.default_rng(5).integers(2, 30, (3, 12))
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(map(str, r)) + "\n")
        f.write("\n")
    got = t_fit.read_n_elements_file(path)
    assert got.dtype == np.int32 and got.shape == (3, 6, 2)
    assert _same(got, j_fit.read_n_elements_file(path))
    with open(path, "w") as f:
        f.write("1 2 3\n")
    with pytest.raises(ValueError, match="6 'nu nv' pairs"):
        t_fit.read_n_elements_file(path)


@pytest.mark.parametrize("binary", [True, False])
def test_vectors_bitwise(tmp_path, binary):
    rng = np.random.default_rng(0)
    v = rng.standard_normal(17)
    c = rng.standard_normal(9) + 1j * rng.standard_normal(9)
    files = {}
    for name, mod in (("t", t_vec), ("j", j_vec)):
        pv = str(tmp_path / f"{name}.vec")
        pc = str(tmp_path / f"{name}.cplx")
        if binary:
            mod.write_vector_binary(pv, v)
        else:
            mod.write_vector_ascii(pv, v)
        mod.write_complex_vector(pc, c, binary=binary)
        files[name] = (pv, pc)
    for k in range(2):
        with open(files["t"][k], "rb") as a, open(files["j"][k], "rb") as b:
            assert a.read() == b.read()
    pv, pc = files["j"]
    read = t_vec.read_vector_binary if binary else t_vec.read_vector_ascii
    jread = j_vec.read_vector_binary if binary else j_vec.read_vector_ascii
    assert _same(read(pv), jread(pv))
    assert _same(t_vec.read_complex_vector(pc, binary=binary),
                 j_vec.read_complex_vector(pc, binary=binary))


def test_oracle_solver_bitwise():
    """The float64 oracle: coefficients, every force profile and the block
    loop with a transfer, the same numbers from both copies."""
    om2 = np.linspace(2e6, 4e8, 12)
    h = 1.0 / 44100
    coeffs = t_or.iir_coefficients(CERAMIC.density, om2, CERAMIC.alpha,
                                   CERAMIC.beta, h)
    assert _same(coeffs, j_or.iir_coefficients(
        CERAMIC.density, om2, CERAMIC.alpha, CERAMIC.beta, h))
    transfer = np.linspace(0.5, 2.0, 12) * 1e7
    out = []
    for mod in (t_or, j_or):
        s = mod.OracleSolver(*coeffs, 64, transfer=transfer)
        space = np.linspace(-1.0, 1.0, 12)
        s.hit(space, mod.OraclePointForce())
        s.hit(space[::-1], mod.OracleGaussianForce(300.0))
        s.hit(space * 0.5, mod.OracleHertzForce(2000.0))
        s.hit(space, mod.OracleARForce(seed=4))
        out.append((s.render(6), s.step()[1]))
    assert _same(out[0], out[1])


def test_oracle_ffat_lookup_bitwise():
    tm, jm = t_synth_fatcube(1, 500.0, n=6, seed=2), j_synth_fatcube(
        1, 500.0, n=6, seed=2)
    rng = np.random.default_rng(7)
    for p in rng.uniform(-1.5, 1.5, (12, 3)):
        assert _same(t_or.ffat_map_val(tm, p), j_or.ffat_map_val(jm, p))
        hit = t_or.ffat_intersect(tm, p)
        assert _same(hit, j_or.ffat_intersect(jm, p))
