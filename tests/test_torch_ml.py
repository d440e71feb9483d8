"""Port parity: ml/ (features, the AR model fit, the training-set formats,
synthesize_dataset through the port's session, the study) and the
session's render_raw, against the JAX package on the same numpy inputs.

The numpy-only modules are the port's own copies and are held bitwise;
the synthesized clips go through the two packages' sessions and are held
to <= -100 dB.
"""
import numpy as np
import pytest
import torch

from openpbso_tpu.ml import ar_model as j_ar
from openpbso_tpu.ml import dataset as j_ds
from openpbso_tpu.ml import features as j_feat
from openpbso_tpu.ml import train as j_train
from openpbso_tpu_torch.ml import ar_model as t_ar
from openpbso_tpu_torch.ml import dataset as t_ds
from openpbso_tpu_torch.ml import features as t_feat
from openpbso_tpu_torch.ml import train as t_train


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_feature_layout_is_the_reference():
    assert t_feat.FEATURE_NAMES == j_feat.FEATURE_NAMES
    assert t_feat.NUM_FEATURES == j_feat.NUM_FEATURES == 34


@pytest.mark.parametrize("kind", ["noise", "tone", "decay"])
def test_features_bitwise(kind):
    rng = np.random.default_rng(1)
    t = np.arange(44100 // 4) / 44100
    sig = {"noise": rng.standard_normal(t.size),
           "tone": np.sin(2 * np.pi * 440.0 * t),
           "decay": np.exp(-8 * t) * np.sin(2 * np.pi * 1200.0 * t)}[kind]
    assert np.array_equal(t_feat.short_term_features(sig),
                          j_feat.short_term_features(sig))
    assert np.array_equal(t_feat.clip_features(sig),
                          j_feat.clip_features(sig))


def test_embed_features_bitwise():
    x = np.random.default_rng(0).standard_normal((30, 10))
    assert np.array_equal(t_feat.embed_features(x, "pca"),
                          j_feat.embed_features(x, "pca"))


def test_ar_model_bitwise():
    p = t_ar.ARParams(a=(0.7, 0.1), sigma=0.002, mu=0.3)
    jp = j_ar.ARParams(a=(0.7, 0.1), sigma=0.002, mu=0.3)
    trace = t_ar.generate(p, 20000, seed=2)
    assert np.array_equal(trace, j_ar.generate(jp, 20000, seed=2))
    est, jest = t_ar.estimate(trace), j_ar.estimate(trace)
    assert (est.a, est.sigma, est.mu) == (jest.a, jest.sigma, jest.mu)
    for a, b in zip(t_ar.spectrum(p), j_ar.spectrum(jp)):
        assert np.array_equal(a, b)


def test_bank_format_bitwise(tmp_path):
    rows = np.random.default_rng(0).standard_normal((5, 7))
    tp, jp = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
    t_ds.write_bank(tp, rows)
    j_ds.write_bank(jp, rows)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(t_ds.read_bank(jp, 7), rows)
    assert np.array_equal(j_ds.read_bank(tp, 7), rows)


def test_materials_are_the_reference_set():
    assert t_ds.MATERIALS.keys() == j_ds.MATERIALS.keys()
    for k, v in t_ds.MATERIALS.items():
        j = j_ds.MATERIALS[k]
        assert (v.density, v.youngs_modulus, v.poisson_ratio, v.alpha,
                v.beta) == (j.density, j.youngs_modulus, j.poisson_ratio,
                            j.alpha, j.beta)


KW = dict(objects_per_material=2, hits_per_object=2, num_modes=24,
          seconds=0.05, block=256, seed=3)


@pytest.fixture(scope="module")
def clips():
    """Both packages' clips of three materials (seconds=0.05: 8 blocks)."""
    mats = dict(list(t_ds.MATERIALS.items())[:3])
    jmats = {k: j_ds.MATERIALS[k] for k in mats}
    return (t_ds.synthesize_dataset(materials=mats, device="cpu", **KW),
            j_ds.synthesize_dataset(materials=jmats, **KW))


def test_synthesize_dataset_matches_jax(clips, dberr):
    got, want = clips
    assert len(got) == len(want) == 3 * 2 * 2
    for g, w in zip(got, want):
        assert (g.material, g.object_id, g.hit_id) == (
            w.material, w.object_id, w.hit_id)
        assert g.audio.shape == w.audio.shape == (8 * 256,)
        assert g.audio.dtype == np.float64
        assert np.abs(w.audio).max() > 0
        assert dberr(g.audio, w.audio) <= -100


def test_features_matrix_matches_jax(clips):
    got, want = clips
    x, y, labels = t_ds.features_matrix(got)
    jx, jy, jlabels = j_ds.features_matrix(got)
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    assert labels == jlabels == sorted({c.material for c in want})


def test_fused_backend_clips_match_blocked(dberr):
    """backend="pallas" (the fused form; its plain twin on CPU tensors)
    against the blocked form on one material."""
    mats = {"glass": t_ds.MATERIALS["glass"]}
    kw = dict(KW, hits_per_object=1)
    fused = t_ds.synthesize_dataset(materials=mats, backend="pallas",
                                    device="cpu", **kw)
    blocked = t_ds.synthesize_dataset(materials=mats, device="cpu", **kw)
    for f, b in zip(fused, blocked):
        assert dberr(f.audio, b.audio) <= -100


def test_render_raw_matches_jax(dberr):
    """render_raw: per block, [O, num_blocks*S], the two packages alike."""
    import jax
    import jax.numpy as jnp

    from openpbso_tpu.ops.coeffs import bank_from_material
    from openpbso_tpu.runtime.session import ModalSession as JSession
    from openpbso_tpu.runtime.solver import SolverConfig as JConfig
    from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data
    from openpbso_tpu_torch.convert import bank_from_numpy
    from openpbso_tpu_torch.runtime.session import ModalSession
    from openpbso_tpu_torch.runtime.solver import SolverConfig

    md = synth_mode_data(16, 4, seed=2)
    jbank = bank_from_material(CERAMIC.density, md.omega_squared,
                               CERAMIC.alpha, CERAMIC.beta, num_objects=3,
                               block_size=128, dtype=jnp.float32)
    t = ModalSession(bank_from_numpy(jax.tree.map(np.asarray, jbank),
                                     device="cpu"),
                     config=SolverConfig(block_size=128, backend="blocked"))
    j = JSession(jbank, config=JConfig(block_size=128, backend="blocked"))
    for s in (t, j):
        s.hit(1, np.linspace(0.2, 1.0, 16), kind="gaussian", width_us=300.0)
    got, want = t.render_raw(5), j.render_raw(5)
    assert got.shape == want.shape == (3, 5 * 128)
    assert dberr(got, want) <= -100


def test_run_study_matches_jax(clips):
    """Both studies on one feature matrix give identical results (LinearSVC
    shuffles with numpy's global generator: each run starts from one
    seed)."""
    pytest.importorskip("sklearn")
    x, y, _ = t_ds.features_matrix(clips[0])
    groups = {"all": slice(0, 68), "mfcc": np.r_[8:21, 42:55]}
    np.random.seed(0)
    got = t_train.run_study(x, y, groups)
    np.random.seed(0)
    want = j_train.run_study(x, y, groups)
    assert [tuple(vars(r).values()) for r in got] == [
        tuple(vars(r).values()) for r in want]


def test_study_without_sklearn_raises(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_sklearn(name, *a, **kw):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    with pytest.raises(RuntimeError, match="scikit-learn"):
        t_train.run_study(np.zeros((4, 68)), np.zeros(4))


def test_plot_results_png_bitwise(tmp_path):
    rs = [("LinearSVC", "all", 0.9, 0.05, 1.0, 10),
          ("SGD", "mfcc", 0.6, 0.1, None, 10)]
    tp, jp = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    t_train.plot_results_png([t_train.TrainResult(*r) for r in rs], tp)
    j_train.plot_results_png([j_train.TrainResult(*r) for r in rs], jp)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()


def test_train_cli_synthesizes_and_studies(tmp_path, monkeypatch):
    """The CLI end to end on the CPU at a tiny size (--device cpu)."""
    pytest.importorskip("sklearn")
    import json
    out = str(tmp_path / "study.json")
    assert t_train.main(["--objects", "2", "--hits", "2", "--modes", "16",
                         "--seconds", "0.05", "--device", "cpu",
                         "--out", out]) == 0
    with open(out) as f:
        rows = json.load(f)
    assert {r["classifier"] for r in rows} == {"LinearSVC", "SGD"}
    assert {r["feature_group"] for r in rows} == set(
        t_train.FEATURE_GROUPS)
