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
APPS = ("assemble_movie", "fetch_dataset", "real_time_modal_sound",
        "render_fields", "render_offline", "render_timeline", "serve",
        "softrender")
import numpy as np
sys.modules["sklearn"] = None      # as where sklearn is not installed
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
# the live path: an engine stream with qnorm, a snapshot, a trace
import os, tempfile, time
from openpbso_tpu_torch.runtime import (RawCollectorSink, StreamingEngine,
                                        load_session, save_session)
from openpbso_tpu_torch.runtime.profiling import device_trace
for required in ("runtime.audio", "runtime.checkpoint", "runtime.engine",
                 "runtime.profiling", "models.scene", "ops.doppler",
                 "ops.hrtf", "ops.ffat_fit", "runtime.server",
                 "runtime.wsbridge", "parallel.session", "parallel.sharding",
                 "ml.dataset", "ml.features", "ml.ar_model", "ml.train",
                 "utils.oracle", "io.vectors", "native.bindings",
                 *("apps." + a for a in APPS)):
    assert "openpbso_tpu_torch." + required in names, required
engine = StreamingEngine(sess, RawCollectorSink(), qnorm_every=2)
engine.hit(0, np.ones(16))
engine.start()
deadline = time.time() + 120
while engine._blocks_done < 6 and time.time() < deadline:
    time.sleep(0.01)
engine.stop()
assert engine.error is None and engine._blocks_done >= 6
with tempfile.TemporaryDirectory() as tmp:
    save_session(os.path.join(tmp, "s.npz"), sess)
    load_session(os.path.join(tmp, "s.npz"), sess)
    with device_trace(tmp):
        sess.warmup()
print(len(names), "jax" in sys.modules, reference_modules())
"""

_SERVING_WITHOUT_JAX = r"""
import json, threading, time
import numpy as np
from openpbso_tpu_torch.apps import serve
from openpbso_tpu_torch.runtime.server import AudioClient
srv = serve.build_server(serve.parse_args([
    "--demo-synth", "--multi-client", "--per-client-listeners", "1,2",
    "--device", "cpu", "--port", "0", "--block", "128"]))
t = threading.Thread(target=srv.serve_forever, daemon=True)
t.start()
a = AudioClient(*srv.address)
a.send(cmd="hit", obj=0, vertex=3, kind="gaussian", width_us=800.0)
peak = 0.0
for _ in range(2000):
    peak = max(peak, float(np.abs(a.read_block()).max()))
    if peak > 0:
        break
b = AudioClient(*srv.address)        # grows the listener bucket to 2
deadline = time.time() + 120
while not srv.grows and time.time() < deadline:
    b.read_block()
assert peak > 0 and srv.grows and srv.grows[0]["carried"], srv.grows
a.close(); b.close(); srv.close(); t.join(60)
print("jax" in sys.modules, reference_modules())
"""

_IMPORT_ONE = r"""
import importlib
importlib.import_module(MODULE)
print("jax" in sys.modules, reference_modules())
"""

APPS = ("assemble_movie", "fetch_dataset", "real_time_modal_sound",
        "render_fields", "render_offline", "render_timeline", "serve",
        "softrender")

_SPATIAL_WITHOUT_JAX = r"""
import tempfile, time
import numpy as np
from openpbso_tpu_torch.io.meta import resolve_model_dir
from openpbso_tpu_torch.models import Scene, SceneInstance, load_model
from openpbso_tpu_torch.ops import (DopplerPostMix, HRTFPostMix,
                                    build_ffat_hetero, compress_map)
from openpbso_tpu_torch.runtime import RawCollectorSink, StreamingEngine
from openpbso_tpu_torch.utils.synth import synth_model_dir
root = tempfile.mkdtemp()
models = []
for i in range(2):
    synth_model_dir(f"{root}/{i}", "m", num_modes=10 + 4 * i, ffat_n=4,
                    seed=i)
    models.append(load_model(resolve_model_dir(f"{root}/{i}", "m")))
insts = [SceneInstance(models[i % 2], np.asarray([0.5 * i, 0.0, 0.0]))
         for i in range(3)]
scene = Scene(insts, block_size=64, binaural=True, itd=True,
              smooth_transfer=True, device="cpu")
scene.session.ffat = build_ffat_hetero(
    [x.model.ffat_maps for x in insts], scene.bank.num_modes, device="cpu",
    compressed_maps=[{k: compress_map(v) for k, v in x.model.ffat_maps.items()}
                     for x in insts])
scene.set_listener(np.asarray([1.0, 1.0, 0.3]))
scene.session.set_use_compressed(True)
assert scene.session.state.transfer_im is not None
scene.hit(0, 1)
path = np.stack([np.linspace(1.0, 2.0, 4), np.ones(4), np.zeros(4)], 1)
for out in (scene.render(2), scene.render_multi(4, blocks_per_dispatch=2),
            scene.render_moving(path), scene.render_doppler(path)):
    assert out.shape[1] == 2 and np.isfinite(out).all()
pm = DopplerPostMix(scene.positions, num_listeners=2,
                    gains=scene.session.gains, device="cpu")
engine = StreamingEngine(scene.session, RawCollectorSink(), post_mix=pm,
                         lookahead=2)
engine.set_listener(np.asarray([1.5, 0.5, 0.2]))
engine.hit(1, np.ones(14))
engine.start()
deadline = time.time() + 120
while engine._blocks_done < 6 and time.time() < deadline:
    time.sleep(0.01)
engine.stop()
assert engine.error is None and engine._blocks_done >= 6
hrtf = HRTFPostMix(scene.positions, block_size=64, device="cpu")
import torch
assert hrtf.process_span(torch.ones((3, 128))).shape == (128, 2)
print("jax" in sys.modules, reference_modules())
"""

_MESH_AND_ML_WITHOUT_JAX = r"""
import time
import numpy as np
sys.modules["sklearn"] = None      # as where sklearn is not installed
from openpbso_tpu_torch.ml import dataset, train
from openpbso_tpu_torch.ops.coeffs import bank_from_material, lambda_from_modes
from openpbso_tpu_torch.parallel import ShardedSession, make_mesh, sharding
from openpbso_tpu_torch.runtime import RawCollectorSink, StreamingEngine
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.utils.synth import CERAMIC, synth_mode_data
md = synth_mode_data(16, 4)
lam64 = lambda_from_modes(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                          CERAMIC.beta)[0]
bank = bank_from_material(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                          CERAMIC.beta, num_objects=4, block_size=64,
                          device="cpu")
sess = ShardedSession(bank, make_mesh(2, 2, devices=["cpu"] * 4),
                      config=SolverConfig(block_size=64), lam64=lam64)
sess.hit(3, np.ones(16), kind="gaussian", width_us=300.0)
sharding.REDUCTIONS = 0
mix = sess.render_multi(4, blocks_per_dispatch=4)
assert sharding.REDUCTIONS == 1 and np.abs(mix).max() > 0
engine = StreamingEngine(sess, RawCollectorSink(), lookahead=2)
engine.hit(1, np.ones(16))
engine.start()
deadline = time.time() + 120
while engine._blocks_done < 6 and time.time() < deadline:
    time.sleep(0.01)
engine.stop()
assert engine.error is None and engine._blocks_done >= 6
clips = dataset.synthesize_dataset(
    materials={"glass": dataset.MATERIALS["glass"]}, objects_per_material=2,
    hits_per_object=1, num_modes=16, seconds=0.02, block=64, device="cpu")
x, y, labels = dataset.features_matrix(clips)
assert x.shape == (2, 68) and labels == ["glass"]
try:
    train.run_study(x, y)
except RuntimeError as e:
    assert "scikit-learn" in str(e)
else:
    raise AssertionError("the study ran without sklearn")
print("jax" in sys.modules, reference_modules())
"""

_SPAN_AND_NATIVE_WITHOUT_JAX = r"""
import dataclasses, tempfile
import numpy as np
from openpbso_tpu_torch.io import encode_fatcube, maps_match_bits
from openpbso_tpu_torch.io.meta import resolve_model_dir
from openpbso_tpu_torch.models import load_model
from openpbso_tpu_torch.native import (NativeSpscRing, load_native,
                                       native_decode_fatcube)
from openpbso_tpu_torch.ops.coeffs import bank_from_material, lambda_from_modes
from openpbso_tpu_torch.ops.span import (build_span_tables, decay_span,
                                         integrate_span)
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig
from openpbso_tpu_torch.utils.synth import (CERAMIC, synth_fatcube,
                                            synth_mode_data, synth_model_dir)
import torch
md = synth_mode_data(16, 4)
lam64 = lambda_from_modes(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                          CERAMIC.beta)[0]
bank = bank_from_material(CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                          CERAMIC.beta, num_objects=2, block_size=32,
                          device="cpu")
m = bank.num_modes
z = torch.zeros((2, m))
space = torch.ones((2, 1, m))
f = torch.zeros((2, 1, 64 * 32))
f[:, 0, 0] = 1.0
outs = []
for radix in (32, None):
    t = build_span_tables(lam64, 64 * 32, radix=radix, num_modes=m,
                          device="cpu")
    zr, zi, snd = integrate_span(z, z, bank, t, space, f, torch.ones_like(z))
    outs.append(snd)
    assert decay_span(zr, zi, bank, t, torch.ones_like(z))[2].shape == (
        2, 64 * 32)
assert t.n_chunks == 8
err = float(((outs[0] - outs[1]) ** 2).sum() / (outs[1] ** 2).sum())
assert 0 < float((outs[1] ** 2).sum()) and err < 1e-9, err
sess = ModalSession(bank, config=SolverConfig(block_size=32), lam64=lam64)
sess.hit(1, np.ones(16))
assert np.abs(sess.render_multi(1024, blocks_per_dispatch=1024)).max() > 0
t = sess.span_tables_for(1024)
assert (t.chunk, t.n_chunks) == (512, 64) and t.planes is not None
assert load_native() is not None
ring = NativeSpscRing(4, (8, 2))
assert ring.try_push(np.ones((8, 2), np.float32))
assert np.array_equal(ring.try_pop(), np.ones((8, 2), np.float32))
mp = synth_fatcube(2, 300.0, n=5)
assert maps_match_bits(native_decode_fatcube(encode_fatcube(mp)), mp)
root = synth_model_dir(tempfile.mkdtemp(), num_modes=6, ffat_n=4)
assert len(load_model(resolve_model_dir(root)).ffat_maps) == 6
print("jax" in sys.modules, reference_modules())
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
    assert int(n_modules) >= 24
    assert jax_loaded == "False"
    assert reference == "none"


def test_spatial_path_runs_without_jax():
    """The spatial modules (Scene, the compressed texture, the Doppler and
    HRTF post-mixes) run a binaural ITD scene per block, by span, along a
    path, with Doppler and through the engine, with neither jax nor
    openpbso_tpu loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", _DEF_REFERENCE_MODULES
         + _SPATIAL_WITHOUT_JAX], capture_output=True, text=True, env=_env(),
        cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "none"]


def test_serving_surface_runs_without_jax():
    """apps/serve.py builds a per-client broadcast server on the CPU; a
    client hits, a second grows the listener bucket with the state
    carried; neither jax nor openpbso_tpu is loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", _DEF_REFERENCE_MODULES
         + _SERVING_WITHOUT_JAX], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-2:] == ["False", "none"]


def test_mesh_session_and_ml_run_without_jax_or_sklearn():
    """A ShardedSession on a (2, 2) mesh of CPU cells renders a span with
    one reduction and streams through the engine; ml/ synthesizes clips
    and their features; the study raises its clear error: with neither
    jax, openpbso_tpu nor sklearn loadable."""
    proc = subprocess.run(
        [sys.executable, "-c", _DEF_REFERENCE_MODULES
         + _MESH_AND_ML_WITHOUT_JAX], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "none"]


def test_span_forms_and_native_run_without_jax():
    """The chunked span integrates and rings down (64 chunks and 8
    agreeing), a session renders 1024 blocks in one span through its own
    tables, and the native library builds, rings and decodes, loading a
    model: with neither jax nor openpbso_tpu loaded."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH: the native library cannot build")
    proc = subprocess.run(
        [sys.executable, "-c", _DEF_REFERENCE_MODULES
         + _SPAN_AND_NATIVE_WITHOUT_JAX], capture_output=True,
        text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "none"]


@pytest.mark.parametrize("module", ["runtime.server", "runtime.wsbridge"]
                         + ["apps." + a for a in APPS])
def test_serving_module_imports_alone(module):
    """Each serving module and app imports on its own, without a GPU,
    loading neither jax nor openpbso_tpu (the apps import torch lazily)."""
    name = "openpbso_tpu_torch." + module
    proc = subprocess.run(
        [sys.executable, "-c", _DEF_REFERENCE_MODULES
         + f"MODULE = {name!r}\n" + _IMPORT_ONE], capture_output=True,
        text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "none"]


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
