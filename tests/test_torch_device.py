"""The port's builders put their tensors on the card unless the caller asks
for the CPU: without a CUDA device, a builder called without ``device``
raises (openpbso_tpu_torch.device.resolve_device) instead of building on
the CPU, where a session would silently run the kernels' plain twins; with
``device="cpu"`` it builds there. Whether a GPU is present is decided
inside each test."""
import functools
import tempfile

import numpy as np
import pytest
import torch

from openpbso_tpu_torch import convert
from openpbso_tpu_torch.device import resolve_device
from openpbso_tpu_torch.ops.coeffs import (bank_from_material,
                                           build_modal_bank,
                                           lambda_from_modes)
from openpbso_tpu_torch.ops.ffat import build_ffat, build_ffat_hetero
from openpbso_tpu_torch.ops.hrtf import fir_to_freq
from openpbso_tpu_torch.ops.forces import (make_force_slots,
                                           make_sustained_state)
from openpbso_tpu_torch.ops.span import build_span_tables
from openpbso_tpu_torch.ops.threefry import prng_key, split
from openpbso_tpu_torch.runtime.session import ModalSession
from openpbso_tpu_torch.runtime.solver import SolverConfig, default_gains
from openpbso_tpu_torch.runtime.state import make_solver_state
from openpbso_tpu_torch.utils.synth import (CERAMIC, synth_fatcube,
                                            synth_mode_data)

M = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads only slow them down, and
    under the suite's parallel workers they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")


def _omega2():
    return synth_mode_data(M, 4).omega_squared


def _lam():
    return lambda_from_modes(CERAMIC.density, _omega2(), CERAMIC.alpha,
                             CERAMIC.beta)


def _maps():
    return {i: synth_fatcube(i, 200.0 * (i + 1), n=4) for i in range(M)}


def _cpu_bank():
    return build_modal_bank(*_lam(), block_size=8, device="cpu")


@functools.lru_cache(maxsize=None)
def _model():
    from openpbso_tpu_torch.io.meta import resolve_model_dir
    from openpbso_tpu_torch.models.modal_model import load_model
    from openpbso_tpu_torch.utils.synth import synth_model_dir
    root = tempfile.mkdtemp(prefix="device_model_")
    synth_model_dir(root, "m", num_modes=M, subdivisions=1, ffat_n=4)
    return load_model(resolve_model_dir(root, "m"))


def _scene(**kw):
    from openpbso_tpu_torch.models.scene import Scene, SceneInstance
    return Scene([SceneInstance(_model(), np.zeros(3))], block_size=8,
                 binaural=True, **kw).session.state


def _post_mix(kind, **kw):
    from openpbso_tpu_torch.ops.doppler import DopplerPostMix
    from openpbso_tpu_torch.ops.hrtf import HRTFPostMix
    if kind == "doppler":
        pm = DopplerPostMix(np.zeros((2, 3)), num_listeners=2, **kw)
        return pm._hist, pm.gains
    pm = HRTFPostMix(np.ones((2, 3)), block_size=8, **kw)
    return pm._carry, pm._hf


BUILDERS = {   # name -> builder(**kw): every builder that takes ``device``
    "build_modal_bank": lambda **kw: build_modal_bank(*_lam(), block_size=8,
                                                      **kw),
    "bank_from_material": lambda **kw: bank_from_material(
        CERAMIC.density, _omega2(), CERAMIC.alpha, CERAMIC.beta,
        num_objects=2, block_size=8, **kw),
    "build_ffat": lambda **kw: build_ffat(_maps(), M, **kw),
    "build_ffat_hetero": lambda **kw: build_ffat_hetero([_maps(), _maps()],
                                                        M, **kw),
    "make_force_slots": lambda **kw: make_force_slots(2, 3, M, **kw),
    "make_sustained_state": lambda **kw: make_sustained_state(2, M, **kw),
    "make_solver_state": lambda **kw: make_solver_state(2, M, **kw),
    "default_gains": lambda **kw: default_gains(2, **kw),
    "threefry.split": lambda **kw: split(prng_key(0), 3, **kw),
    "build_span_tables": lambda **kw: build_span_tables(_lam()[0], 64,
                                                        **kw),
    "convert.bank_from_numpy": lambda **kw: convert.bank_from_numpy(
        _cpu_bank(), **kw),
    "convert.state_from_numpy": lambda **kw: convert.state_from_numpy(
        make_solver_state(2, M, device="cpu"), **kw),
    "convert.ffat_from_numpy": lambda **kw: convert.ffat_from_numpy(
        build_ffat(_maps(), M, device="cpu"), **kw),
    "convert.span_tables_from_numpy": lambda **kw:
        convert.span_tables_from_numpy(
            build_span_tables(_lam()[0], 64, device="cpu"), **kw),
    "Scene": _scene,
    "DopplerPostMix": lambda **kw: _post_mix("doppler", **kw),
    "HRTFPostMix": lambda **kw: _post_mix("hrtf", **kw),
    "hrtf.fir_to_freq": lambda **kw: fir_to_freq(np.zeros((2, 2, 4)), 8,
                                                 **kw),
}


def _tensors(x):
    """Every tensor reachable through a builder's result."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _tensors(getattr(x, name))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_defaults_to_the_card(no_gpu, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BUILDERS[name]()
    built = list(_tensors(BUILDERS[name](device="cpu")))
    assert built and all(t.device.type == "cpu" for t in built)


def test_resolve_device(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_engine_follows_its_sessions_bank(no_gpu):
    """The engine has no device of its own: a session is built over a bank,
    a bank built without ``device`` raises here, and an engine over a CPU
    session streams on the CPU."""
    from openpbso_tpu_torch.runtime import RawCollectorSink, StreamingEngine
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamingEngine(ModalSession(build_modal_bank(*_lam(), block_size=8),
                                     config=SolverConfig(block_size=8)),
                        RawCollectorSink())
    sess = ModalSession(_cpu_bank(), config=SolverConfig(block_size=8))
    engine = StreamingEngine(sess, RawCollectorSink())
    engine.hit(0, np.ones(M))
    engine.start()
    import time
    deadline = time.time() + 120
    while engine._blocks_done < 4 and time.time() < deadline:
        time.sleep(0.01)
    engine.stop()
    assert engine.error is None and engine._blocks_done >= 4
    assert all(t.device.type == "cpu" for t in _tensors(sess.state))


def test_session_follows_its_bank():
    sess = ModalSession(_cpu_bank(), config=SolverConfig(block_size=8))
    assert sess.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in _tensors(sess.state))
    assert sess.gains.device.type == "cpu"
    sess.hit(0, np.ones(M), kind="point")
    assert np.isfinite(sess.render(2)).all()
