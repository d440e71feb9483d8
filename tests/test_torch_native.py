"""Port parity: the native runtime library (openpbso_tpu_torch.native).

Every case of tests/test_native.py runs on the port's SPSC ring and
``.fatcube`` decoder, plus the decoder fuzz of tests/test_io.py; decoded
maps are held bitwise against the JAX package's native decoder and the
Python codec. The port builds its own library from its copy of
pbso_native.cc into openpbso_tpu_torch/_build/ with g++; these tests skip
only when g++ is not on PATH, and a failed build with g++ present fails
them.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from openpbso_tpu.io import fatcube as jfc
from openpbso_tpu.native import bindings as jnative
from openpbso_tpu.utils.synth import synth_fatcube, synth_model_dir
from openpbso_tpu_torch import native
from openpbso_tpu_torch.io import fatcube as tfc
from openpbso_tpu_torch.native import bindings

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not on PATH")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """No tensors here, but every CPU port test file pins torch to one
    thread, so that the suite's parallel workers do not oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lib():
    lib = native.load_native()
    assert lib is not None, f"g++ is present but: {bindings.build_error}"
    return lib


def test_library_is_built_under_the_port_build_dir(lib):
    path = os.path.realpath(lib._name)
    build = os.path.realpath(os.path.join(REPO, "openpbso_tpu_torch",
                                          "_build"))
    assert os.path.dirname(path) == build
    assert path == os.path.realpath(bindings.library_path())
    assert os.path.basename(path).startswith("native_")
    assert "openpbso_tpu" + os.sep + "native" not in path


def test_concurrent_builds_all_load(tmp_path):
    """Processes building at once into an empty build dir each load a
    whole library (the compiler writes a private name, then renames)."""
    code = ("import sys; from openpbso_tpu_torch.native import bindings as b;"
            f" b.BUILD_DIR = {str(tmp_path)!r};"
            " lib = b.load_native(); assert lib is not None, b.build_error;"
            " assert lib.spsc_size(lib.spsc_create(2, 4)) == 0;"
            " print(lib._name)")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert len({out.strip() for out, _ in outs}) == 1
    assert [n for n in os.listdir(tmp_path)] == [
        os.path.basename(outs[0][0].strip())]


def test_spsc_push_pop_order(lib):
    ring = native.NativeSpscRing(4, (8,))
    for i in range(4):
        assert ring.try_push(np.full(8, float(i), np.float32))
    assert not ring.try_push(np.zeros(8, np.float32))  # full
    for i in range(4):
        out = ring.try_pop()
        assert out is not None and out[0] == float(i)
    assert ring.try_pop() is None  # empty


def test_spsc_pacing_semantics(lib):
    """Capacity-2 ring behaves like the reference sound queue: producer
    try_push fails when 2 ahead (modal_solver.h:130, 275)."""
    ring = native.NativeSpscRing(2, (4,))
    a = np.ones(4, np.float32)
    assert ring.try_push(a) and ring.try_push(a)
    assert not ring.try_push(a)
    ring.try_pop()
    assert ring.try_push(a)


def test_spsc_overwrite_drops_oldest(lib):
    """When full, the oldest block is retired and the new one published."""
    ring = native.NativeSpscRing(2, (2,))
    ring.push_overwrite(np.asarray([1.0, 1.0], np.float32))
    ring.push_overwrite(np.asarray([2.0, 2.0], np.float32))
    ring.push_overwrite(np.asarray([3.0, 3.0], np.float32))
    assert ring.dropped == 1
    assert ring.try_pop()[0] == 2.0
    assert ring.try_pop()[0] == 3.0


def test_spsc_refuses_a_block_of_another_size(lib):
    ring = native.NativeSpscRing(2, (4,))
    with pytest.raises(ValueError, match="ring expects 4"):
        ring.try_push(np.zeros(3, np.float32))


def test_spsc_threaded_stream(lib):
    """Producer/consumer threads stream 500 blocks without loss or
    reordering."""
    ring = native.NativeSpscRing(8, (16,))
    n = 500
    received = []

    def produce():
        i = 0
        while i < n:
            if ring.try_push(np.full(16, float(i), np.float32)):
                i += 1

    def consume():
        while len(received) < n:
            out = ring.try_pop()
            if out is not None:
                received.append(float(out[0]))

    tp = threading.Thread(target=produce)
    tc = threading.Thread(target=consume)
    tp.start()
    tc.start()
    tp.join(10)
    tc.join(10)
    assert received == [float(i) for i in range(n)]


def test_spsc_overwrite_concurrent_no_torn_blocks(lib):
    """push_overwrite against a concurrent consumer: every popped block is
    internally consistent, and survivors keep their order."""
    ring = native.NativeSpscRing(2, (64,))
    n = 4000
    bad = []
    done = threading.Event()

    def produce():
        for i in range(n):
            ring.push_overwrite(np.full(64, float(i), np.float32))
        done.set()

    def consume():
        last = -1.0
        while not done.is_set() or len(ring):
            out = ring.try_pop()
            if out is None:
                continue
            if not np.all(out == out[0]):
                bad.append(out.copy())
            if out[0] <= last:
                bad.append(("order", last, float(out[0])))
            last = float(out[0])

    t1 = threading.Thread(target=produce)
    t2 = threading.Thread(target=consume)
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    assert not bad, bad[:3]
    assert ring.dropped <= n


def _assert_port_map(got, ref):
    assert jfc.maps_match_bits(got, ref)
    assert type(got) is tfc.FatcubeMap and type(got.shell) is tfc.CubemapShell


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_fatcube_decode_bit_parity(lib, seed):
    """Bitwise the source map, the port's Python codec, the JAX package's
    Python codec and its native decoder."""
    m = synth_fatcube(seed, 440.0 * (seed + 1), n=7 + seed, seed=seed)
    data = jfc.encode_fatcube(m)
    nat = native.native_decode_fatcube(data)
    assert nat is not None
    _assert_port_map(nat, m)
    assert tfc.maps_match_bits(tfc.decode_fatcube(data), nat)
    assert jfc.maps_match_bits(jfc.decode_fatcube(data), nat)
    jnat = jnative.native_decode_fatcube(data)
    if jnative.load_native() is not None:
        assert jfc.maps_match_bits(jnat, nat)


def test_native_fatcube_compressed_and_golden(lib):
    """A compressed map, and the file the C++ reference wrote with
    protobuf (mode 0: the mode id field omitted)."""
    m = dataclasses.replace(synth_fatcube(9, 900.0, n=6, seed=5),
                            is_compressed=True)
    _assert_port_map(native.native_decode_fatcube(jfc.encode_fatcube(m)), m)
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "cpp_protobuf_mode0.fatcube")
    with open(path, "rb") as fh:
        data = fh.read()
    _assert_port_map(native.native_decode_fatcube(data),
                     jfc.load_fatcube(path))


def test_native_fatcube_rejects_garbage(lib):
    assert native.native_decode_fatcube(b"\x99\x01garbage") is None
    assert native.native_decode_fatcube(b"") is None


def test_native_load_all(tmp_path, lib):
    for i in (1, 4):
        jfc.save_fatcube(str(tmp_path / f"{i}.fatcube"),
                         synth_fatcube(i, 100.0 * i, n=5))
    (tmp_path / "notes.txt").write_text("not a map")
    maps = native.load_all_fatcubes_native(str(tmp_path))
    assert sorted(maps) == [1, 4]
    ref = jfc.load_all_fatcubes(str(tmp_path))
    for mode_id, m in maps.items():
        _assert_port_map(m, ref[mode_id])
    assert native.load_all_fatcubes_native(str(tmp_path / "absent")) == {}


def test_native_load_all_falls_back_per_file(tmp_path, lib, monkeypatch):
    """A file the native decoder refuses goes through the Python codec."""
    for i in (2, 3):
        jfc.save_fatcube(str(tmp_path / f"{i}.fatcube"),
                         synth_fatcube(i, 300.0 * i, n=4))
    real = bindings.native_decode_fatcube
    seen = []

    def refuse_mode_3(data):
        m = real(data)
        seen.append(m.mode_id)
        return None if m.mode_id == 3 else m
    monkeypatch.setattr(bindings, "native_decode_fatcube", refuse_mode_3)
    maps = bindings.load_all_fatcubes_native(str(tmp_path))
    assert seen == [2, 3] and sorted(maps) == [2, 3]
    _assert_port_map(maps[3], jfc.load_fatcube(str(tmp_path / "3.fatcube")))


def test_native_fatcube_distinct_centers(lib):
    """Map-level center (ffat_map_t_3 field 2) and shell center (field 5)
    are distinct fields; the native decoder keeps them apart."""
    m = synth_fatcube(2, 550.0, n=6, seed=3)
    m = dataclasses.replace(m, center=m.center + np.array([0.5, -0.25, 2.0]))
    assert not np.array_equal(m.center, m.shell.center)
    nat = native.native_decode_fatcube(jfc.encode_fatcube(m))
    assert nat is not None
    assert np.array_equal(nat.center, m.center)
    assert np.array_equal(nat.shell.center, m.shell.center)
    _assert_port_map(nat, m)


def test_native_fatcube_decoder_fuzz(lib):
    """Random bytes and bit-flipped truncations of a good map: None or a
    map, never a crash, and the same answer as the JAX package's native
    decoder."""
    rng = np.random.default_rng(1)
    good = jfc.encode_fatcube(synth_fatcube(1, 500.0, n=5))
    jlib = jnative.load_native()
    for i in range(120):
        if i < 60:
            buf = rng.integers(0, 256, rng.integers(0, 200),
                               dtype=np.uint8).tobytes()
        else:
            b = bytearray(good[: rng.integers(1, len(good))])
            for _ in range(rng.integers(1, 8)):
                b[rng.integers(0, len(b))] ^= 1 << rng.integers(0, 8)
            buf = bytes(b)
        got = native.native_decode_fatcube(buf)
        if jlib is None:
            continue
        ref = jnative.native_decode_fatcube(buf)
        assert (got is None) == (ref is None)
        if got is not None:
            assert jfc.maps_match_bits(got, ref)


def test_load_model_decodes_natively(tmp_path, lib, monkeypatch):
    """The port's load_model decodes every map through the native decoder
    with no per-file fallback, bitwise the JAX package's load."""
    from openpbso_tpu.io.meta import resolve_model_dir as j_resolve
    from openpbso_tpu.models.modal_model import load_model as j_load
    from openpbso_tpu_torch.io import fatcube as port_codec
    from openpbso_tpu_torch.io.meta import resolve_model_dir
    from openpbso_tpu_torch.models.modal_model import load_model
    root = synth_model_dir(str(tmp_path), num_modes=12, seed=4)

    def no_fallback(*_):
        raise AssertionError("fell back to the Python codec")
    monkeypatch.setattr(port_codec, "load_fatcube", no_fallback)
    monkeypatch.setattr(port_codec, "load_all_fatcubes", no_fallback)
    got = load_model(resolve_model_dir(root))
    ref = j_load(j_resolve(root))
    assert sorted(got.ffat_maps) == sorted(ref.ffat_maps) != []
    for mode_id, m in got.ffat_maps.items():
        _assert_port_map(m, ref.ffat_maps[mode_id])
