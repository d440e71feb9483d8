"""ctypes bindings for the native runtime library (pbso_native.cc).

The port's own copy of openpbso_tpu/native/bindings.py. The library is
built on first use with one ``g++ -O3 -std=c++17 -fPIC -shared`` call (no
pip or pybind11 dependency) into ``openpbso_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so a fresh
checkout builds once and later processes load the cached library. The
compiler writes a private name that is then renamed into place, so
processes building at once never load a half-written library. Every
consumer has a pure-Python fallback, so import never hard-fails:
``load_native()`` returns None when the toolchain is unavailable or the
build fails (``build_error`` then says why).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "pbso_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_lock = threading.Lock()
_lib = None
_tried = False
build_error = ""   # why the last load_native() returned None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"native_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> str:
    """Compile the library to ``out``; returns "" or why it failed."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ not found on PATH"
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return f"g++ failed ({proc.returncode}):\n{proc.stderr}"
        os.replace(tmp, out)
        return ""
    except (OSError, subprocess.SubprocessError) as exc:
        return f"g++ failed: {exc}"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_native():
    """The loaded CDLL with typed signatures, or None."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so):
            build_error = _build(so)
            if build_error:
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as exc:
            build_error = f"loading {so}: {exc}"
            return None
        c = ctypes
        lib.spsc_create.restype = c.c_void_p
        lib.spsc_create.argtypes = [c.c_int64, c.c_int64]
        lib.spsc_destroy.argtypes = [c.c_void_p]
        lib.spsc_try_push.restype = c.c_int
        lib.spsc_try_push.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
        lib.spsc_push_overwrite.argtypes = [c.c_void_p,
                                            c.POINTER(c.c_float)]
        lib.spsc_try_pop.restype = c.c_int
        lib.spsc_try_pop.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
        lib.spsc_size.restype = c.c_int64
        lib.spsc_size.argtypes = [c.c_void_p]
        lib.spsc_dropped.restype = c.c_int64
        lib.spsc_dropped.argtypes = [c.c_void_p]
        lib.fatcube_decode.restype = c.c_int
        lib.fatcube_decode.argtypes = [c.POINTER(c.c_uint8), c.c_int64,
                                       c.c_void_p]
        _lib = lib
        return _lib


class NativeSpscRing:
    """Wait-free SPSC ring of fixed-size float blocks (native-backed).

    Counterpart of the reference's moodycamel SPSC queues
    (external/readerwriterqueue.h): the synthesis thread pushes, the audio
    side pops; full/empty never block, matching the reference's
    try_enqueue/try_dequeue discipline.
    """

    def __init__(self, capacity: int, block_shape: tuple[int, ...]):
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        self._shape = tuple(block_shape)
        self._floats = int(np.prod(block_shape))
        self._capacity = int(capacity)
        self._ring = lib.spsc_create(capacity, self._floats)
        if not self._ring:
            raise MemoryError("spsc_create failed")

    def _check_block(self, block: np.ndarray) -> np.ndarray:
        # a hard error, not an assert: an undersized array would make the
        # native memcpy read past the numpy buffer (and asserts vanish
        # under python -O)
        a = np.ascontiguousarray(block, np.float32)
        if a.size != self._floats:
            raise ValueError(f"block has {a.size} floats, ring expects "
                             f"{self._floats}")
        return a

    def try_push(self, block: np.ndarray) -> bool:
        a = self._check_block(block)
        return bool(self._lib.spsc_try_push(
            self._ring, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))))

    def push_overwrite(self, block: np.ndarray) -> None:
        """Drop-oldest push: when full, the oldest pending block is
        retired (CAS tail skip in the native ring — the producer never
        writes a published slot, so any capacity >= 1 is race-free) and
        the new block is published."""
        a = self._check_block(block)
        self._lib.spsc_push_overwrite(
            self._ring, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def try_pop(self) -> np.ndarray | None:
        out = np.empty(self._shape, np.float32)
        ok = self._lib.spsc_try_pop(
            self._ring, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out if ok else None

    def __len__(self) -> int:
        return int(self._lib.spsc_size(self._ring))

    @property
    def dropped(self) -> int:
        return int(self._lib.spsc_dropped(self._ring))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        ring = getattr(self, "_ring", None)
        if lib is not None and ring:
            lib.spsc_destroy(ring)
            self._ring = None


class _FatcubeOut(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_double),
        ("mode_id", ctypes.c_int32),
        ("is_compressed", ctypes.c_int32),
        ("cell_size", ctypes.c_double),
        ("map_center", ctypes.c_double * 3),
        ("shell_center", ctypes.c_double * 3),
        ("bbox_low", ctypes.c_double * 3),
        ("bbox_top", ctypes.c_double * 3),
        ("low_corners", ctypes.c_double * 18),
        ("n_elements", ctypes.c_int32 * 12),
        ("strides", ctypes.c_int32 * 6),
        ("psi_count", ctypes.c_int64),
        ("psi", ctypes.POINTER(ctypes.c_double)),
        ("psi_capacity", ctypes.c_int64),
    ]


def native_decode_fatcube(data: bytes):
    """Decode via the C++ parser; returns a FatcubeMap or None on failure."""
    lib = load_native()
    if lib is None:
        return None
    from ..io.fatcube import CubemapShell, FatcubeMap
    buf = np.frombuffer(data, np.uint8)
    out = _FatcubeOut()
    # first pass to size psi
    out.psi = None
    out.psi_capacity = 0
    if not lib.fatcube_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data), ctypes.byref(out)):
        return None
    n = int(out.psi_count)
    psi = np.zeros(n, np.float64)
    out2 = _FatcubeOut()
    out2.psi = psi.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    out2.psi_capacity = n
    if not lib.fatcube_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data), ctypes.byref(out2)):
        return None
    shell = CubemapShell(
        cell_size=float(out2.cell_size),
        low_corners=np.ctypeslib.as_array(out2.low_corners).reshape(6, 3)
        .copy(),
        n_elements=np.ctypeslib.as_array(out2.n_elements).reshape(6, 2)
        .copy(),
        strides=np.ctypeslib.as_array(out2.strides).copy(),
        center=np.ctypeslib.as_array(out2.shell_center).copy(),
        bbox_low=np.ctypeslib.as_array(out2.bbox_low).copy(),
        bbox_top=np.ctypeslib.as_array(out2.bbox_top).copy(),
    )
    # map-level center (ffat_map_t_3 field 2) is distinct from the shell
    # center, matching the Python codec (io/fatcube.py)
    return FatcubeMap(mode_id=int(out2.mode_id), k=float(out2.k),
                      center=np.ctypeslib.as_array(out2.map_center).copy(),
                      shell=shell, psi=psi,
                      is_compressed=bool(out2.is_compressed))


def load_all_fatcubes_native(dirname: str):
    """Directory bulk load through the native decoder, falling back to the
    Python codec per file on any failure."""
    from ..io.fatcube import load_all_fatcubes, load_fatcube
    if load_native() is None:
        return load_all_fatcubes(dirname)
    out = {}
    for name in sorted(os.listdir(dirname)) if os.path.isdir(dirname) else []:
        if not name.endswith(".fatcube"):
            continue
        path = os.path.join(dirname, name)
        with open(path, "rb") as f:
            data = f.read()
        m = native_decode_fatcube(data)
        if m is None:
            m = load_fatcube(path)
        out[m.mode_id] = m
    return out
