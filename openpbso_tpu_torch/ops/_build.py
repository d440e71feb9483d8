"""Build and load the port's CUDA kernel library from the sources in csrc/.

``nvcc`` compiles ``csrc/fused_block.cu`` into a shared library with a plain
C interface, loaded with ctypes. The build happens at first use, goes into
``openpbso_tpu_torch/_build/`` (git-ignored) and is cached by a hash of the
source and the flags, so a fresh checkout builds once and later processes
load the cached library. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_block.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""   # nvcc's output of the last build (ptxas register report)


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME or the toolkit's default home."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the fused "
        "kernel is built from csrc/fused_block.cu for sm_90a at first use")


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"fused_block_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless the cached build for this source exists;
    returns its path. Raises RuntimeError with nvcc's output on failure."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                f"{build_log}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.fused_block_step.argtypes = (
                [p, p, ll] + [p] * 8 + [p] * 5 + [i] * 5 + [p])
            lib.fused_block_step.restype = i
            lib.fused_block_smem_bytes.argtypes = [i, i, i]
            lib.fused_block_smem_bytes.restype = ll
            lib.fused_block_error_string.argtypes = [i]
            lib.fused_block_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
