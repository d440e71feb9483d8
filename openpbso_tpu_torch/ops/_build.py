"""Build and load the port's CUDA kernel library from the sources in csrc/.

``nvcc`` compiles every ``csrc/*.cu`` to an object file, one process per
source, all started together, and links them into one shared library with
a plain C interface, loaded with ctypes. The build happens at first use,
goes into ``openpbso_tpu_torch/_build/`` (git-ignored) and is cached by a
hash of every source, every shared header (``csrc/*.cuh``) and the flags,
so a fresh checkout builds once and later processes load the cached
library. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v", "-c")
LINK_FLAGS = ARCH + ("-shared",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""   # nvcc's output of the last build (ptxas register report)


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


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
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "kernels are built from csrc/*.cu for sm_90a at first use")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for src in sources() + headers:
        with open(src, "rb") as fh:
            digest.update(os.path.basename(src).encode() + b"\0"
                          + fh.read())
    return os.path.join(BUILD_DIR, f"kernels_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless the cached build for these sources
    exists; returns its path. Raises RuntimeError with nvcc's output on
    failure."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # objects and the library go to private names first, then the library
    # is renamed: a concurrent process never loads a half-written one
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    procs = []
    try:
        for src in sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"{os.path.basename(src)}:\n{text}")
            if proc.returncode != 0:
                failed.append(f"{src} ({proc.returncode})")
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed building {', '.join(failed)}:"
                               f"\n{build_log}")
        lib = os.path.join(work, "kernels.so")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", lib,
                               *(obj for _, obj, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {out}:\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib, out)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.fused_block_step.argtypes = (
                [p, p, ll, i] + [p] * 8 + [p] * 3 + [i] * 5 + [p])
            lib.fused_block_step.restype = i
            lib.fused_block_smem_bytes.argtypes = [i, i, i]
            lib.fused_block_smem_bytes.restype = ll
            lib.fused_block_row_floats.argtypes = [i]
            lib.fused_block_row_floats.restype = i
            lib.chunk_scan.argtypes = [p] * 6 + [ll] + [p] * 4 + [i] * 3 + [p]
            lib.chunk_scan.restype = i
            lib.toeplitz_conv.argtypes = [p] * 3 + [i] * 7 + [p]
            lib.toeplitz_conv.restype = i
            lib.toeplitz_conv_smem_bytes.argtypes = [i, i]
            lib.toeplitz_conv_smem_bytes.restype = ll
            lib.toeplitz_conv_blocks.argtypes = [i] * 5
            lib.toeplitz_conv_blocks.restype = ll
            lib.span_inject.argtypes = ([p] * 9 + [ll] + [p] * 2 + [i] * 9
                                        + [p])
            lib.span_inject.restype = i
            lib.span_inject_blocks.argtypes = [i] * 3 + [ll, i]
            lib.span_inject_blocks.restype = ll
            lib.span_reduce.argtypes = ([p] * 8 + [ll] + [p] * 2 + [i] * 10
                                        + [p])
            lib.span_reduce.restype = i
            lib.span_reduce_blocks.argtypes = [i] * 4 + [ll, i]
            lib.span_reduce_blocks.restype = ll
            lib.ar_noise.argtypes = [p, ll, ll, p, i, i, i, i, p]
            lib.ar_noise.restype = i
            lib.ar_block.argtypes = [p] * 6 + [ll, p, p, i, i, p]
            lib.ar_block.restype = i
            lib.cuda_error_string.argtypes = [i]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch_stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device, the
    stream PyTorch itself would launch on (one C call, no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def device_guard(t: torch.Tensor):
    """A context that makes ``t``'s device current for a launch; nothing
    when it already is."""
    idx = t.get_device()
    if idx == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(idx)


def check(err: int, what: str) -> None:
    """Raise when a library entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           + load().cuda_error_string(err).decode())
