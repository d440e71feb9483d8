"""openpbso_tpu_torch — the PyTorch/CUDA port of openpbso_tpu for NVIDIA Hopper.

The JAX package ``openpbso_tpu`` is the reference; this package mirrors its
module layout, so every counterpart sits at the same relative path. It
imports ``torch`` and never ``jax``, and nothing of ``openpbso_tpu``: the
reference's numpy-only modules that it needs (``config``, ``io``,
``utils.synth``, ``models.modal_model``) are copied, and
tests/test_torch_io.py holds each copy against its original.

Ported so far: the per-block modal step (``runtime.session.ModalSession``
-> ``runtime.solver.step_block`` -> ``ops.integrator`` backends), with the
fused per-block kernel of heterogeneous banks written in CUDA for sm_90a
(``csrc/fused_block.cu``, wrapped by ``ops.fused_integrator``); and the
chunked span (``ModalSession.render_multi`` -> ``runtime.solver.step_span``
-> ``ops.span``), whose chunk-state scan and within-chunk Toeplitz
convolution are CUDA kernels too (``csrc/chunk_scan.cu``,
``csrc/toeplitz_conv.cu``, wrapped by ``ops.chunk_scan`` and
``ops.toeplitz_conv``).

Importing the package applies the float32 precision pin (``precision``).
"""
from . import config, precision  # noqa: F401  (precision pins on import)
from .config import (DEFAULT_BLOCK, FRAMES_PER_BUFFER, MODAL_GAIN,
                     OUTPUT_SCALE, SAMPLE_RATE, UNIT_TRANSFER)

__version__ = "0.1.0"
