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
(``csrc/fused_block.cu``, wrapped by ``ops.fused_integrator``); the chunked
span (``ModalSession.render_multi`` -> ``runtime.solver.step_span`` ->
``ops.span``), whose chunk-state scan and within-chunk Toeplitz convolution
are CUDA kernels too (``csrc/chunk_scan.cu``, ``csrc/toeplitz_conv.cu``);
the sustained AR(2) contact channel on both (``csrc/ar_block.cu``,
``csrc/ar_noise.cu``); and the live stream: listener moves ramped across a
block, per-mode energy telemetry (qnorm), a moving listener rendered
offline, ``ModalSession.warmup``, and ``runtime.engine.StreamingEngine``
with its sinks (``runtime.audio``), profiler (``runtime.profiling``) and
checkpoints (``runtime.checkpoint``); the spatial path (``models.scene``,
the Doppler and HRTF post-mixes); and the serving surface: the TCP and
WebSocket audio servers (``runtime.server``, ``runtime.wsbridge``) and the
command-line apps (``apps``), which run on the CUDA device unless asked
for the CPU (``--device cpu``).

Importing the package applies the float32 precision pin (``precision``).
"""
from . import config, precision  # noqa: F401  (precision pins on import)
from .config import (DEFAULT_BLOCK, FRAMES_PER_BUFFER, MODAL_GAIN,
                     OUTPUT_SCALE, SAMPLE_RATE, UNIT_TRANSFER)

__version__ = "0.1.0"
