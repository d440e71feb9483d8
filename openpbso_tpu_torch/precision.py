"""float32 precision pin, applied when the package is imported.

TF32 is the GPU form of the TPU's one-pass bf16 matmul trap that the JAX
package pins away (openpbso_tpu/ops/integrator.py:43-56, measured -52.6 dB
at [256,1024]x[1024,512] on the TPU): it keeps ~10 mantissa bits, far
below the -90 dB bars the per-block backends are held to. Every
correctness-critical contraction of the port is a float32 matmul, einsum,
or cuDNN op, so all three switches are pinned, never defaulted.
"""
import torch


def pin_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


pin_float32()
