"""float32 precision pin, applied when the package is imported.

TF32 is the GPU form of the TPU's one-pass bf16 matmul trap that the JAX
package pins away (openpbso_tpu/ops/integrator.py:43-56, measured -52.6 dB
at [256,1024]x[1024,512] on the TPU): it keeps ~10 mantissa bits, far
below the -90 dB bars the per-block backends are held to. Every
correctness-critical contraction of the port is a float32 matmul, einsum,
or cuDNN op, so all three switches are pinned, never defaulted.

One hand-written kernel uses the tensor cores' TF32 inside itself and
stays FP32-accurate: csrc/toeplitz_conv.cu splits each float32 operand
into two TF32 numbers and sums three products in float32 (3xTF32). That
split lives only in that kernel and is admitted by its measured error,
<= -110 dB against its FP32 twin (chip_smoke.py, tests/test_torch_gpu.py);
it relaxes none of the switches below.
"""
import torch


def pin_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


pin_float32()
