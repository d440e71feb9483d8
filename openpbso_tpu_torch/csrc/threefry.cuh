// Counter-based threefry2x32 and JAX's float32 normal map, device side.
//
// Shared by csrc/ar_noise.cu and csrc/ar_block.cu, so both kernels draw the
// same bits and the same normals for one (object, block, sample). The
// plain twin is openpbso_tpu_torch/ops/threefry.py; both reproduce
// jax.random's threefry2x32 (partitionable form) bit for bit:
//
//   key_{o,b} = fold_in(key_o, b) = tf(key_o, (0, b))
//   bits[j]   = x0 ^ x1 of tf(key_{o,b}, (0, j))
//   normal[j] = sqrt(2) * erfinv(max(lo, f * (1 - lo) + lo)),
//               f = float(bits >> 9 | 0x3F800000) - 1, lo = nextafter(-1, 0)
//
// Every product and sum of the normal map is rounded on its own
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the twin's separate
// PyTorch operations round them. erfinvf is CUDA's; the twin's is
// torch.special.erfinv, so the normals may differ from the twin's in the
// last bits, the bits never.

#pragma once

#include <cstdint>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// threefry2x32, 20 rounds: (x0, x1) = tf((k0, k1), (c0, c1))
__device__ __forceinline__ void tf2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                       uint32_t c1, uint32_t& x0,
                                       uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 = c0 + ks[0];
  x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// 32 random bits of sample j under the (object, block) key
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint32_t j) {
  uint32_t x0, x1;
  tf2x32(k0, k1, 0u, j, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float bits_to_normal(uint32_t b) {
  const float lo = -0x1.fffffep-1f;          // nextafter(-1, 0)
  const float sqrt2 = 0x1.6a09e6p+0f;        // float32(sqrt(2))
  const float f = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, lo)), lo));
  return __fmul_rn(sqrt2, erfinvf(u));
}

}  // namespace threefry
