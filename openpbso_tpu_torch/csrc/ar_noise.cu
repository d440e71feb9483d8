// Counter-based AR noise of the sustained span, Hopper (sm_90a).
//
// Replaces openpbso_tpu/ops/forces.py::_noise_for_blocks (forces.py:343-381),
// which XLA ran as threefry2x32 per (object, block) key and per sample, then
// jax.random.normal's map. For object o, block x of the span and sample j:
//
//   b            = (idx0 + x) mod period     (period 0: no modulo)
//   key_{o,b}    = fold_in(key_o, b)
//   out[o, x, j] = normal(bits(key_{o,b}, j))          (csrc/threefry.cuh)
//
// Bound: integer throughput. Each sample is one threefry2x32 (20 rounds of an
// add, a rotate and a xor, plus six key injections: ~100 32-bit integer
// operations) and an erfinvf, against 4 bytes written. At the span shape
// 256 objects x 512 blocks x 512 samples that is 67M samples, ~7e9 integer
// operations and 268 MB written (~0.08 ms at the H100 SXM data sheet's
// 3.35 TB/s; a reckoning, not a measurement).
//
// Design: one block per (object, block) row. Thread 0 derives the row's
// key once (fold_in) into shared memory, so the per-sample work is one
// threefry, not two; the threads then stride over the row's samples, so
// neighbouring threads write neighbouring samples (coalesced). Nothing is
// carried between samples, so the output does not depend on the launch
// shape and two runs are bitwise equal. The same kernel, instantiated with
// kBits, writes the raw 32 random bits of each sample instead of its
// normal, so a check can hold the bits to the twin's exactly (the normals
// differ from the twin's only through erfinvf).
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the launch error is returned as a cudaError_t.

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// grid (X, O); key [O, 2] holds uint32 words in int64; out holds floats,
// or with kBits the uint32 bits
template <bool kBits>
__global__ void ar_noise_kernel(const long long* __restrict__ key,
                                long long idx0, long long period,
                                float* __restrict__ out, int X, int S) {
  __shared__ uint32_t row_key[2];
  const int x = blockIdx.x;
  const int o = blockIdx.y;
  if (threadIdx.x == 0) {
    long long b = idx0 + x;
    if (period > 0) b %= period;
    threefry::tf2x32((uint32_t)key[2 * o], (uint32_t)key[2 * o + 1], 0u,
                     (uint32_t)b, row_key[0], row_key[1]);
  }
  __syncthreads();
  const uint32_t k0 = row_key[0], k1 = row_key[1];
  float* row = out + ((long long)o * X + x) * S;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const uint32_t b = threefry::bits(k0, k1, (uint32_t)j);
    row[j] = kBits ? __uint_as_float(b) : threefry::bits_to_normal(b);
  }
}

}  // namespace

extern "C" {

// key [O, 2] int64 (uint32 values); out [O, X, S] float32 (bits != 0: the
// uint32 bits), contiguous; idx0 >= 0 is the span's first block index,
// period > 0 the modulus of the block index (0: none). Returns the
// launch's cudaError_t (0 = success).
int ar_noise(const long long* key, long long idx0, long long period,
             float* out, int O, int X, int S, int bits, void* stream) {
  const dim3 grid(X, O);
  const int threads = S < kThreads ? (S + 31) / 32 * 32 : kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits) {
    ar_noise_kernel<true><<<grid, threads, 0, st>>>(key, idx0, period, out,
                                                    X, S);
  } else {
    ar_noise_kernel<false><<<grid, threads, 0, st>>>(key, idx0, period, out,
                                                     X, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
