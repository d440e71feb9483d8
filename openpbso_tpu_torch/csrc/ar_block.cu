// One block of the sustained AR(2) channel, Hopper (sm_90a).
//
// Replaces openpbso_tpu/ops/forces.py::sustained_block (forces.py:587-617),
// a 512-step lax.scan over samples that eager PyTorch would run as ~5
// launches per sample (~2.5k per block). Per object o, for the block whose
// index is b (csrc/threefry.cuh draws n_j from (key_o, b, j)):
//
//   m_j       = (a0 h0 + a1 h1) + sigma n_j,   (h0, h1) <- (m_j, h0)
//   profile_j = (mu + m_j) * active
//   hist'     = (h0, h1) after the block where active, else hist
//
// Bound: the serial recurrence. Each object's S steps are a dependent
// chain of three float operations; the draws and the output are ~6 KB per
// object. The design keeps that chain short and everything else parallel:
// one thread block per object draws the block's S normals into shared
// memory (all threads), one thread runs the recurrence from shared memory
// and writes m_j back in place, and all threads write the gated profile,
// coalesced. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn) in the order of the plain twin (ops/ar_block.py), so given
// the same normals the kernel gives the twin's bits.
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the first error is returned as a cudaError_t.

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// grid (O); dynamic shared memory S floats
__global__ void ar_block_kernel(const long long* __restrict__ key,
                                const float* __restrict__ a,
                                const float* __restrict__ hist,
                                const float* __restrict__ sigma,
                                const float* __restrict__ mu,
                                const bool* __restrict__ active,
                                uint32_t block_index,
                                float* __restrict__ profile,
                                float* __restrict__ hist_out, int S) {
  extern __shared__ float m[];
  __shared__ uint32_t row_key[2];
  const int o = blockIdx.x;
  if (threadIdx.x == 0) {
    threefry::tf2x32((uint32_t)key[2 * o], (uint32_t)key[2 * o + 1], 0u,
                     block_index, row_key[0], row_key[1]);
  }
  __syncthreads();
  const uint32_t k0 = row_key[0], k1 = row_key[1];
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    m[j] = threefry::bits_to_normal(threefry::bits(k0, k1, (uint32_t)j));
  }
  __syncthreads();
  const bool on = active[o];
  if (threadIdx.x == 0) {
    const float a0 = a[2 * o], a1 = a[2 * o + 1], sg = sigma[o];
    float h0 = hist[2 * o], h1 = hist[2 * o + 1];
    for (int j = 0; j < S; ++j) {
      const float mt = __fadd_rn(
          __fadd_rn(__fmul_rn(a0, h0), __fmul_rn(a1, h1)),
          __fmul_rn(sg, m[j]));
      m[j] = mt;
      h1 = h0;
      h0 = mt;
    }
    hist_out[2 * o] = on ? h0 : hist[2 * o];
    hist_out[2 * o + 1] = on ? h1 : hist[2 * o + 1];
  }
  __syncthreads();
  const float gate = on ? 1.f : 0.f;
  const float mo = mu[o];
  float* prow = profile + (long long)o * S;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    prow[j] = __fmul_rn(__fadd_rn(mo, m[j]), gate);
  }
}

}  // namespace

extern "C" {

// key [O, 2] int64 (uint32 values); a, hist [O, 2], sigma, mu [O] float32;
// active [O] bool; block_index the block's noise counter; outputs profile
// [O, S] and hist_out [O, 2] float32; every array contiguous. Returns the
// first cudaError_t (0 = success).
int ar_block(const long long* key, const float* a, const float* hist,
             const float* sigma, const float* mu, const bool* active,
             long long block_index, float* profile, float* hist_out, int O,
             int S, void* stream) {
  const size_t smem = sizeof(float) * S;
  cudaError_t err = cudaFuncSetAttribute(
      ar_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = S < kThreads ? (S + 31) / 32 * 32 : kThreads;
  ar_block_kernel<<<O, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      key, a, hist, sigma, mu, active, (uint32_t)block_index, profile,
      hist_out, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
