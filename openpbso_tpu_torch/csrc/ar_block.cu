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
// chain of three float operations (a0 h0, + a1 h1, + sigma n_j; a1 h1 and
// sigma n_j are known a step early): S x 3 x ~4 clocks, ~3.1 us at S = 512
// and 1980 MHz (bench/roofline.py). The draws and the output are ~6 KB
// per object. The design keeps that chain short and everything else off
// it: one thread block per object draws the block's S normals into shared
// memory (all threads), then one thread runs the recurrence in registers,
// loading the normals as float4s a float4 ahead of use and storing the
// gated profile as float4s, so nothing but the three dependent operations
// sits on a step. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn) in the order of the plain twin (ops/ar_block.py), so given
// the same normals the kernel gives the twin's bits. The S floats of
// shared memory stay under the 48 KB that needs no attribute call.
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the first error is returned as a cudaError_t.

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// the recurrence's step: m_j from the history and the normal n
__device__ __forceinline__ float ar_step(float a0, float a1, float sg,
                                         float n, float& h0, float& h1) {
  const float mt = __fadd_rn(__fadd_rn(__fmul_rn(a0, h0), __fmul_rn(a1, h1)),
                             __fmul_rn(sg, n));
  h1 = h0;
  h0 = mt;
  return mt;
}

__device__ __forceinline__ float gated(float mo, float mt, float gate) {
  return __fmul_rn(__fadd_rn(mo, mt), gate);
}

// grid (O); dynamic shared memory S floats rounded up to a float4. kVec:
// S is a multiple of 4, so each profile row is 16-byte aligned
template <bool kVec>
__global__ void ar_block_kernel(const long long* __restrict__ key,
                                const float* __restrict__ a,
                                const float* __restrict__ hist,
                                const float* __restrict__ sigma,
                                const float* __restrict__ mu,
                                const bool* __restrict__ active,
                                uint32_t block_index,
                                float* __restrict__ profile,
                                float* __restrict__ hist_out, int S) {
  extern __shared__ float4 n4[];
  float* n = reinterpret_cast<float*>(n4);
  __shared__ uint32_t row_key[2];
  const int o = blockIdx.x;
  if (threadIdx.x == 0) {
    threefry::tf2x32((uint32_t)key[2 * o], (uint32_t)key[2 * o + 1], 0u,
                     block_index, row_key[0], row_key[1]);
  }
  __syncthreads();
  const uint32_t k0 = row_key[0], k1 = row_key[1];
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    n[j] = threefry::bits_to_normal(threefry::bits(k0, k1, (uint32_t)j));
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const bool on = active[o];
  const float a0 = a[2 * o], a1 = a[2 * o + 1], sg = sigma[o], mo = mu[o];
  const float gate = on ? 1.f : 0.f;
  float h0 = hist[2 * o], h1 = hist[2 * o + 1];
  float* prow = profile + (long long)o * S;
  const int quads = S / 4;
  float4 next = quads > 0 ? n4[0] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = 0; q < quads; ++q) {
    const float4 x = next;
    if (q + 1 < quads) next = n4[q + 1];
    float4 y;
    y.x = gated(mo, ar_step(a0, a1, sg, x.x, h0, h1), gate);
    y.y = gated(mo, ar_step(a0, a1, sg, x.y, h0, h1), gate);
    y.z = gated(mo, ar_step(a0, a1, sg, x.z, h0, h1), gate);
    y.w = gated(mo, ar_step(a0, a1, sg, x.w, h0, h1), gate);
    if constexpr (kVec) {
      reinterpret_cast<float4*>(prow)[q] = y;
    } else {
      prow[4 * q] = y.x;
      prow[4 * q + 1] = y.y;
      prow[4 * q + 2] = y.z;
      prow[4 * q + 3] = y.w;
    }
  }
  for (int j = 4 * quads; j < S; ++j)
    prow[j] = gated(mo, ar_step(a0, a1, sg, n[j], h0, h1), gate);
  hist_out[2 * o] = on ? h0 : hist[2 * o];
  hist_out[2 * o + 1] = on ? h1 : hist[2 * o + 1];
}

}  // namespace

extern "C" {

// key [O, 2] int64 (uint32 values); a, hist [O, 2], sigma, mu [O] float32;
// active [O] bool; block_index the block's noise counter; outputs profile
// [O, S] and hist_out [O, 2] float32; every array contiguous; S floats
// within the 48 KB of shared memory a launch takes without an attribute.
// Returns the first cudaError_t (0 = success).
int ar_block(const long long* key, const float* a, const float* hist,
             const float* sigma, const float* mu, const bool* active,
             long long block_index, float* profile, float* hist_out, int O,
             int S, void* stream) {
  const size_t smem = sizeof(float4) * ((S + 3) / 4);
  const int threads = S < kThreads ? (S + 31) / 32 * 32 : kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % 4 == 0) {
    ar_block_kernel<true><<<O, threads, smem, st>>>(
        key, a, hist, sigma, mu, active, (uint32_t)block_index, profile,
        hist_out, S);
  } else {
    ar_block_kernel<false><<<O, threads, smem, st>>>(
        key, a, hist, sigma, mu, active, (uint32_t)block_index, profile,
        hist_out, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
