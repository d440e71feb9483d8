// Within-chunk causal convolution of the chunked span, Hopper (sm_90a).
//
// Replaces the Toeplitz gather + einsum of
// openpbso_tpu/ops/span.py::_integrate_span_chunked (span.py:574-585),
// which materialised t_g [O, L*K, C, C] in device memory (268 MB at 256
// objects, K = 1, C = 512; 4.3 GB at K = 16) for one batched product:
//
//   out[o, l, x, c] = sum_k sum_{j<=c} g[o, l, k, c-j] f[o, k, x, j]
//
// for L listener rows, K force slots and X chunks of C samples.
//
// Bound: FP32 issue on the CUDA cores. The triangle is O L K X C(C+1)/2
// multiply-adds (1.7e10 at 256 objects, one listener and slot, X = 512,
// C = 512: ~0.5 ms at the data sheet's 67 TFLOP/s, a reckoning), against
// only 3 O X C floats of inputs and output.
//
// Design against that bound: one block per (object, listener, tile of
// kTileX chunks). For each slot k the block stages g[o, l, k, :] and the
// tile's f rows in shared memory, the rows transposed to [C][kTileX] so
// that the kTileX values of one input sample j are four float4 broadcast
// reads; the Toeplitz product is built there and nothing of size C*C
// exists anywhere. A thread owns the output columns c and C-1-c, so every
// thread does about the same C+1 steps over j whatever its c, and keeps
// their 2*kTileX sums in registers across the slots: 32 multiply-adds per
// six shared-memory reads. Every lane of a warp steps through the same j
// (g is staged behind C zeros, which stand for the Toeplitz entries above
// the diagonal), so the row reads stay broadcasts; with a j of its own per
// lane they spread over 32 rows and bank-conflict. Each output is written
// once, without atomics, so two runs are bitwise equal.
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the first error is returned as a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 16;      // chunks per block (a multiple of 4)
constexpr int kMaxThreads = 256;

__device__ __forceinline__ void fma_row(float (&acc)[kTileX], float gv,
                                        const float4* row) {
#pragma unroll
  for (int q = 0; q < kTileX / 4; ++q) {
    const float4 fv = row[q];
    acc[4 * q + 0] += gv * fv.x;
    acc[4 * q + 1] += gv * fv.y;
    acc[4 * q + 2] += gv * fv.z;
    acc[4 * q + 3] += gv * fv.w;
  }
}

// grid (ceil(X / kTileX), O * L); shared memory fs [C][kTileX], and gs
// [2C]: C zeros, then g, so that gs[C + c - j] is the Toeplitz entry of
// (c, j), zero above the diagonal
__global__ void toeplitz_conv_kernel(const float* __restrict__ g,
                                     const float* __restrict__ f,
                                     float* __restrict__ out, int L, int K,
                                     int X, int C) {
  extern __shared__ float4 smem4[];
  float* fs = reinterpret_cast<float*>(smem4);
  float* gs = fs + C * kTileX;
  const int ol = blockIdx.y;
  const int o = ol / L;
  const int x0 = blockIdx.x * kTileX;
  const int nx = min(kTileX, X - x0);
  const int pairs = (C + 1) / 2;
  const int tid = threadIdx.x;
  for (int j = tid; j < C; j += blockDim.x) gs[j] = 0.f;

  for (int p0 = 0; p0 < pairs; p0 += blockDim.x) {
    // this thread's columns c0 <= c1 (equal for the middle column of an
    // odd C); the warp's j range covers its largest c0 with both columns
    // and its largest c1 with the long one, every lane at the same j
    const bool active = p0 + tid < pairs;
    const int c0 = active ? p0 + tid : 0;
    const int c1 = active ? C - 1 - c0 : 0;
    const int warp_c0 = p0 + (tid & ~31);
    const int jm0 = min(p0 + (tid | 31), pairs - 1);
    const int jm1 = C - 1 - warp_c0;
    float a0[kTileX], a1[kTileX];
#pragma unroll
    for (int i = 0; i < kTileX; ++i) a0[i] = a1[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      __syncthreads();                    // the previous slot's reads
      const float* gk = g + ((long long)ol * K + k) * C;
      for (int j = tid; j < C; j += blockDim.x) gs[C + j] = gk[j];
      const float* fk = f + (((long long)o * K + k) * X + x0) * C;
      for (int idx = tid; idx < kTileX * C; idx += blockDim.x) {
        const int xi = idx / C;
        const int j = idx - xi * C;
        fs[j * kTileX + xi] = xi < nx ? fk[(long long)xi * C + j] : 0.f;
      }
      __syncthreads();
      if (warp_c0 < pairs) {              // warp-uniform
        const float4* rows = reinterpret_cast<const float4*>(fs);
        const float* g0 = gs + C + c0;
        const float* g1 = gs + C + c1;
        int j = 0;
        for (; j <= jm0; ++j) {           // both columns
          const float4* row = rows + j * (kTileX / 4);
          fma_row(a0, g0[-j], row);
          fma_row(a1, g1[-j], row);
        }
        for (; j <= jm1; ++j) {           // the long column alone
          fma_row(a1, g1[-j], rows + j * (kTileX / 4));
        }
      }
    }
    if (active) {
      float* o_tile = out + ((long long)ol * X + x0) * C;
#pragma unroll
      for (int xi = 0; xi < kTileX; ++xi) {
        if (xi < nx) {
          o_tile[(long long)xi * C + c0] = a0[xi];
          if (c1 != c0) o_tile[(long long)xi * C + c1] = a1[xi];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block needs for chunks of C samples.
long long toeplitz_conv_smem_bytes(int C) {
  return 4LL * C * (kTileX + 2);
}

// g [O, L, K, C]; f [O, K, X, C]; out [O, L, X, C]; float32, contiguous.
// Returns the first cudaError_t (0 = success).
int toeplitz_conv(const float* g, const float* f, float* out, int O, int L,
                  int K, int X, int C, void* stream) {
  const size_t smem = (size_t)toeplitz_conv_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      toeplitz_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = (C + 1) / 2;
  int threads = (pairs + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid((X + kTileX - 1) / kTileX, O * L);
  toeplitz_conv_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(g, f, out, L, K,
                                                               X, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
