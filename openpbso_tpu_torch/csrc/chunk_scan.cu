// Chunk-state propagation of the chunked span, Hopper (sm_90a).
//
// Replaces the lax.scan of openpbso_tpu/ops/span.py::_chunk_start_states
// (single-level branch, span.py:400-417), which XLA ran as an X-step loop.
// For every (object, mode) oscillator, over the X = N/C chunks of a span:
//
//   starts[x] = z_x,   z_{x+1} = lam^C z_x + inj[x]     (no inj: ring-down)
//
// and z_final = z_X. starts[x] is the state *before* chunk x's update, as
// the JAX scan body emits it.
//
// Bound: memory. Each thread reads inj[x] and writes starts[x] (re and im)
// once: 16 O X M bytes per span with injections, 8 O X M without. At 256
// objects x 1024 modes and X = 512 that is ~2.1 GB, ~0.65 ms at the H100
// SXM data sheet's 3.35 TB/s (a reckoning, not a measurement). The
// recurrence is 6 flops per mode and chunk.
//
// Design against that bound: one thread per (object, mode), serial over X;
// neighbouring threads own neighbouring modes, so every load of
// inj[o, x, :] and store of starts[o, x, :] is coalesced. The injections do
// not depend on the carried state, so the unrolled loop keeps several of
// their loads in flight ahead of the serial multiply-adds. lam^C is read
// with object stride 0 for a shared bank. Every product and sum is rounded
// on its own (__fmul_rn, __fadd_rn: no fused multiply-add), in the order of
// the plain PyTorch twin, so the kernel gives the twin's bits.
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the launch error is returned as a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void rotate(float pr, float pi, float& zr,
                                       float& zi) {
  const float nr = __fsub_rn(__fmul_rn(pr, zr), __fmul_rn(pi, zi));
  const float ni = __fadd_rn(__fmul_rn(pi, zr), __fmul_rn(pr, zi));
  zr = nr;
  zi = ni;
}

// grid (ceil(M / kThreads), O); inj_re == nullptr is the ring-down case
__global__ void chunk_scan_kernel(
    const float* __restrict__ z_re, const float* __restrict__ z_im,
    const float* __restrict__ inj_re, const float* __restrict__ inj_im,
    const float* __restrict__ pc_re, const float* __restrict__ pc_im,
    long long pc_obj_stride,
    float* __restrict__ starts_re, float* __restrict__ starts_im,
    float* __restrict__ zf_re, float* __restrict__ zf_im, int M, int X) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y;
  if (m >= M) return;
  const long long om = (long long)o * M + m;
  const float pr = pc_re[o * pc_obj_stride + m];
  const float pi = pc_im[o * pc_obj_stride + m];
  float zr = z_re[om], zi = z_im[om];
  const long long base = (long long)o * X * M + m;
  if (inj_re != nullptr) {
#pragma unroll 8
    for (int x = 0; x < X; ++x) {
      const long long i = base + (long long)x * M;
      const float ir = inj_re[i], ii = inj_im[i];
      starts_re[i] = zr;
      starts_im[i] = zi;
      rotate(pr, pi, zr, zi);
      zr = __fadd_rn(zr, ir);
      zi = __fadd_rn(zi, ii);
    }
  } else {
#pragma unroll 8
    for (int x = 0; x < X; ++x) {
      const long long i = base + (long long)x * M;
      starts_re[i] = zr;
      starts_im[i] = zi;
      rotate(pr, pi, zr, zi);
    }
  }
  zf_re[om] = zr;
  zf_im[om] = zi;
}

}  // namespace

extern "C" {

// z [O, M]; inj [O, X, M] or both null (ring-down); lam^C rows [Og, M]
// with row stride pc_obj_stride (0 for a shared bank); outputs starts
// [O, X, M] and z_final [O, M]. Every array is float32, modes contiguous.
// Returns the launch's cudaError_t (0 = success).
int chunk_scan(const float* z_re, const float* z_im, const float* inj_re,
               const float* inj_im, const float* pc_re, const float* pc_im,
               long long pc_obj_stride, float* starts_re, float* starts_im,
               float* zf_re, float* zf_im, int O, int M, int X,
               void* stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, O);
  chunk_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z_re, z_im, inj_re, inj_im, pc_re, pc_im, pc_obj_stride, starts_re,
      starts_im, zf_re, zf_im, M, X);
  return (int)cudaGetLastError();
}

}  // extern "C"
