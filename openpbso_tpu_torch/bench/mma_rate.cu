// Throughput of mma.sync.m16n8k8 TF32 (FP32 accumulate) on the card: each
// warp issues kIlp independent accumulator chains for `iters` steps, so the
// rate is the tensor pipe's, not one chain's latency. Built and timed by
// bench/mma_rate.py; no part of the port calls it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int kIlp>
__global__ void mma_tf32_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  const uint32_t seed = threadIdx.x * 2654435761u + blockIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = (seed + q) & 0x3F800000u;
  b[0] = (seed ^ 7u) & 0x3F800000u;
  b[1] = (seed ^ 9u) & 0x3F800000u;
  float d[kIlp][4];
#pragma unroll
  for (int i = 0; i < kIlp; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) d[i][q] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kIlp; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// blocks x threads threads, each warp kIlp chains (ilp in {1, 2, 4, 8}) of
// `iters` mma steps; returns the launch's cudaError_t
int mma_tf32_rate(float* out, int blocks, int threads, int ilp, int iters,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ilp) {
    case 1: mma_tf32_loop<1><<<blocks, threads, 0, st>>>(out, iters); break;
    case 2: mma_tf32_loop<2><<<blocks, threads, 0, st>>>(out, iters); break;
    case 4: mma_tf32_loop<4><<<blocks, threads, 0, st>>>(out, iters); break;
    default: mma_tf32_loop<8><<<blocks, threads, 0, st>>>(out, iters); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
