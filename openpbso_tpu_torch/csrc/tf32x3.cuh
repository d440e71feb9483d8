// FP32-accurate products on Hopper's tensor cores: the 3xTF32 split.
//
// Each float32 operand x is split into two TF32 numbers, x = hi + lo, and
// a product is a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo is below
// float32 rounding), each term an mma.sync m16n8k8 TF32 product with
// float32 accumulation. The tensor cores' own accumulation truncates, so a
// kernel restarts its products from zero every few k8 steps and adds them
// to float32 registers with rounding to nearest. Shared by
// csrc/toeplitz_conv.cu, csrc/fused_block.cu, csrc/span_inject.cu and
// csrc/span_reduce.cu, with the cp.async helpers at the end.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo: hi = x rounded to TF32 (nearest, ties away), lo = the rest
// rounded likewise; the tensor cores read the top 19 bits of each
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) + 0x1000u;
}

// x = hi + lo by truncation: hi = x with its low 13 bits cleared, lo =
// x - hi (exact), of which the tensor cores read the top 19 bits; two
// instructions
__device__ __forceinline__ void split_trunc(uint32_t x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// d (+)= A B for one m16n8k8 tile: A row-major 16x8, B 8x8, TF32 in, FP32
// out; kZero starts d from zero
template <bool kZero>
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kZero) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// A fragment of one k8 step, split: register q holds row gid (+8 for odd
// q), column tig (+4 for q >= 2) of the 16x8 tile
struct AFrag {
  uint32_t hi[4], lo[4];
};

// the four 8x4 quarters of a row-major 16x8 float tile in shared memory by
// one ldmatrix, split by truncation (kRound: by rounding) (lane l passes
// the address of row (l & 7) + 8 ((l >> 3) & 1), column 4 (l >> 4); rows
// 16-byte aligned)
template <bool kRound = false>
__device__ __forceinline__ AFrag load_a(uint32_t addr) {
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
  AFrag a;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (kRound)
      split_tf32(r[q], a.hi[q], a.lo[q]);
    else
      split_trunc(r[q], a.hi[q], a.lo[q]);
  }
  return a;
}

// the three products of one k8 step into d, small terms first; kZero
// starts d from zero (the first step of a flush group)
template <bool kZero>
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a,
                                     uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32<kZero>(d, a.lo, bh0, bh1);
  mma_tf32<false>(d, a.hi, bl0, bl1);
  mma_tf32<false>(d, a.hi, bh0, bh1);
}

// the same four quarters as load_a, unsplit: an operand stored already
// split (hi and lo planes) in shared memory
__device__ __forceinline__ void load_a_raw(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// kBytes (16 or 4) from global to shared memory, asynchronously; the bytes
// past src_bytes are zeroed (src_bytes 0: a masked copy, src any valid
// address)
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace tf32x3
