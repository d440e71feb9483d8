// Hopper's asynchronous pipeline as inline PTX: mbarriers, TMA tensor
// loads, setmaxnreg, and warpgroup matrix products (wgmma) of TF32
// operands with A in registers and B in shared memory, plus the host
// side of a TMA tensor map (cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point, so the library needs no -lcuda).
//
// Used by csrc/span_inject.cu and csrc/span_reduce.cu. Every shared
// operand here is a tile of 16 floats a row (64 bytes) brought by TMA
// with the 64-byte swizzle: the 16-byte piece p of row r lands at piece
// p ^ ((r >> 1) & 3), so eight rows' reads of one column hit eight bank
// groups, and wgmma reads the same layout as a K-major operand (layout
// type 2, 512 bytes from one 8-row group to the next). Buffers start on
// 1024-byte boundaries.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element k (0..15) of row r in a 64-byte-swizzled tile
__device__ __forceinline__ int swz64(int r, int k) {
  return r * 64 + ((((k >> 2) ^ (r >> 1)) & 3) << 4) + ((k & 3) << 2);
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and add ``bytes`` to the phase's expected transaction count
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity ``parity`` has completed. A phase that
// never completes (a refused copy) traps after ~2^32 cycles, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 32)) __trap();
  }
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------ registers

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------- wgmma

// descriptor of a K-major operand of 64-byte swizzled rows at ``addr``
// (a shared address; + 32 bytes per k8 step inside the rows)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keep the compiler from moving reads of accumulators across a wait
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for one m64n64k8 TF32 tile: A from registers (warp w of
// the warpgroup holds rows 16w .. 16w+15 in mma.sync's m16n8k8 A layout),
// B [64 rows][8] K-major in shared memory by descriptor; accumulate
// starts d from zero when 0
__device__ __forceinline__ void mma_m64n64k8(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
        "l"(desc));
}

// d (+)= A B for one m64n128k8 TF32 tile: A from registers (warp w of
// the warpgroup holds rows 16w .. 16w+15 in mma.sync's m16n8k8 A layout),
// B [128 rows][8] K-major in shared memory by descriptor; accumulate
// starts d from zero when 0
__device__ __forceinline__ void mma_m64n128k8(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
        "l"(desc));
}


}  // namespace hopper

// ------------------------------------------------------------ host side

namespace hopper_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A float32 tensor map of ``rank`` dims (innermost first, each extent in
// elements; strides in bytes of dims 1..rank-1) read in boxes of ``box``
// elements, 16 floats a row with the 64-byte swizzle, zero past the
// edges. Returns false when the driver refuses it (alignment: the base
// and every stride on 16 bytes).
static inline bool encode_map(CUtensorMap* map, const void* base, int rank,
                              const unsigned long long* dims,
                              const unsigned long long* strides,
                              const unsigned* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
            const_cast<void*>(base), d, s, b, e,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper_host
