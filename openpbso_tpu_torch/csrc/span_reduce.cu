// Mode-reduce GEMM of the chunked span with its weight prologue, Hopper
// (sm_90a), on the tensor cores with the 3xTF32 split.
//
// Replaces the two contractions over modes of the chunked span in
// openpbso_tpu/ops/span.py::_integrate_span_chunked: the per-slot kernels
// g (span.py:557-572) and the cross-chunk hom (span.py:602-619), the XLA
// form of the Pallas kernel's body contractions G and hom
// (openpbso_tpu/ops/pallas_integrator.py:86-88, :94-96). Per object o,
// listener row l, row r and column c:
//
//   out[o,l,r,c] = sum_m w_pr[o,l,r,m] B_re[og, off+c, m]
//                      + w_pi[o,l,r,m] B_im[og, off+c, m]   (+ add[o,l,r,c])
//   w_pr = t_re v_im + t_im v_re,   w_pi = t_re v_re - t_im v_im
//
// (ops/integrator.py::_complex_weights; t_im = 0 for real rows) with t
// [O, L, M] the masked transfer rows, B the chunk's power table [Og, C+1,
// M] (Og = 1: a shared bank), and v [O, R, M] either the chunk start
// states (hom: off = 1, R = X chunks, add = the within-chunk convolution,
// so out is the span's sound) or the slots' modal amplitudes b e_k (g:
// off = 0, R = K slots, no add).
//
// Bound: 2 O L R C M multiply-adds. For hom at 256 objects, one listener,
// X = C = 512 and M = 1024 that is 275 GFLOP: 1.67 ms as three TF32
// products at the data sheet's 495 TFLOP/s (4.1 ms in FP32 on the CUDA
// cores), against ~1.6 GB of v, add and out (0.48 ms at 3.35 TB/s), so
// operations bound it (bench/roofline.py::span_reduce). g is ~0.1% of
// that work; with per-object tables it reads the whole [O, C, M] table
// once, and bytes bound it.
//
// Precision: float32 in, float32 out, FP32-accurate. Every operand is
// split into two TF32 numbers, x = hi + lo (the weights by rounding, the
// table by truncation), and each product is a_lo b_hi + a_hi b_lo + a_hi
// b_hi. The tensor cores' float32 accumulation truncates, so the products
// restart from zero every ``restart`` k8 steps and are added to float32
// registers with rounding to nearest. Admitted by the measured error
// against the FP32 twin (<= -110 dB, chip_smoke.py,
// tests/test_torch_gpu.py). No atomics, a fixed reduction order: two runs
// are bitwise equal.
//
// Two designs, chosen by the wrapper from the shape alone
// (ops/span_reduce.py::variant_for):
//
// wgmma (variant wgmma): the asynchronous pipeline. One block takes 128
// output rows (o, l, r) of one table and 128 columns; a ring of three
// stages of 16 modes each in shared memory (64 KB a stage), guarded by
// full and empty mbarriers. A producer warp (its warpgroup
// lowered to 40 registers by setmaxnreg) keeps TMA loads in flight: the
// table rows off+c0 .. off+c0+127 of B_re, B_im and of their lo planes
// (ops/span.py::span_planes: lo = b - (b with its low 13 bits cleared),
// made once with the tables; the tensor cores read the top 19 bits, so
// hi is the table itself), the v rows of the tile and the few t rows they
// need, all 16 floats a row with the 64-byte swizzle. Two consumer
// warpgroups (raised to 232 registers) form the weights w_pr, w_pi of
// their 64 rows in registers from the v and t tiles, in the twin's
// rounding order, split them by rounding, and feed them to wgmma
// m64n128k8 TF32 as A from registers (mma.sync's m16n8k8 A layout, a
// warp's 16 rows): no weight plane in shared memory, no ldmatrix, no
// barrier between the prologue and the products. Per k8 step six
// products, lo·hi, hi·lo, hi·hi of the re half against B_re, then of the
// im half against B_im. The epilogue adds ``add`` (the convolution) and
// writes out once.
//
// Measured (bench/span_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md): hom
// 2.93-3.25 ms at 256 objects, X = C = 512, against 5.60-5.79 for the mma
// design. Without the weights' prologue it ran 2.66 ms, without the lo
// planes' loads no faster: the consumers' prologue, not the bytes, is
// what stands between this design and the tensor cores' rate; neither a
// ping-pong of the two consumer warpgroups nor a second set of A
// registers with one product group in flight recovered it (3.15-3.23,
// 4.33 ms).
//
// fp32 (variant fp32): per-object g of at most 4 rows an object, which
// reads the whole per-object table once for a few multiply-adds a float,
// so bytes bound it. One block of eight warps takes an object's rows and
// 32 of its columns: the weights of 256 modes at a time formed into shared
// memory, each warp streaming four columns' table rows with 16-byte loads
// and adding w_pr B_re + w_pi B_im in float32 on the CUDA cores (exact
// float32 products; one warp reduction a column). Measured (bench/
// span_ab.py; PERF.md): per-object g at 256 x 1024, C = 512, 0.344 ms
// against 0.382 for mma16, 94% of its byte bound; with 16 or 17 rows the
// weights' shared-memory reads made it 3-4x slower than mma16.
//
// mma (variants mma16, mma64; the design of the first version): one block
// of eight warps takes 16 or 64 rows and 128 columns, double-buffered
// through shared memory by cp.async, the weights formed and split into
// planes in shared memory, the table split in registers by truncation,
// mma.sync m16n8k8. It stays for the shapes whose few rows a table would
// leave a 128-row wgmma tile mostly empty (per-object g of many slots,
// short hom): those read their whole per-object table once and bytes
// bound them, so the table's own split in registers reads half the bytes
// of a lo plane; for calls too small to fill the card with 128-row tiles
// (a shared table's g); and for modes the TMA cannot stride (M not a
// multiple of 4).
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the first error is returned as a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::AFrag;
using tf32x3::copy_async;
using tf32x3::copy_commit;
using tf32x3::copy_wait;
using tf32x3::load_a_raw;
using tf32x3::mma3;
using tf32x3::smem_addr;
using tf32x3::split_tf32;
using tf32x3::split_trunc;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 128;      // output columns per block

// a block's shape: kWM warps along the rows, each kMT m16 tiles
template <int kWM, int kMT>
struct Tile {
  static constexpr int kBM = 16 * kWM * kMT;    // rows per block
  static constexpr int kWN = kWarps / kWM;      // warps along the columns
  static constexpr int kNT = kBN / (8 * kWN);   // n8 tiles per warp
  // modes per stage, of each half: 32 for the 16-row shape, whose blocks
  // stream per-object tables (128-byte row pieces), else 16; rows kBK + 4
  // words apart (4 mod 32): ldmatrix rows and B rows conflict-free
  static constexpr int kBK = kBM == 16 ? 32 : 16;
  static constexpr int kLd = kBK + 4;
  // one stage in floats: the weights' planes [4][kBM][kLd] (w_pr hi, lo,
  // w_pi hi, lo), then the table's [2][kBN][kLd] (re, im)
  static constexpr int kA = 4 * kBM * kLd;
  static constexpr int kStage = kA + 2 * kBN * kLd;
  static constexpr int kSmemBytes = 2 * kStage * (int)sizeof(float);
  static_assert(kBM * (kBK / 4) <= kThreads, "one weight quad a thread");
};

struct Args {
  const float *t_re, *t_im;   // [O, L, M]; t_im null: real rows
  const float *v_re, *v_im;   // [O, R, M]
  const float *b_re, *b_im;   // [Og, rows, M], rows >= off + C
  long long tbl_stride;       // floats between groups' tables (0: shared)
  const float* add;           // [O, L, R, C] or null
  float* out;                 // [O, L, R, C]
  // rows: the output rows (o, l, r) of one table, in order: L R of each
  // object, or all O L R for a shared table (one group)
  int L, R, C, M, off, rows, r_tiles, c_tiles, pairs;
};

// 4 modes from m of a row: one 16-byte load (kVec = 4: 4 | M, rows
// 16-byte aligned) or four; zero past M
template <int kVec>
__device__ __forceinline__ float4 load4(const float* row, int m, int M) {
  if constexpr (kVec == 4) {
    return m < M ? __ldg(reinterpret_cast<const float4*>(row + m))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(m < M ? __ldg(row + m) : 0.f,
                       m + 1 < M ? __ldg(row + m + 1) : 0.f,
                       m + 2 < M ? __ldg(row + m + 2) : 0.f,
                       m + 3 < M ? __ldg(row + m + 3) : 0.f);
  }
}

// one thread's share of a stage's weights: 4 modes of one row
struct Quad {
  float4 vr, vi, tr, ti;
};

// w_pr and w_pi of one element, in the twin's rounding order
__device__ __forceinline__ void weights(float tr, float ti, float vr,
                                        float vi, bool cplx, float& pr,
                                        float& pi) {
  if (cplx) {
    pr = __fadd_rn(__fmul_rn(tr, vi), __fmul_rn(ti, vr));
    pi = __fsub_rn(__fmul_rn(tr, vr), __fmul_rn(ti, vi));
  } else {
    pr = __fmul_rn(tr, vi);
    pi = __fmul_rn(tr, vr);
  }
}

__device__ __forceinline__ void split4(const float (&x)[4], float4& hi,
                                       float4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__float_as_uint(x[i]), h[i], l[i]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// the quad's weights, split, into the four planes of a stage
template <int kBM, int kLd>
__device__ __forceinline__ void store_weights(float* a, int row, int col,
                                              const Quad& q, bool cplx) {
  const float tr[4] = {q.tr.x, q.tr.y, q.tr.z, q.tr.w};
  const float ti[4] = {q.ti.x, q.ti.y, q.ti.z, q.ti.w};
  const float vr[4] = {q.vr.x, q.vr.y, q.vr.z, q.vr.w};
  const float vi[4] = {q.vi.x, q.vi.y, q.vi.z, q.vi.w};
  float pr[4], pi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) weights(tr[i], ti[i], vr[i], vi[i], cplx,
                                      pr[i], pi[i]);
  float4 hi, lo;
  float* at = a + row * kLd + col;
  split4(pr, hi, lo);
  *reinterpret_cast<float4*>(at) = hi;
  *reinterpret_cast<float4*>(at + kBM * kLd) = lo;
  split4(pi, hi, lo);
  *reinterpret_cast<float4*>(at + 2 * kBM * kLd) = hi;
  *reinterpret_cast<float4*>(at + 3 * kBM * kLd) = lo;
}

// the stage's table rows off+c0 .. off+c0+kBN-1, modes m0 .. m0+kBK-1 of
// B_re and B_im (zero past C and M)
template <int kVec, int kBK>
__device__ __forceinline__ void load_table(const Args& a, float* b,
                                           long long og, int c0, int m0) {
  constexpr int kLd = kBK + 4;
  constexpr int kPerRow = kBK / kVec;
  for (int v = threadIdx.x; v < 2 * kBN * kPerRow; v += kThreads) {
    const int part = v / (kBN * kPerRow);
    const int rem = v - part * kBN * kPerRow;
    const int c = rem / kPerRow, j = (rem - c * kPerRow) * kVec;
    const float* tbl = part ? a.b_im : a.b_re;
    const bool ok = c0 + c < a.C && m0 + j < a.M;
    copy_async<4 * kVec>(
        b + (part * kBN + c) * kLd + j,
        ok ? tbl + og + (long long)(a.off + c0 + c) * a.M + m0 + j : tbl,
        ok ? 4 * kVec : 0);
  }
}

// one stage's products into part, started from zero: the re half (w_pr
// planes against B_re), then the im half, two k8 steps each
template <int kWM, int kMT>
__device__ __forceinline__ void products(
    float (&part)[kMT][Tile<kWM, kMT>::kNT][4], const float* a,
    const float* b, int wm, int wn, int lane) {
  using T = Tile<kWM, kMT>;
  constexpr int kBK = T::kBK, kLd = T::kLd;
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix: lane l passes row (l & 7) + 8 ((l >> 3) & 1), column 4 (l >> 4)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 4 * (lane >> 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* ahi = a + 2 * h * T::kBM * kLd;
    const float* alo = ahi + T::kBM * kLd;
    const float* bh = b + h * kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      AFrag af[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int off = (wm * kMT * 16 + mt * 16 + lrow) * kLd + kk * 8 + lcol;
        load_a_raw(smem_addr(ahi + off), af[mt].hi);
        load_a_raw(smem_addr(alo + off), af[mt].lo);
      }
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        // B[k][n] = table row n, mode k: lane (gid, tig) takes rows
        // gid, modes tig and tig + 4
        const float* bp =
            bh + (wn * T::kNT * 8 + nt * 8 + gid) * kLd + kk * 8 + tig;
        uint32_t bh0, bl0, bh1, bl1;
        split_trunc(__float_as_uint(bp[0]), bh0, bl0);
        split_trunc(__float_as_uint(bp[4]), bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (h == 0 && kk == 0)
            mma3<true>(part[mt][nt], af[mt], bh0, bh1, bl0, bl1);
          else
            mma3<false>(part[mt][nt], af[mt], bh0, bh1, bl0, bl1);
        }
      }
    }
  }
}

template <int kWM, int kMT, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
    span_reduce_tc(const Args a) {
  using T = Tile<kWM, kMT>;
  constexpr int kNT = T::kNT, kBK = T::kBK;
  extern __shared__ __align__(16) float smem[];
  int bid = blockIdx.x;
  const int ct = bid % a.c_tiles;
  bid /= a.c_tiles;
  const int rt = bid % a.r_tiles;
  const int grp = bid / a.r_tiles;
  const int r0 = rt * T::kBM, c0 = ct * kBN;   // r0: within the group
  const long long row0 = (long long)grp * a.rows + r0;   // flat (o, l, r)
  const long long og = (long long)grp * a.tbl_stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::kWN, wn = warp % T::kWN;
  const bool cplx = a.t_im != nullptr;

  // this thread's weight quad: row qr, modes qc .. qc+3 of each stage; the
  // row's object, listener row and v row
  const bool has_quad = tid < T::kBM * (kBK / 4);
  const int qr = tid / (kBK / 4), qc = 4 * (tid % (kBK / 4));
  const bool row_ok = has_quad && r0 + qr < a.rows;
  const long long row = row_ok ? row0 + qr : 0;
  const long long lr = (long long)a.L * a.R;
  const long long o = row / lr, l = row / a.R % a.L, r = row % a.R;
  const long long vrow = (o * a.R + r) * a.M;
  const long long trow = (o * a.L + l) * a.M;
  Quad q;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int m0) {
    const int m = m0 + qc;
    q.vr = row_ok ? load4<kVec>(a.v_re + vrow, m, a.M) : zero;
    q.vi = row_ok ? load4<kVec>(a.v_im + vrow, m, a.M) : zero;
    q.tr = row_ok ? load4<kVec>(a.t_re + trow, m, a.M) : zero;
    q.ti = row_ok && cplx ? load4<kVec>(a.t_im + trow, m, a.M) : zero;
  };

  float acc[kMT][kNT][4], part[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int stages = (a.M + kBK - 1) / kBK;
  fetch(0);
  if (has_quad) store_weights<T::kBM, T::kLd>(smem, qr, qc, q, cplx);
  load_table<kVec, kBK>(a, smem + T::kA, og, c0, 0);
  copy_commit();
  for (int s = 0; s < stages; ++s) {
    float* cur = smem + (s & 1) * T::kStage;
    float* nxt = smem + ((s + 1) & 1) * T::kStage;
    const bool more = s + 1 < stages;
    if (more) {
      // the next stage's table in flight and its v, t in registers while
      // this stage's products run
      load_table<kVec, kBK>(a, nxt + T::kA, og, c0, (s + 1) * kBK);
      copy_commit();
      fetch((s + 1) * kBK);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();   // this stage's table and weights have landed
    products<kWM, kMT>(part, cur, cur + T::kA, wm, wn, lane);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    if (more && has_quad) store_weights<T::kBM, T::kLd>(nxt, qr, qc, q, cplx);
    __syncthreads();   // this stage's buffer is free for stage s + 2
  }

  // accumulator i of tile (mt, nt): row gid (+8 for i >= 2), column
  // 2 tig (+1 for odd i)
  const int gid = lane >> 2, tig = lane & 3;
  const long long base = row0 * a.C + c0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * kMT * 16 + mt * 16 + gid + 8 * h;
        const int c = wn * kNT * 8 + nt * 8 + 2 * tig;
        if (r0 + r >= a.rows || c0 + c >= a.C) continue;
        const long long at = base + (long long)r * a.C + c;
        float2 val = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (a.pairs) {
          if (a.add) {
            const float2 add = *reinterpret_cast<const float2*>(a.add + at);
            val.x += add.x;
            val.y += add.y;
          }
          *reinterpret_cast<float2*>(a.out + at) = val;
        } else {
          a.out[at] = a.add ? val.x + a.add[at] : val.x;
          if (c0 + c + 1 < a.C)
            a.out[at + 1] = a.add ? val.y + a.add[at + 1] : val.y;
        }
      }
}

// (rows of a group, groups): a shared table is one group of every row
void row_groups(int O, int L, int R, long long tbl_stride, long long& rows,
                long long& groups) {
  rows = (long long)L * R * (tbl_stride == 0 ? O : 1);
  groups = tbl_stride == 0 ? 1 : O;
}

template <int kWM, int kMT, int kVec>
int launch(const Args& a, long long blocks, void* stream) {
  using T = Tile<kWM, kMT>;
  auto kernel = span_reduce_tc<kWM, kMT, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, T::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------ wgmma

namespace wg {

using hopper::desc_sw64;
using hopper::mbar_arrive;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::swz64;

constexpr int kBN = 128;      // output columns a block
constexpr int kBK = 16;       // modes a stage (64-byte rows)
constexpr int kStages = 3;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// two consumer warpgroups of 64 rows each, after one producer warpgroup
struct Cfg {
  static constexpr int kCons = 2;
  static constexpr int kBM = 64 * kCons;
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr int kTab = kBN * 64;   // bytes of one table plane's stage
  static constexpr int kV = kBM * 64;     // of v's rows
  static constexpr int kT = kBM * 64;     // of t's rows (at most one a row)
  // a stage: b_re, b_im, lo_re, lo_im, v_re, v_im, t_re, t_im
  static constexpr int kStage = 4 * kTab + 2 * kV + 2 * kT;
  static constexpr int kSmem = kStages * kStage + 1024 + 16 * kStages;
};

struct Maps {
  CUtensorMap b_re, b_im, lo_re, lo_im;   // [Og, C+1, M]
  CUtensorMap v_re, v_im;                 // [O R, M]
  CUtensorMap t_re, t_im;                 // [O, L, M]
};

struct Args {
  const float* add;   // [O, L, R, C] or null
  float* out;         // [O, L, R, C]
  int O, L, R, C, M, off;
  int shared;         // one table for every object
  int group_rows;     // rows of one table's GEMM a listener row: O R or R
  int r_tiles, c_tiles;
  int t_rows;         // t rows a stage brings (the box)
  int cplx;           // t_im given
  int restart;        // stages between restarts of the products
  int pairs;          // float2 accesses of add and out
};

__device__ __forceinline__ float lds(const unsigned char* tile, int off) {
  return *reinterpret_cast<const float*>(tile + off);
}

__global__ void __launch_bounds__(Cfg::kThreads, 1)
    span_reduce_tc_wg(const __grid_constant__ Maps maps, const Args a) {
  using G = Cfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t bars = smem_u32(smem + kStages * G::kStage);
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (kStages + i); };

  int bid = blockIdx.x;
  const int ct = bid % a.c_tiles;
  bid /= a.c_tiles;
  const int rt = bid % a.r_tiles;
  bid /= a.r_tiles;
  const int groups = a.shared ? 1 : a.O;
  const int grp = bid % groups, l = bid / groups;
  const int c0 = ct * kBN, r0 = rt * G::kBM;   // r0: within the group
  // the tile's first v row (o R + r), its object, and its table
  const int vbase = (a.shared ? 0 : grp * a.R) + r0;
  const int o_first = vbase / a.R;
  const int og = a.shared ? 0 : grp;
  const int stages = (a.M + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full(i), 1);
      hopper::mbar_init(empty(i), 4 * G::kCons);   // one arrive a warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // the producer warpgroup
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint32_t bytes =
          4 * G::kTab + 2 * G::kV + (1 + a.cplx) * a.t_rows * 64;
      for (int s = 0; s < stages; ++s) {
        const int slot = s % kStages;
        mbar_wait(empty(slot), ((s / kStages) & 1) ^ 1);
        const uint32_t bar = full(slot);
        hopper::mbar_expect(bar, bytes);
        const uint32_t st = smem_u32(smem + slot * G::kStage);
        const int m0 = s * kBK, row = a.off + c0;
        hopper::tma_load_3d(st, &maps.b_re, bar, m0, row, og);
        hopper::tma_load_3d(st + G::kTab, &maps.b_im, bar, m0, row, og);
        hopper::tma_load_3d(st + 2 * G::kTab, &maps.lo_re, bar, m0, row, og);
        hopper::tma_load_3d(st + 3 * G::kTab, &maps.lo_im, bar, m0, row, og);
        const uint32_t sv = st + 4 * G::kTab;
        hopper::tma_load_2d(sv, &maps.v_re, bar, m0, vbase);
        hopper::tma_load_2d(sv + G::kV, &maps.v_im, bar, m0, vbase);
        hopper::tma_load_3d(sv + 2 * G::kV, &maps.t_re, bar, m0, l, o_first);
        if (a.cplx)
          hopper::tma_load_3d(sv + 2 * G::kV + G::kT, &maps.t_im, bar, m0, l,
                              o_first);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 cw .. 64 cw + 63 of the tile
  hopper::regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x - 128;
  const int cw = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int ra = cw * 64 + warp * 16 + gid, rb = ra + 8;
  // their t rows in the stage's t tile
  const int ta = min((vbase + ra) / a.R - o_first, a.t_rows - 1);
  const int tb = min((vbase + rb) / a.R - o_first, a.t_rows - 1);
  const bool cplx = a.cplx != 0;

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  for (int s = 0; s < stages; ++s) {
    const int slot = s % kStages;
    mbar_wait(full(slot), (s / kStages) & 1);
    const unsigned char* st = smem + slot * G::kStage;
    const unsigned char* vr = st + 4 * G::kTab;
    const unsigned char* vi = vr + G::kV;
    const unsigned char* tr = vi + G::kV;
    const unsigned char* ti = tr + G::kT;
    // A fragments of both k8 steps: register q holds row ra (rb for odd
    // q), mode 8 kk + tig (+4 for q >= 2)
    uint32_t pr_hi[2][4], pr_lo[2][4], pi_hi[2][4], pi_lo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (q & 1) ? rb : ra, trow = (q & 1) ? tb : ta;
        const int k = 8 * kk + tig + ((q & 2) ? 4 : 0);
        const float v_re = lds(vr, swz64(row, k));
        const float v_im = lds(vi, swz64(row, k));
        const float t_re = lds(tr, swz64(trow, k));
        const float t_im = cplx ? lds(ti, swz64(trow, k)) : 0.f;
        float pr, pi;
        weights(t_re, t_im, v_re, v_im, cplx, pr, pi);
        tf32x3::split_tf32(__float_as_uint(pr), pr_hi[kk][q], pr_lo[kk][q]);
        tf32x3::split_tf32(__float_as_uint(pi), pi_hi[kk][q], pi_lo[kk][q]);
      }
    hopper::wgmma_fence();
    // the first product of a restart interval starts from zero
    const int keep = s % a.restart != 0;
    const uint32_t b0 = smem_u32(st);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t at = b0 + 32 * kk;
      const uint64_t re_hi = desc_sw64(at), im_hi = desc_sw64(at + G::kTab);
      const uint64_t re_lo = desc_sw64(at + 2 * G::kTab);
      const uint64_t im_lo = desc_sw64(at + 3 * G::kTab);
      hopper::mma_m64n128k8(part, pr_lo[kk], re_hi, kk == 0 ? keep : 1);
      hopper::mma_m64n128k8(part, pr_hi[kk], re_lo, 1);
      hopper::mma_m64n128k8(part, pr_hi[kk], re_hi, 1);
      hopper::mma_m64n128k8(part, pi_lo[kk], im_hi, 1);
      hopper::mma_m64n128k8(part, pi_hi[kk], im_lo, 1);
      hopper::mma_m64n128k8(part, pi_hi[kk], im_hi, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(slot));   // this stage is free
    if ((s + 1) % a.restart == 0 || s + 1 == stages) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }

  // accumulator 4 j + 2 h + e: row ra (rb for h = 1), column 8 j + 2 tig
  // + e of the tile
  const int valid = min(G::kBM, a.group_rows - r0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? rb : ra;
    if (i >= valid) continue;
    const int fv = vbase + i, o = fv / a.R, r = fv - o * a.R;
    const long long base =
        (((long long)o * a.L + l) * a.R + r) * (long long)a.C;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + 2 * tig;
      if (c >= a.C) continue;
      const long long at = base + c;
      float2 val = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (a.pairs) {
        if (a.add) {
          const float2 add = *reinterpret_cast<const float2*>(a.add + at);
          val.x += add.x;
          val.y += add.y;
        }
        *reinterpret_cast<float2*>(a.out + at) = val;
      } else {
        a.out[at] = a.add ? val.x + a.add[at] : val.x;
        if (c + 1 < a.C) a.out[at + 1] = a.add ? val.y + a.add[at + 1] : val.y;
      }
    }
  }
}

// blocks of one launch at kBM rows a block
long long blocks(int O, int L, int R, int C, bool shared, int bm) {
  const long long rows = (long long)R * (shared ? O : 1);
  return (long long)L * (shared ? 1 : O) * ((rows + bm - 1) / bm) *
         ((C + kBN - 1) / kBN);
}

int launch(const float* t_re, const float* t_im, const float* v_re,
           const float* v_im, const float* b_re, const float* b_im,
           const float* lo_re, const float* lo_im, int og_count,
           const float* add, float* out, int O, int L, int R, int C, int M,
           int off, int pairs, int restart_k8, void* stream) {
  using G = Cfg;
  const bool shared = og_count == 1;
  const int group_rows = R * (shared ? O : 1);
  // t rows a tile of kBM v rows spans: its objects, at most one a row
  const int t_rows = shared ? min(G::kBM, (G::kBM - 1) / R + 2) : 1;
  Maps maps;
  const unsigned long long f4 = 4, m4 = f4 * M;
  {
    const unsigned long long dims[3] = {(unsigned long long)M,
                                        (unsigned long long)C + 1,
                                        (unsigned long long)og_count};
    const unsigned long long strides[2] = {m4, m4 * (C + 1)};
    const unsigned box[3] = {kBK, kBN, 1};
    const float* planes[4] = {b_re, b_im, lo_re, lo_im};
    CUtensorMap* maps_[4] = {&maps.b_re, &maps.b_im, &maps.lo_re,
                             &maps.lo_im};
    for (int i = 0; i < 4; ++i)
      if (!hopper_host::encode_map(maps_[i], planes[i], 3, dims, strides,
                                   box))
        return (int)cudaErrorInvalidValue;
  }
  {
    const unsigned long long dims[2] = {(unsigned long long)M,
                                        (unsigned long long)O * R};
    const unsigned long long strides[1] = {m4};
    const unsigned box[2] = {kBK, G::kBM};
    if (!hopper_host::encode_map(&maps.v_re, v_re, 2, dims, strides, box) ||
        !hopper_host::encode_map(&maps.v_im, v_im, 2, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  {
    const unsigned long long dims[3] = {(unsigned long long)M,
                                        (unsigned long long)L,
                                        (unsigned long long)O};
    const unsigned long long strides[2] = {m4, m4 * L};
    const unsigned box[3] = {kBK, 1, (unsigned)t_rows};
    if (!hopper_host::encode_map(&maps.t_re, t_re, 3, dims, strides, box))
      return (int)cudaErrorInvalidValue;
    // real rows: t_im unread, its map a copy
    if (t_im == nullptr)
      maps.t_im = maps.t_re;
    else if (!hopper_host::encode_map(&maps.t_im, t_im, 3, dims, strides,
                                      box))
      return (int)cudaErrorInvalidValue;
  }
  const Args args{add, out, O, L, R, C, M, off, shared ? 1 : 0, group_rows,
                  (group_rows + G::kBM - 1) / G::kBM, (C + kBN - 1) / kBN,
                  t_rows, t_im != nullptr ? 1 : 0,
                  restart_k8 / 4 > 0 ? restart_k8 / 4 : 1, pairs};
  auto kernel = span_reduce_tc_wg;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks(O, L, R, C, shared, G::kBM), G::kThreads,
           G::kSmem, static_cast<cudaStream_t>(stream)>>>(maps, args);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ------------------------------------------------------------------- fp32

namespace fp32 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMC = 256;   // modes a chunk of weights in shared memory

struct Args {
  const float *t_re, *t_im;   // [O, L, M]; t_im null: real rows
  const float *v_re, *v_im;   // [O, R, M]
  const float *b_re, *b_im;   // [Og, C+1, M]
  const float* add;           // [O, L, R, C] or null
  float* out;                 // [O, L, R, C]
  int shared, L, R, C, M, off, c_tiles;
};

constexpr int kCW = 4;     // columns a warp

// An object's L R rows (at most kRows) against kWarps kCW columns of its
// table: the weights of a chunk of kMC modes formed once into shared
// memory, each warp streaming its columns' table rows (16-byte loads, 4 |
// M) and adding w_pr B_re + w_pi B_im of every row into registers, in
// float32 on the CUDA cores; one warp reduction a column at the end.
template <int kRows>
__global__ void __launch_bounds__(kThreads)
    span_reduce_fp32(const Args a) {
  extern __shared__ __align__(16) float w[];   // [2][kRows][kMC]
  const int ct = blockIdx.x % a.c_tiles, o = blockIdx.x / a.c_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = a.L * a.R;
  const bool cplx = a.t_im != nullptr;
  const long long tbl = a.shared ? 0 : (long long)o * (a.C + 1) * a.M;
  const float* bre[kCW];
  const float* bim[kCW];
  int col[kCW];
#pragma unroll
  for (int j = 0; j < kCW; ++j) {
    col[j] = (ct * kWarps + warp) * kCW + j;
    const long long row =
        tbl + (long long)(a.off + min(col[j], a.C - 1)) * a.M;
    bre[j] = a.b_re + row;
    bim[j] = a.b_im + row;
  }
  float acc[kRows][kCW];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCW; ++j) acc[r][j] = 0.f;

  for (int m0 = 0; m0 < a.M; m0 += kMC) {
    for (int i = threadIdx.x; i < kRows * kMC; i += kThreads) {
      const int r = i / kMC, m = m0 + i % kMC;
      float pr = 0.f, pi = 0.f;
      if (r < rows && m < a.M) {
        const int l = r / a.R, rr = r - l * a.R;
        const long long tv = ((long long)o * a.L + l) * a.M + m;
        const long long vv = ((long long)o * a.R + rr) * a.M + m;
        weights(__ldg(a.t_re + tv), cplx ? __ldg(a.t_im + tv) : 0.f,
                    __ldg(a.v_re + vv), __ldg(a.v_im + vv), cplx, pr, pi);
      }
      w[i] = pr;
      w[kRows * kMC + i] = pi;
    }
    __syncthreads();
#pragma unroll 2
    for (int mi = lane * 4; mi < kMC; mi += 128) {
      if (m0 + mi >= a.M) break;
      float4 br[kCW], bi[kCW];
#pragma unroll
      for (int j = 0; j < kCW; ++j) {
        br[j] = __ldg(reinterpret_cast<const float4*>(bre[j] + m0 + mi));
        bi[j] = __ldg(reinterpret_cast<const float4*>(bim[j] + m0 + mi));
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 wr = *reinterpret_cast<const float4*>(w + r * kMC + mi);
        const float4 wi =
            *reinterpret_cast<const float4*>(w + (kRows + r) * kMC + mi);
#pragma unroll
        for (int j = 0; j < kCW; ++j) {
          float s = acc[r][j];
          s = fmaf(wr.x, br[j].x, s);
          s = fmaf(wr.y, br[j].y, s);
          s = fmaf(wr.z, br[j].z, s);
          s = fmaf(wr.w, br[j].w, s);
          s = fmaf(wi.x, bi[j].x, s);
          s = fmaf(wi.y, bi[j].y, s);
          s = fmaf(wi.z, bi[j].z, s);
          s = fmaf(wi.w, bi[j].w, s);
          acc[r][j] = s;
        }
      }
    }
    __syncthreads();   // the chunk's weights are free for the next
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCW; ++j) {
      float s = acc[r][j];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
      if (lane == 0 && r < rows && col[j] < a.C) {
        const int l = r / a.R, rr = r - l * a.R;
        const long long at =
            (((long long)o * a.L + l) * a.R + rr) * a.C + col[j];
        a.out[at] = a.add ? s + a.add[at] : s;
      }
    }
}

long long blocks(int O, int C) {
  return (long long)O * ((C + kWarps * kCW - 1) / (kWarps * kCW));
}

template <int kRows>
int launch_rows(const Args& a, int O, void* stream) {
  auto kernel = span_reduce_fp32<kRows>;
  const int smem = 2 * kRows * kMC * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)O * a.c_tiles), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// L R <= 4 rows an object, 4 | M, the tables 16-byte aligned
int launch(const float* t_re, const float* t_im, const float* v_re,
           const float* v_im, const float* b_re, const float* b_im,
           bool shared, const float* add, float* out, int O, int L, int R,
           int C, int M, int off, void* stream) {
  const int rows = L * R;
  if (rows > 4) return (int)cudaErrorInvalidValue;
  const Args a{t_re, t_im, v_re, v_im, b_re, b_im, add, out,
               shared ? 1 : 0, L, R, C, M, off,
               (C + kWarps * kCW - 1) / (kWarps * kCW)};
  return rows == 1 ? launch_rows<1>(a, O, stream)
                   : launch_rows<4>(a, O, stream);
}

}  // namespace fp32


extern "C" {

// The variants (ops/span_reduce.py::VARIANTS): 0 mma16, 1 mma64 (the
// cp.async and mma.sync design at 16 or 64 rows a block), 2 wgmma (the
// TMA and wgmma pipeline), 3 fp32 (the streaming design on the
// CUDA cores, L R <= 4 rows an object).

// Blocks of one launch of ``variant`` (the wrapper checks them against
// the grid limit).
long long span_reduce_blocks(int O, int L, int R, int C,
                             long long tbl_stride, int variant) {
  if (variant == 2)
    return wg::blocks(O, L, R, C, tbl_stride == 0, wg::Cfg::kBM);
  if (variant == 3) return fp32::blocks(O, C);
  long long rows, groups;
  row_groups(O, L, R, tbl_stride, rows, groups);
  const int c_tiles = (C + kBN - 1) / kBN;
  const int bm = variant == 0 ? Tile<1, 1>::kBM : Tile<2, 2>::kBM;
  return groups * ((rows + bm - 1) / bm) * c_tiles;
}

// t_re, t_im [O, L, M] (t_im null: real rows); v_re, v_im [O, R, M];
// b_re, b_im [Og, rows, M] with rows >= off + C, tbl_stride floats apart
// (0: one shared table); lo_re, lo_im their lo planes (read by the wgmma
// variants only, which need rows = C + 1); add [O, L, R, C] or null; out
// [O, L, R, C]; O L R below 2^31. float32, contiguous; O, L, R, C, M >= 1.
// vec4 != 0 takes 16-byte loads in the mma variants (4 | M, every row
// 16-byte aligned); pairs != 0 float2 accesses of add and out (2 | C, both
// 8-byte aligned). The wgmma variants need 4 | M and every tensor but add
// and out 16-byte aligned (the TMA), and restart_k8, the k8 steps between
// restarts of their products (a multiple of 4). Returns the first
// cudaError_t.
int span_reduce(const float* t_re, const float* t_im, const float* v_re,
                const float* v_im, const float* b_re, const float* b_im,
                const float* lo_re, const float* lo_im, long long tbl_stride,
                const float* add, float* out, int O, int L, int R, int C,
                int M, int off, int vec4, int pairs, int variant,
                int restart_k8, void* stream) {
  if (variant == 2)
    return wg::launch(t_re, t_im, v_re, v_im, b_re, b_im, lo_re, lo_im,
                      tbl_stride == 0 ? 1 : O, add, out, O, L, R, C, M, off,
                      pairs, restart_k8, stream);
  if (variant == 3)
    return fp32::launch(t_re, t_im, v_re, v_im, b_re, b_im, tbl_stride == 0,
                       add, out, O, L, R, C, M, off, stream);
  long long rows, groups;
  row_groups(O, L, R, tbl_stride, rows, groups);
  const int c_tiles = (C + kBN - 1) / kBN;
  const bool small = variant == 0;
  const int bm = small ? Tile<1, 1>::kBM : Tile<2, 2>::kBM;
  const Args a{t_re, t_im, v_re, v_im, b_re, b_im, tbl_stride, add, out,
               L, R, C, M, off, (int)rows, (int)((rows + bm - 1) / bm),
               c_tiles, pairs};
  const long long blocks = span_reduce_blocks(O, L, R, C, tbl_stride,
                                              variant);
  if (small)
    return vec4 ? launch<1, 1, 4>(a, blocks, stream)
                : launch<1, 1, 1>(a, blocks, stream);
  return vec4 ? launch<2, 2, 4>(a, blocks, stream)
              : launch<2, 2, 1>(a, blocks, stream);
}

}  // extern "C"
