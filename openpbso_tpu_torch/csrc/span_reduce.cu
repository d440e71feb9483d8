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
// operations bound it (bench/roofline.py::span_reduce). mma.sync reaches
// ~322 TFLOP/s of TF32 on the card (bench/mma_rate.py): 2.6 ms is this
// design's ceiling. g is ~0.1% of that work; with per-object tables it
// reads the whole [O, C, M] table once, and bytes bound it.
//
// Precision: float32 in, float32 out, FP32-accurate. Every operand is
// split into two TF32 numbers, x = hi + lo (the weights by rounding, the
// table by truncation: two instructions a fragment register), and each
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi (tf32x3.cuh). The tensor
// cores' float32 accumulation truncates, so each stage's products (four
// k8 steps, eight for the 16-row shape) start from zero and are added to
// float32 registers with rounding to nearest. Admitted by the measured
// error against the FP32 twin (<= -110 dB, chip_smoke.py,
// tests/test_torch_gpu.py); the TF32 pin of precision.py (cuBLAS, cuDNN)
// stays.
//
// Design: the output rows (o, l, r) that share a table are one GEMM: all
// O L R rows for a shared bank, each object's L R rows for per-object
// tables. One block of eight warps takes a tile of kBM of them and kBN =
// 128 columns; the grid puts the column tiles that read one v tile next to
// each other. The reduction walks the modes in stages of kBK modes (16;
// 32 for the 16-row shape, whose blocks stream per-object tables: its
// 128-byte row pieces read them faster than 64-byte ones),
// double-buffered:
//   - weight prologue: each thread loads one float4 of v_re, v_im and of
//     t for the next stage into registers while the warps multiply the
//     current one; after the products it forms w_pr and w_pi from them
//     (in the twin's rounding order), splits each into hi and lo and
//     stores the four planes to shared memory. No [O, L, R, M] weight
//     tensor exists in device memory.
//   - the table: the stage's kBN rows off+c, kBK modes each of B_re and
//     B_im, arrive by cp.async (16-byte copies where 4 | M).
//   - products: each warp owns a 32 x 32 output tile (16 x 16 for g's few
//     slot rows a table, or where the 64-row blocks would not fill the
//     card), A fragments by ldmatrix from the hi and lo planes (rows kBK
//     + 4 words apart: conflict-free), B fragments from the table rows
//     (as far apart: the 32 lanes hit 32 banks), split in registers by
//     truncation; the re half of the stage against B_re, the im half
//     against B_im.
//   - epilogue: add (the convolution) is read and out written once, as
//     float2 where C is even. No atomics, a fixed reduction order: two
//     runs are bitwise equal.
//
// Measured (bench/span_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md): hom
// 5.65 ms at 256 objects, X = C = 512, 29% of the bound, against 5.95 for
// the first build, which split the table by rounding; one block an SM was
// slower (7.01). Per-object g and short hom read their tables at 57-58%
// of the byte bound in stages of 16 modes, with two stages in flight or
// four, and at 83-84% in stages of 32 (g 0.558 -> 0.382 ms at 256 x 1024,
// C = 512).
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the first error is returned as a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kFullWave = 2 * 132;   // two blocks on each SM of an H100

// The block shape for ``groups`` tables of ``rows`` output rows each: 64
// rows a block (warp tiles of 32 x 32) where that fills the card, else 16
// (g's few slot rows, or a grid too small for the 64-row shape)
bool small_tiles(long long rows, long long groups, int c_tiles) {
  const long long big = (rows + Tile<2, 2>::kBM - 1) / Tile<2, 2>::kBM;
  return rows <= 32 || big * groups * c_tiles < kFullWave;
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

extern "C" {

// Blocks of one launch (the wrapper checks them against the grid limit).
long long span_reduce_blocks(int O, int L, int R, int C,
                             long long tbl_stride) {
  long long rows, groups;
  row_groups(O, L, R, tbl_stride, rows, groups);
  const int c_tiles = (C + kBN - 1) / kBN;
  const int bm = small_tiles(rows, groups, c_tiles) ? Tile<1, 1>::kBM
                                                    : Tile<2, 2>::kBM;
  return groups * ((rows + bm - 1) / bm) * c_tiles;
}

// t_re, t_im [O, L, M] (t_im null: real rows); v_re, v_im [O, R, M];
// b_re, b_im [Og, rows, M] with rows >= off + C, tbl_stride floats apart
// (0: one shared table); add [O, L, R, C] or null; out [O, L, R, C]; O L R
// below 2^31.
// float32, contiguous; O, L, R, C, M >= 1. vec4 != 0 takes 16-byte loads
// (4 | M, every row 16-byte aligned); pairs != 0 float2 accesses of add
// and out (2 | C, both 8-byte aligned). Returns the first cudaError_t.
int span_reduce(const float* t_re, const float* t_im, const float* v_re,
                const float* v_im, const float* b_re, const float* b_im,
                long long tbl_stride, const float* add, float* out, int O,
                int L, int R, int C, int M, int off, int vec4, int pairs,
                void* stream) {
  long long rows, groups;
  row_groups(O, L, R, tbl_stride, rows, groups);
  const int c_tiles = (C + kBN - 1) / kBN;
  const bool small = small_tiles(rows, groups, c_tiles);
  const int bm = small ? Tile<1, 1>::kBM : Tile<2, 2>::kBM;
  const Args a{t_re, t_im, v_re, v_im, b_re, b_im, tbl_stride, add, out,
               L, R, C, M, off, (int)rows, (int)((rows + bm - 1) / bm),
               c_tiles, pairs};
  const long long blocks = span_reduce_blocks(O, L, R, C, tbl_stride);
  if (small)
    return vec4 ? launch<1, 1, 4>(a, blocks, stream)
                : launch<1, 1, 1>(a, blocks, stream);
  return vec4 ? launch<2, 2, 4>(a, blocks, stream)
              : launch<2, 2, 1>(a, blocks, stream);
}

}  // extern "C"
