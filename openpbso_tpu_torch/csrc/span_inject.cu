// Chunk-injection GEMM of the chunked span with its complex epilogue,
// Hopper (sm_90a), on the tensor cores with the 3xTF32 split.
//
// Replaces the per-chunk modal force gathers and injection sums of
// openpbso_tpu/ops/span.py::_integrate_span_chunked (span.py:587-594: the
// flipped rows, two contractions against the baby table and four
// [O, K, X, M] products summed over slots), the XLA form of the Pallas
// kernel's body contraction s_re/s_im and its products with b e
// (openpbso_tpu/ops/pallas_integrator.py:98-101). Per object o, chunk x of
// C samples and mode m, with be_k = b e_k the slots' modal amplitudes:
//
//   t_k[x, m]   = sum_j lam^(C-1-j)[m] f[o, k, x C + j]     (complex)
//   inj[o, x, m] = sum_k be_k[o, m] t_k[x, m]
//
// f [O, K, N] the per-slot profiles (N = X C, as force_span returns them,
// unflipped), lam^r the rows of the baby table b_re, b_im [Og, C+1, M]
// (Og = 1: a shared bank). inj feeds the chunk-state scan (chunk_scan.cu).
//
// Bound: 2 O K X C M multiply-adds (re and im). At 256 objects, one slot,
// X = C = 512 and M = 1024 that is 275 GFLOP: 1.67 ms as three TF32
// products at the data sheet's 495 TFLOP/s (4.1 ms in FP32 on the CUDA
// cores), against ~1.35 GB of f in and inj out (0.40 ms at 3.35 TB/s), so
// operations bound it (bench/roofline.py::span_inject). mma.sync reaches
// ~322 TFLOP/s of TF32 on the card (bench/mma_rate.py): 2.6 ms is this
// design's ceiling.
//
// Precision: float32 in, float32 out, FP32-accurate. Both operands are
// split into two TF32 numbers as their fragments are loaded, x = hi + lo
// (f by rounding, the table by truncation: two instructions), and each
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi (tf32x3.cuh). The tensor
// cores' float32 accumulation truncates, so each stage's products (four
// k8 steps) start from zero and are added to float32 registers with
// rounding to nearest; the epilogue forms be_re t_re - be_im t_im and
// be_re t_im + be_im t_re in the twin's order and adds them to the
// injection. Admitted by the measured error against the FP32
// twin (<= -110 dB, chip_smoke.py, tests/test_torch_gpu.py); the TF32 pin
// of precision.py stays.
//
// Design: the injection rows (o, x) that share a table are one GEMM: all O
// X rows for a shared bank, each object's X rows for per-object tables.
// One block of eight warps takes a tile of kBM of them and kBN = 64 modes;
// the grid puts the mode tiles that read one f tile next to each other.
// The block walks the C samples in stages of kBK = 32 and, within each,
// its slots, double-buffered through shared memory by cp.async: each
// slot's f rows (kBM rows x 32 samples), and once for all slots the table
// rows lam^(C-1-j) of the samples j, re and im (32 rows x 64 modes). The
// table rows are fetched in reverse, so no flipped copy of f exists. Each warp owns a 32 x 16 tile
// of (rows, modes) (16 x 8 for the one-block span's few chunks a table,
// or where 64-row blocks would not fill the card) and holds two
// accumulators, re and im, that share each A fragment (ldmatrix from f
// rows 36 words apart, conflict-free); the B fragments come from table
// rows 72 words apart (8 mod 32: the 32 lanes hit 32 banks). With one
// slot the stages' products are summed into t_0, whose complex product
// with each row's be_0 is the injection; with more, each stage's products
// are multiplied by their slot's be_k and added to the injection. It is
// written once at the end. No [O, K, X, M] tensor is formed; no atomics,
// a fixed reduction order: two runs are bitwise equal.
//
// Measured (bench/span_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md): 5.69
// ms at 256 objects, X = C = 512, 29% of the bound, against 6.44 for the
// first build, which split the table by rounding and multiplied every
// stage's products by be_k. A ring of three stages with one barrier each
// (5.98 ms against 5.76), one block an SM (8.05) and truncating f's split
// too (within the spread, -122.8 dB) did not help. Slots inside the
// sample stages took the one-block span with 17 slots (C = 64) from 0.81
// to 0.58 ms.
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
using tf32x3::load_a;
using tf32x3::mma3;
using tf32x3::smem_addr;
using tf32x3::split_trunc;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 64;         // modes per block
constexpr int kBK = 32;         // samples per stage
constexpr int kLdA = kBK + 4;   // 36 words: ldmatrix rows conflict-free
constexpr int kLdB = kBN + 8;   // 72 words: B fragment loads conflict-free

// a block's shape: kWM warps along the chunks, each kMT m16 tiles
template <int kWM, int kMT>
struct Tile {
  static constexpr int kBM = 16 * kWM * kMT;    // chunks per block
  static constexpr int kWN = kWarps / kWM;      // warps along the modes
  static constexpr int kNT = kBN / (8 * kWN);   // n8 tiles per warp
  // one stage in floats: f [kBM][kLdA], then the table [2][kBK][kLdB]
  static constexpr int kA = kBM * kLdA;
  static constexpr int kStage = kA + 2 * kBK * kLdB;
  static constexpr int kSmemBytes = 2 * kStage * (int)sizeof(float);
};

struct Args {
  const float* f;               // [O, K, X*C]
  const float *be_re, *be_im;   // [O, K, M]
  const float *b_re, *b_im;     // [Og, C+1, M]
  long long tbl_stride;         // floats between objects' tables (0: shared)
  float *inj_re, *inj_im;       // [O, X, M]
  // rows: the injection rows (o, x) of one table, in order: X of each
  // object, or all O X for a shared table (one group)
  int K, X, C, M, rows, r_tiles, m_tiles, pairs;
};

// a thread's copies of a stage's f tile: kN of kRow copies a row
template <int kBM, int kVec>
struct FCopies {
  static constexpr int kRow = kBK / kVec;
  static constexpr int kN = (kBM * kRow + kThreads - 1) / kThreads;
};

// the f row of this thread's i-th copy: (o K) X + x of its tile row (flat
// row o X + x), -1 past the tile's ``valid`` rows; slot k adds k X
template <int kBM, int kVec>
__device__ __forceinline__ void f_rows(const Args& a, int row0, int valid,
                                       int (&off)[FCopies<kBM, kVec>::kN]) {
  using F = FCopies<kBM, kVec>;
#pragma unroll
  for (int i = 0; i < F::kN; ++i) {
    const int r = (threadIdx.x + i * kThreads) / F::kRow;
    const int o = (row0 + r) / a.X;
    off[i] = r < valid ? o * a.K * a.X + (row0 + r - o * a.X) : -1;
  }
}

// slot k's f rows of the tile for samples j0 .. j0+kBK-1 (at the offsets
// of f_rows; zero past the rows and C)
template <int kBM, int kVec>
__device__ __forceinline__ void load_f(
    const Args& a, float* sm, const int (&off)[FCopies<kBM, kVec>::kN],
    int k, int j0) {
  using F = FCopies<kBM, kVec>;
#pragma unroll
  for (int i = 0; i < F::kN; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v >= kBM * F::kRow) break;
    const int r = v / F::kRow, j = (v - r * F::kRow) * kVec;
    const bool ok = off[i] >= 0 && j0 + j < a.C;   // kVec = 4 only if 4 | C
    copy_async<4 * kVec>(
        sm + r * kLdA + j,
        ok ? a.f + ((long long)off[i] + k * a.X) * a.C + j0 + j : a.f,
        ok ? 4 * kVec : 0);
  }
}

// the table rows C-1-j of samples j0 .. j0+kBK-1, re and im, modes m0 ..
// m0+kBN-1 (zero past C and M)
template <int kVec>
__device__ __forceinline__ void load_table(const Args& a, float* b,
                                           long long og, int m0, int j0) {
  constexpr int kRowB = kBN / kVec;
  for (int v = threadIdx.x; v < 2 * kBK * kRowB; v += kThreads) {
    const int part = v / (kBK * kRowB);
    const int rem = v - part * kBK * kRowB;
    const int jj = rem / kRowB, m = (rem - jj * kRowB) * kVec;
    const float* tbl = part ? a.b_im : a.b_re;
    const bool ok = j0 + jj < a.C && m0 + m < a.M;
    copy_async<4 * kVec>(
        b + (part * kBK + jj) * kLdB + m,
        ok ? tbl + og + (long long)(a.C - 1 - j0 - jj) * a.M + m0 + m : tbl,
        ok ? 4 * kVec : 0);
  }
}

// one stage's products into pre (re) and pim (im), started from zero
template <int kWM, int kMT>
__device__ __forceinline__ void products(
    float (&pre)[kMT][Tile<kWM, kMT>::kNT][4],
    float (&pim)[kMT][Tile<kWM, kMT>::kNT][4], const float* fs,
    const float* bs, int wm, int wn, int lane) {
  using T = Tile<kWM, kMT>;
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix: lane l passes row (l & 7) + 8 ((l >> 3) & 1), column 4 (l >> 4)
  const uint32_t a_addr = smem_addr(
      fs + (wm * kMT * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLdA +
      4 * (lane >> 4));
  const float* bre = bs + tig * kLdB + wn * T::kNT * 8 + gid;
  const float* bim = bre + kBK * kLdB;
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    AFrag af[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      af[mt] = load_a<true>(a_addr + 4 * (mt * 16 * kLdA + kk * 8));
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
      // B[k][n] = table row C-1-j (k = j - j0), mode n: lane (gid, tig)
      // takes samples tig and tig + 4, mode gid
      const int at = kk * 8 * kLdB + nt * 8;
      uint32_t rh0, rl0, rh1, rl1, ih0, il0, ih1, il1;
      split_trunc(__float_as_uint(bre[at]), rh0, rl0);
      split_trunc(__float_as_uint(bre[at + 4 * kLdB]), rh1, rl1);
      split_trunc(__float_as_uint(bim[at]), ih0, il0);
      split_trunc(__float_as_uint(bim[at + 4 * kLdB]), ih1, il1);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (kk == 0) {
          mma3<true>(pre[mt][nt], af[mt], rh0, rh1, rl0, rl1);
          mma3<true>(pim[mt][nt], af[mt], ih0, ih1, il0, il1);
        } else {
          mma3<false>(pre[mt][nt], af[mt], rh0, rh1, rl0, rl1);
          mma3<false>(pim[mt][nt], af[mt], ih0, ih1, il0, il1);
        }
      }
    }
  }
}

// inj += be_k t_k (complex) at this lane's rows 16 mt + 8 h of its warp
// tile (accumulators 2h, 2h+1; ``obj`` their rows' o K, -1 past the tile)
// and columns m_base + 8 nt + 2 tig (+1 for odd i), in the twin's order:
// be_re t_re - be_im t_im, be_re t_im + be_im t_re.
template <int kMT, int kNT>
__device__ __forceinline__ void slot_sum(const Args& a,
                                         const int (&obj)[kMT][2], int k,
                                         int m_base, int tig,
                                         const float (&t_re)[kMT][kNT][4],
                                         const float (&t_im)[kMT][kNT][4],
                                         float (&inj_re)[kMT][kNT][4],
                                         float (&inj_im)[kMT][kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (obj[mt][h] < 0) continue;
      const long long be = ((long long)obj[mt][h] + k) * a.M;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = m_base + nt * 8 + 2 * tig + j;
          const float br = m < a.M ? __ldg(a.be_re + be + m) : 0.f;
          const float bi = m < a.M ? __ldg(a.be_im + be + m) : 0.f;
          const int i = 2 * h + j;
          inj_re[mt][nt][i] += __fsub_rn(__fmul_rn(br, t_re[mt][nt][i]),
                                         __fmul_rn(bi, t_im[mt][nt][i]));
          inj_im[mt][nt][i] += __fadd_rn(__fmul_rn(br, t_im[mt][nt][i]),
                                         __fmul_rn(bi, t_re[mt][nt][i]));
        }
    }
}

// kSlots: K > 1, so each stage's products are multiplied by their slot's
// be_k and added to the injection; with one slot they are summed first
template <int kWM, int kMT, int kVec, bool kSlots>
__global__ void __launch_bounds__(kThreads, 2)
    span_inject_tc(const Args a) {
  using T = Tile<kWM, kMT>;
  constexpr int kNT = T::kNT;
  extern __shared__ __align__(16) float smem[];
  int bid = blockIdx.x;
  const int mt_ = bid % a.m_tiles;
  bid /= a.m_tiles;
  const int rt = bid % a.r_tiles;
  const int grp = bid / a.r_tiles;
  const int r0 = rt * T::kBM, m0 = mt_ * kBN;   // r0: within the group
  const int row0 = grp * a.rows + r0;           // flat row o X + x
  const int valid = min(T::kBM, a.rows - r0);
  const long long og = (long long)grp * a.tbl_stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::kWN, wn = warp % T::kWN;
  const int gid = lane >> 2, tig = lane & 3;
  // this lane's first accumulator row and the tile's end (flat rows); its
  // rows' o K for be_k; this thread's f rows
  const int lane_row = row0 + wm * kMT * 16 + gid, row_end = row0 + valid;
  int obj[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = lane_row + 16 * mt + 8 * h;
      obj[mt][h] = row < row_end ? row / a.X * a.K : -1;
    }
  int f_off[FCopies<T::kBM, kVec>::kN];
  f_rows<T::kBM, kVec>(a, row0, valid, f_off);

  // inj: sum_k be_k t_k; t: with one slot, t_0, the stages' products
  // summed
  float t_re[kMT][kNT][4], t_im[kMT][kNT][4];
  float inj_re[kMT][kNT][4], inj_im[kMT][kNT][4];
  float pre[kMT][kNT][4], pim[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t_re[mt][nt][i] = t_im[mt][nt][i] = inj_re[mt][nt][i] =
            inj_im[mt][nt][i] = 0.f;

  // stage s = (samples j0 = (s / K) kBK .., slot s % K): the slots are the
  // inner loop, so a table stage is fetched once for every slot. Buffer
  // (s & 1) holds the stage's f rows, buffer (j & 1) its table rows.
  const int stages = a.K * ((a.C + kBK - 1) / kBK);
  if (stages > 0) {
    load_f<T::kBM, kVec>(a, smem, f_off, 0, 0);
    load_table<kVec>(a, smem + T::kA, og, m0, 0);
    copy_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const int j = s / a.K, k = s - j * a.K;
    if (s + 1 < stages) {
      const int sn = s + 1, jn = sn / a.K;
      load_f<T::kBM, kVec>(a, smem + (sn & 1) * T::kStage, f_off,
                           sn - jn * a.K, jn * kBK);
      if (jn != j)
        load_table<kVec>(a, smem + (jn & 1) * T::kStage + T::kA, og, m0,
                         jn * kBK);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();   // this stage has landed
    products<kWM, kMT>(pre, pim, smem + (s & 1) * T::kStage,
                       smem + (j & 1) * T::kStage + T::kA, wm, wn, lane);
    if (kSlots) {        // inj += be_k t_k of this stage's products
      slot_sum(a, obj, k, m0 + wn * kNT * 8, tig, pre, pim, inj_re,
               inj_im);
    } else {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            t_re[mt][nt][i] += pre[mt][nt][i];
            t_im[mt][nt][i] += pim[mt][nt][i];
          }
    }
    __syncthreads();   // this stage's buffers are free for the next loads
  }
  if (!kSlots && stages > 0)   // one slot: inj = be_0 t_0
    slot_sum(a, obj, 0, m0 + wn * kNT * 8, tig, t_re, t_im, inj_re, inj_im);

  // accumulator i of tile (mt, nt): chunk gid (+8 for i >= 2), mode
  // 2 tig (+1 for odd i)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lane_row + mt * 16 + 8 * h;
        const int m = m0 + wn * kNT * 8 + nt * 8 + 2 * tig;
        if (row >= row_end || m >= a.M) continue;
        const long long at = (long long)row * a.M + m;
        if (a.pairs) {
          *reinterpret_cast<float2*>(a.inj_re + at) =
              make_float2(inj_re[mt][nt][2 * h], inj_re[mt][nt][2 * h + 1]);
          *reinterpret_cast<float2*>(a.inj_im + at) =
              make_float2(inj_im[mt][nt][2 * h], inj_im[mt][nt][2 * h + 1]);
        } else {
          a.inj_re[at] = inj_re[mt][nt][2 * h];
          a.inj_im[at] = inj_im[mt][nt][2 * h];
          if (m + 1 < a.M) {
            a.inj_re[at + 1] = inj_re[mt][nt][2 * h + 1];
            a.inj_im[at + 1] = inj_im[mt][nt][2 * h + 1];
          }
        }
      }
}

constexpr int kFullWave = 2 * 132;   // two blocks on each SM of an H100

// The block shape for ``groups`` tables of ``rows`` injection rows each:
// 64 rows a block where that fills the card, else 16 (the one-block span's
// few chunks of a per-object table, or a grid too small for 64)
bool small_tiles(int rows, int groups, int m_tiles) {
  const long long big = (rows + Tile<2, 2>::kBM - 1) / Tile<2, 2>::kBM;
  return rows <= 16 || big * groups * m_tiles < kFullWave;
}

// (rows of a group, groups): a shared table is one group of every row
void row_groups(int O, int X, long long tbl_stride, int& rows, int& groups) {
  rows = tbl_stride == 0 ? O * X : X;
  groups = tbl_stride == 0 ? 1 : O;
}

template <int kWM, int kMT, int kVec>
int launch(const Args& a, long long blocks, void* stream) {
  using T = Tile<kWM, kMT>;
  auto kernel = a.K > 1 ? span_inject_tc<kWM, kMT, kVec, true>
                        : span_inject_tc<kWM, kMT, kVec, false>;
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
long long span_inject_blocks(int O, int X, int M, long long tbl_stride) {
  int rows, groups;
  row_groups(O, X, tbl_stride, rows, groups);
  const int m_tiles = (M + kBN - 1) / kBN;
  const int bm = small_tiles(rows, groups, m_tiles) ? Tile<1, 1>::kBM
                                                    : Tile<2, 2>::kBM;
  return (long long)groups * ((rows + bm - 1) / bm) * m_tiles;
}

// f [O, K, X*C]; be_re, be_im [O, K, M]; b_re, b_im [Og, C+1, M],
// tbl_stride floats apart (0: one shared table); inj_re, inj_im [O, X, M].
// float32, contiguous; O, X, C, M >= 1, K >= 0, O X below 2^31. vec4 != 0
// takes 16-byte
// copies (4 | C, 4 | M, f and the tables 16-byte aligned); pairs != 0
// float2 stores (2 | M, the outputs 8-byte aligned). Returns the first
// cudaError_t (0 = success).
int span_inject(const float* f, const float* be_re, const float* be_im,
                const float* b_re, const float* b_im, long long tbl_stride,
                float* inj_re, float* inj_im, int O, int K, int X, int C,
                int M, int vec4, int pairs, void* stream) {
  int rows, groups;
  row_groups(O, X, tbl_stride, rows, groups);
  const int m_tiles = (M + kBN - 1) / kBN;
  const bool small = small_tiles(rows, groups, m_tiles);
  const int bm = small ? Tile<1, 1>::kBM : Tile<2, 2>::kBM;
  const Args a{f, be_re, be_im, b_re, b_im, tbl_stride, inj_re, inj_im,
               K, X, C, M, rows, (rows + bm - 1) / bm, m_tiles, pairs};
  const long long blocks = span_inject_blocks(O, X, M, tbl_stride);
  if (small)
    return vec4 ? launch<1, 1, 4>(a, blocks, stream)
                : launch<1, 1, 1>(a, blocks, stream);
  return vec4 ? launch<2, 2, 4>(a, blocks, stream)
              : launch<2, 2, 1>(a, blocks, stream);
}

}  // extern "C"
