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
// operations bound it (bench/roofline.py::span_inject).
//
// Precision: float32 in, float32 out, FP32-accurate. Both operands are
// split into two TF32 numbers, x = hi + lo (f by rounding, by truncation in
// the stacked variant, the table by truncation), and each product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi. The tensor cores' float32
// accumulation truncates, so the products restart from zero every
// ``restart`` k8 steps and are added to float32 registers with rounding
// to nearest (one slot), or multiplied by their slot's be_k and added to
// the injection (more slots); the complex products are be_re t_re - be_im
// t_im and be_re t_im + be_im t_re in the twin's order.
// Admitted by the measured error against the FP32 twin (<= -110 dB,
// chip_smoke.py, tests/test_torch_gpu.py). No [O, K, X, M] tensor is
// formed; no atomics, a fixed reduction order: two runs are bitwise equal.
//
// Three designs, chosen by the wrapper from the shape alone
// (ops/span_inject.py::variant_for):
//
// wgmma (variant wgmma): the asynchronous pipeline. The table operand is
// the K-major reversed copy bt[og, m, j] = lam^(C-1-j)[m] and its lo
// plane, re and im (ops/span.py::span_planes, made once with the tables:
// wgmma reads TF32 operands K-major only, and the table [C+1, M] is
// M-major). One block takes 128 injection rows (o, x) of one table and 64
// modes; a ring of four stages of 32 samples each (two sub-tiles of 16),
// guarded by full and empty mbarriers. A producer warp (its warpgroup
// lowered to 40 registers) keeps TMA loads in flight: each sub-tile's f
// rows of one slot ([O, K, X, C] as a 4-d tensor: a box of chunks of one
// object, or of whole objects' chunks where X is short) and the four bt
// planes' 64 modes, 16 floats a row with the 64-byte swizzle. Two
// consumer warpgroups (232 registers) split their 64 f rows in registers
// and feed them to wgmma m64n64k8 TF32 as A from registers, the re and im
// products sharing each A fragment. The stages walk the slots, each
// slot's samples in turn.
//
// Measured (bench/span_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 3.05-3.19 ms at 256 objects, X = C = 512, against 5.69-5.74 for the
// mma design; stages of one 16-sample sub-tile took 3.65-3.71. Neither a
// ping-pong of the two consumer warpgroups (named barriers) nor a second
// set of A registers with one product group kept in flight helped (3.68,
// 4.84 ms).
//
// mma (variants mma16, mma64; the design of the first version): one block
// of eight warps takes 16 or 64 rows and 64 modes, the stages of 32
// samples double-buffered through shared memory by cp.async, the table
// rows fetched in reverse and split in registers, mma.sync m16n8k8, the
// slots inside the sample stages (a table stage fetched once for every
// slot). It stays for per-object tables with few chunks of one or two
// slots (hetero short spans; X = 16 rows, so 128-row wgmma tiles would
// stay mostly empty), for calls too small to fill the card with them, and
// for chunks the TMA cannot stride (C not a multiple of 4).
//
// stacked (variant stacked): per-object tables with few chunks (X <= 8)
// and many slots, the live stream's one- and four-block spans (X = 8
// chunks of 64 or 256 samples, K = 17 slots: a full bucket and the AR
// channel). There the mma design's 16-row tiles hold 8 chunks (half
// empty) and walk the slots one at a time, each with its own complex
// epilogue over the tile, and the 4096 blocks wait on latency. Here the
// GEMM's rows are an object's (slot, chunk) pairs, 8 rows a slot (X <= 8:
// no span of the session has more chunks of at most 256 samples, X = 16
// comes at C = 512): 136 rows in nine m16 tiles (94% full) at K = 17,
// each table tile read once a block for every slot. A lane's accumulator
// rows are then one chunk of every slot, so the sum over slots, be_k t_k
// in slot order, is taken in its own registers at the end of each restart
// interval: no shared memory, no atomics. A block of eight warps (one n8
// tile of 64 modes each) walks four mode tiles of one object through one
// double-buffered cp.async stream of 32-sample stages, the slots' be_k
// fetched into shared memory with each tile's first stage; the tile count
// is a template (3, 5 or 9), so no branch separates one tile's ldmatrix
// and split from the last one's products. Bound: at 256 objects, K = 17,
// X = 8, C = 64 and M = 1024, 27.4 GFLOP as three TF32 products, 0.085 ms
// at mma.sync's measured 321.7 TFLOP/s (bench/mma_rate.py), against 0.058
// ms of bytes (bench/roofline.py::span_inject): the tensor cores bound it,
// and every warp splits the shared f rows itself, two instructions a value
// by truncation (11% faster than by rounding, -122.5 dB). Measured
// (bench/span_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md): 0.189-0.195
// ms at C = 64 against 0.569-0.573 for mma16, 0.705-0.710 at C = 256
// against 2.19-2.21; with two slots mma16 stays faster (0.092 against
// 0.102).
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

// ------------------------------------------------------------------ wgmma

namespace wg {

using hopper::desc_sw64;
using hopper::mbar_arrive;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::swz64;

constexpr int kBN = 64;       // modes a block
constexpr int kBK = 16;       // samples a sub-tile (64-byte rows)
constexpr int kSub = 2;       // sub-tiles a stage
constexpr int kStages = 4;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// two consumer warpgroups of 64 rows each, after one producer warpgroup
struct Cfg {
  static constexpr int kCons = 2;
  static constexpr int kBM = 64 * kCons;
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr int kF = kBM * 64;     // bytes of a sub-tile's f rows
  static constexpr int kTab = kBN * 64;   // of one table plane's
  // a sub-tile: f, then bt_re, bt_im, bt_lo_re, bt_lo_im; kSub a stage
  static constexpr int kSubBytes = kF + 4 * kTab;
  static constexpr int kStage = kSub * kSubBytes;
  static constexpr int kSmem = kStages * kStage + 1024 + 16 * kStages;
};

struct Maps {
  CUtensorMap f;                            // [O, K, X, C]
  CUtensorMap bt_re, bt_im, lo_re, lo_im;   // [Og, M, C]
};

struct Args {
  const float *be_re, *be_im;   // [O, K, M]
  float *inj_re, *inj_im;       // [O, X, M]
  int O, K, X, C, M;
  int shared;
  // a tile's rows: xb chunks of each of ob objects (ob > 1 only for a
  // shared table with X < the tile), tpo tiles an object
  int xb, ob, tpo;
  int r_tiles, m_tiles;
  int restart;   // stages between restarts of the products
  int pairs;     // float2 stores
};

__device__ __forceinline__ float lds(const unsigned char* tile, int off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// acc += be_k p (complex) for the rows of ``obj`` (their o K, -1 when
// past the tile) at columns m_base + 8 j + 2 tig + e, in the twin's order:
// be_re t_re - be_im t_im, be_re t_im + be_im t_re
__device__ __forceinline__ void slot_sum(const Args& a, const int (&obj)[2],
                                         int k, int m_base,
                                         const float (&p_re)[32],
                                         const float (&p_im)[32],
                                         float (&acc_re)[32],
                                         float (&acc_im)[32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (obj[h] < 0) continue;
    const long long be = ((long long)obj[h] + k) * a.M;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m_base + 8 * j + e;
        const float br = m < a.M ? __ldg(a.be_re + be + m) : 0.f;
        const float bi = m < a.M ? __ldg(a.be_im + be + m) : 0.f;
        const int i = 4 * j + 2 * h + e;
        acc_re[i] += __fsub_rn(__fmul_rn(br, p_re[i]), __fmul_rn(bi, p_im[i]));
        acc_im[i] += __fadd_rn(__fmul_rn(br, p_im[i]), __fmul_rn(bi, p_re[i]));
      }
  }
}

__global__ void __launch_bounds__(Cfg::kThreads, 1)
    span_inject_tc_wg(const __grid_constant__ Maps maps, const Args a) {
  using G = Cfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t bars = smem_u32(smem + kStages * G::kStage);
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (kStages + i); };

  int bid = blockIdx.x;
  const int mt = bid % a.m_tiles;
  const int rt = bid / a.m_tiles;
  const int m0 = mt * kBN;
  const int o0 = rt / a.tpo * a.ob, x0 = rt % a.tpo * a.xb;
  const int og = a.shared ? 0 : o0;
  const int per_slot = (a.C + kSub * kBK - 1) / (kSub * kBK);
  const int stages = a.K * per_slot;

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
      const uint32_t bytes = a.xb * a.ob * 64 + 4 * G::kTab;
      for (int s = 0; s < stages; ++s) {
        const int slot = s % kStages;
        const int k = s / per_slot, j = (s - k * per_slot) * kSub * kBK;
        mbar_wait(empty(slot), ((s / kStages) & 1) ^ 1);
        const uint32_t bar = full(slot);
        // sub-tiles past C are neither brought nor read
        const int subs = min(kSub, (a.C - j + kBK - 1) / kBK);
        hopper::mbar_expect(bar, subs * bytes);
        for (int u = 0; u < subs; ++u) {
          const int j0 = j + u * kBK;
          const uint32_t st = smem_u32(smem + slot * G::kStage +
                                       u * G::kSubBytes);
          hopper::tma_load_4d(st, &maps.f, bar, j0, x0, k, o0);
          const uint32_t sb = st + G::kF;
          hopper::tma_load_3d(sb, &maps.bt_re, bar, j0, m0, og);
          hopper::tma_load_3d(sb + G::kTab, &maps.bt_im, bar, j0, m0, og);
          hopper::tma_load_3d(sb + 2 * G::kTab, &maps.lo_re, bar, j0, m0,
                              og);
          hopper::tma_load_3d(sb + 3 * G::kTab, &maps.lo_im, bar, j0, m0,
                              og);
        }
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
  // each row's (o, x), its o K for be_k (-1 past the tile) and flat row
  int obj[2], flat[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? rb : ra;
    const int o = o0 + i / a.xb, x = x0 + i % a.xb;
    const bool ok = i < a.xb * a.ob && x < a.X && o < a.O;
    obj[h] = ok ? o * a.K : -1;
    flat[h] = ok ? o * a.X + x : -1;
  }
  const int m_base = m0 + 2 * tig;

  // one slot: acc sums the products (t_0); more: acc is the injection
  float acc_re[32], acc_im[32], p_re[32], p_im[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_re[i] = acc_im[i] = p_re[i] = p_im[i] = 0.f;

  for (int s = 0; s < stages; ++s) {
    const int slot = s % kStages;
    const int k = s / per_slot, jb = s - k * per_slot;
    mbar_wait(full(slot), (s / kStages) & 1);
    const unsigned char* st = smem + slot * G::kStage;
    // the stage's sub-tiles that hold samples (one where C ends inside)
    const bool both = (jb * kSub + 1) * kBK < a.C;
    // A fragments of the k8 steps: register q holds row ra (rb for odd
    // q), sample 8 (kk % 2) + tig (+4 for q >= 2) of sub-tile kk / 2
    uint32_t a_hi[2 * kSub][4], a_lo[2 * kSub][4];
#pragma unroll
    for (int kk = 0; kk < 2 * kSub; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (q & 1) ? rb : ra;
        const int j = 8 * (kk % 2) + tig + ((q & 2) ? 4 : 0);
        const float x =
            kk < 2 || both
                ? lds(st + kk / 2 * G::kSubBytes, swz64(row, j))
                : 0.f;
        tf32x3::split_tf32(__float_as_uint(x), a_hi[kk][q], a_lo[kk][q]);
      }
    hopper::wgmma_fence();
    // the first product of a restart interval starts from zero
    const int keep = jb % a.restart != 0;
#pragma unroll
    for (int kk = 0; kk < 2 * kSub; ++kk) {
      if (kk >= 2 && !both) break;
      const uint32_t at =
          smem_u32(st + kk / 2 * G::kSubBytes + G::kF) + 32 * (kk % 2);
      const uint64_t re_hi = desc_sw64(at), im_hi = desc_sw64(at + G::kTab);
      const uint64_t re_lo = desc_sw64(at + 2 * G::kTab);
      const uint64_t im_lo = desc_sw64(at + 3 * G::kTab);
      const int first = kk == 0 ? keep : 1;
      hopper::mma_m64n64k8(p_re, a_lo[kk], re_hi, first);
      hopper::mma_m64n64k8(p_re, a_hi[kk], re_lo, 1);
      hopper::mma_m64n64k8(p_re, a_hi[kk], re_hi, 1);
      hopper::mma_m64n64k8(p_im, a_lo[kk], im_hi, first);
      hopper::mma_m64n64k8(p_im, a_hi[kk], im_lo, 1);
      hopper::mma_m64n64k8(p_im, a_hi[kk], im_hi, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(p_re);
    hopper::fence_regs(p_im);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(slot));   // this stage is free
    if ((jb + 1) % a.restart == 0 || jb + 1 == per_slot) {
      if (a.K == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc_re[i] += p_re[i];
          acc_im[i] += p_im[i];
        }
      } else {
        slot_sum(a, obj, k, m_base, p_re, p_im, acc_re, acc_im);
      }
    }
  }
  if (a.K == 1) {   // inj = be_0 t_0
    float t_re[32], t_im[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      t_re[i] = acc_re[i];
      t_im[i] = acc_im[i];
      acc_re[i] = acc_im[i] = 0.f;
    }
    slot_sum(a, obj, 0, m_base, t_re, t_im, acc_re, acc_im);
  }

  // accumulator 4 j + 2 h + e: row ra (rb for h = 1), mode m_base + 8 j + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (flat[h] < 0) continue;
    const long long base = (long long)flat[h] * a.M;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m_base + 8 * j;
      if (m >= a.M) continue;
      const long long at = base + m;
      const int i = 4 * j + 2 * h;
      if (a.pairs) {
        *reinterpret_cast<float2*>(a.inj_re + at) =
            make_float2(acc_re[i], acc_re[i + 1]);
        *reinterpret_cast<float2*>(a.inj_im + at) =
            make_float2(acc_im[i], acc_im[i + 1]);
      } else {
        a.inj_re[at] = acc_re[i];
        a.inj_im[at] = acc_im[i];
        if (m + 1 < a.M) {
          a.inj_re[at + 1] = acc_re[i + 1];
          a.inj_im[at + 1] = acc_im[i + 1];
        }
      }
    }
  }
}

// a tile's rows: (xb chunks, ob objects, tiles an object) at bm rows
void tile_rows(int O, int X, bool shared, int bm, int& xb, int& ob,
               int& tpo) {
  xb = X < bm ? X : bm;
  ob = X < bm && shared ? bm / X : 1;
  if (ob > O) ob = O;
  tpo = (X + xb - 1) / xb;
}

long long blocks(int O, int X, int M, bool shared, int bm) {
  int xb, ob, tpo;
  tile_rows(O, X, shared, bm, xb, ob, tpo);
  return (long long)((O + ob - 1) / ob) * tpo * ((M + kBN - 1) / kBN);
}

int launch(const float* f, const float* be_re, const float* be_im,
           const float* bt_re, const float* bt_im, const float* lo_re,
           const float* lo_im, int og_count, float* inj_re, float* inj_im,
           int O, int K, int X, int C, int M, int pairs, int restart_k8,
           void* stream) {
  using G = Cfg;
  const bool shared = og_count == 1;
  int xb, ob, tpo;
  tile_rows(O, X, shared, G::kBM, xb, ob, tpo);
  Maps maps;
  const unsigned long long c4 = 4ull * C;
  {
    const unsigned long long dims[4] = {
        (unsigned long long)C, (unsigned long long)X, (unsigned long long)K,
        (unsigned long long)O};
    const unsigned long long strides[3] = {c4, c4 * X, c4 * X * K};
    const unsigned box[4] = {kBK, (unsigned)xb, 1, (unsigned)ob};
    if (!hopper_host::encode_map(&maps.f, f, 4, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  {
    const unsigned long long dims[3] = {(unsigned long long)C,
                                        (unsigned long long)M,
                                        (unsigned long long)og_count};
    const unsigned long long strides[2] = {c4, c4 * M};
    const unsigned box[3] = {kBK, kBN, 1};
    const float* planes[4] = {bt_re, bt_im, lo_re, lo_im};
    CUtensorMap* maps_[4] = {&maps.bt_re, &maps.bt_im, &maps.lo_re,
                             &maps.lo_im};
    for (int i = 0; i < 4; ++i)
      if (!hopper_host::encode_map(maps_[i], planes[i], 3, dims, strides,
                                   box))
        return (int)cudaErrorInvalidValue;
  }
  const int m_tiles = (M + kBN - 1) / kBN;
  const int r_tiles = (O + ob - 1) / ob * tpo;
  const Args args{be_re, be_im, inj_re, inj_im, O, K, X, C, M,
                  shared ? 1 : 0, xb, ob, tpo, r_tiles, m_tiles,
                  restart_k8 / (2 * kSub) > 0 ? restart_k8 / (2 * kSub) : 1,
                  pairs};
  auto kernel = span_inject_tc_wg;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)r_tiles * m_tiles), G::kThreads, G::kSmem,
           static_cast<cudaStream_t>(stream)>>>(maps, args);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------- stacked

namespace st {

constexpr int kTiles = 9;   // m16 tiles of (slot, chunk) rows: 144 rows
using T = Tile<1, kTiles>;  // eight warps along 64 modes, one n8 tile each
constexpr int kChunks = 8;   // most chunks an object: the rows of a slot
constexpr int kSlots = 16 * kTiles / kChunks;   // slots a group: 18
constexpr int kTilesPerBlock = 4;   // mode tiles a block walks in turn

struct Args : ::Args {
  int restart;   // sample stages between restarts of the products
  int per_obj;   // blocks an object (kTilesPerBlock mode tiles each)
};

// the f row of this thread's copies for slot group g: row r of the tile
// is slot g kSlots + r / kChunks, chunk r % kChunks (-1 past K or X)
template <int kVec>
__device__ __forceinline__ void f_rows(const Args& a, int o, int g,
                                       int (&off)[FCopies<T::kBM, kVec>::kN]) {
  using F = FCopies<T::kBM, kVec>;
#pragma unroll
  for (int i = 0; i < F::kN; ++i) {
    const int r = (threadIdx.x + i * kThreads) / F::kRow;
    const int k = g * kSlots + r / kChunks, x = r % kChunks;
    off[i] = k < a.K && x < a.X ? (o * a.K + k) * a.X + x : -1;
  }
}

// be_k of slot group g at modes m0 .. m0+kBN-1 into be [2][kSlots][kBN]
// (re, im; zero past K and M)
template <int kVec>
__device__ __forceinline__ void load_be(const Args& a, float* be, int o,
                                        int g, int m0) {
  constexpr int kRow = kBN / kVec;
  for (int v = threadIdx.x; v < 2 * kSlots * kRow; v += kThreads) {
    const int part = v / (kSlots * kRow);
    const int rem = v - part * kSlots * kRow;
    const int kl = rem / kRow, m = (rem - kl * kRow) * kVec;
    const int k = g * kSlots + kl;
    const float* src = part ? a.be_im : a.be_re;
    const bool ok = k < a.K && m0 + m < a.M;
    copy_async<4 * kVec>(
        be + (part * kSlots + kl) * kBN + m,
        ok ? src + ((long long)o * a.K + k) * a.M + m0 + m : src,
        ok ? 4 * kVec : 0);
  }
}

// one stage's products of the first kT tiles added to pre (re) and pim
// (im): no branch between the tiles, so each tile's ldmatrix and split run
// ahead of the previous tile's products. f is split by truncation too, as
// every warp splits every tile's rows (two instructions a value, not four)
template <int kT>
__device__ __forceinline__ void products(float (&pre)[kT][4],
                                         float (&pim)[kT][4],
                                         const float* fs, const float* bs,
                                         int wn, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t a_addr = smem_addr(
      fs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdA + 4 * (lane >> 4));
  const float* bre = bs + tig * kLdB + wn * 8 + gid;
  const float* bim = bre + kBK * kLdB;
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const int at = kk * 8 * kLdB;
    uint32_t rh0, rl0, rh1, rl1, ih0, il0, ih1, il1;
    split_trunc(__float_as_uint(bre[at]), rh0, rl0);
    split_trunc(__float_as_uint(bre[at + 4 * kLdB]), rh1, rl1);
    split_trunc(__float_as_uint(bim[at]), ih0, il0);
    split_trunc(__float_as_uint(bim[at + 4 * kLdB]), ih1, il1);
#pragma unroll
    for (int mt = 0; mt < kT; ++mt) {
      const AFrag af = load_a<false>(a_addr + 4 * (mt * 16 * kLdA + kk * 8));
      mma3<false>(pre[mt], af, rh0, rh1, rl0, rl1);
      mma3<false>(pim[mt], af, ih0, ih1, il0, il1);
    }
  }
}

// Per-object tables with few chunks (X <= 8) and many slots: the GEMM's
// rows are the (slot, chunk) pairs of an object, 8 rows a slot (X padded
// to 8), so a lane's accumulator rows are chunk gid of every slot in its
// tiles (slot 2 mt + h in tile mt), and the sum over slots is taken in
// its own registers: inj += be_k t_k over the tiles, in slot order, at the
// end of each restart interval. A block walks kTilesPerBlock mode tiles of
// one object through one double-buffered stream of stages (mode tile,
// slot group, 32 samples), the slots' be_k of each (tile, group) fetched
// with its first stage, so the next tile's loads run under this one's
// products and epilogue. kT: the m16 tiles a slot group fills at most
// (the rest of the 144 rows stay zero and are not multiplied).
template <int kVec, int kT>
__global__ void __launch_bounds__(kThreads, 2)
    span_inject_tc_stacked(const Args a) {
  constexpr int kBe = 2 * kSlots * kBN;       // floats of one be buffer
  extern __shared__ __align__(16) float smem[];   // 2 stages, 2 be
  float* be_s = smem + 2 * T::kStage;
  const int o = blockIdx.x / a.per_obj;
  const int t0 = blockIdx.x % a.per_obj * kTilesPerBlock;
  const int n_tiles = min(kTilesPerBlock, a.m_tiles - t0);
  const long long og = (long long)o * a.tbl_stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int groups = (a.K + kSlots - 1) / kSlots;
  const int per = (a.C + kBK - 1) / kBK;   // sample stages a group
  const int per_tile = groups * per;
  const int stages = n_tiles * per_tile;

  float pre[kT][4], pim[kT][4];
  float inj_re[2] = {0.f, 0.f}, inj_im[2] = {0.f, 0.f};   // [column]

  int f_off[FCopies<T::kBM, kVec>::kN];
  // stage s: mode tile t0 + s / per_tile, slot group, samples jb kBK ..
  auto load = [&](int s) {
    const int t = s / per_tile, r = s - t * per_tile;
    const int g = r / per, jb = r - g * per;
    const int m0 = (t0 + t) * kBN;
    float* buf = smem + (s & 1) * T::kStage;
    f_rows<kVec>(a, o, g, f_off);
    load_f<T::kBM, kVec>(a, buf, f_off, 0, jb * kBK);
    load_table<kVec>(a, buf + T::kA, og, m0, jb * kBK);
    // be buffer (t groups + g) & 1: the next (tile, group)'s be lands
    // while this one's epilogues still read the other
    if (jb == 0)
      load_be<kVec>(a, be_s + ((t * groups + g) & 1) * kBe, o, g,
                            m0);
    copy_commit();
  };
  if (stages > 0) load(0);
  for (int s = 0; s < stages; ++s) {
    const int t = s / per_tile, r = s - t * per_tile;
    const int g = r / per, jb = r - g * per;
    const int slots = min(kSlots, a.K - g * kSlots);
    if (s + 1 < stages) {
      load(s + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();   // this stage has landed
    if (jb % a.restart == 0) {
#pragma unroll
      for (int mt = 0; mt < kT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) pre[mt][i] = pim[mt][i] = 0.f;
    }
    const float* buf = smem + (s & 1) * T::kStage;
    products<kT>(pre, pim, buf, buf + T::kA, warp, lane);
    if ((jb + 1) % a.restart == 0 || jb + 1 == per) {
      // inj += be_k t_k: accumulator i of tile mt is row 16 mt + gid
      // (+8 for i >= 2), mode 2 tig (+1 for odd i) of the warp's n8 tile
      const float* be =
          be_s + ((t * groups + g) & 1) * kBe + warp * 8 + 2 * tig;
#pragma unroll
      for (int mt = 0; mt < kT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kl = 2 * mt + h;
          if (kl >= slots) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float br = be[kl * kBN + e];
            const float bi = be[(kSlots + kl) * kBN + e];
            const float tr = pre[mt][2 * h + e], ti = pim[mt][2 * h + e];
            inj_re[e] +=
                __fsub_rn(__fmul_rn(br, tr), __fmul_rn(bi, ti));
            inj_im[e] +=
                __fadd_rn(__fmul_rn(br, ti), __fmul_rn(bi, tr));
          }
        }
    }
    if (r + 1 == per_tile) {   // the tile's last stage: write, start anew
      const int m = (t0 + t) * kBN + warp * 8 + 2 * tig;
      if (gid < a.X && m < a.M) {
        const long long at = ((long long)o * a.X + gid) * a.M + m;
        if (a.pairs) {
          *reinterpret_cast<float2*>(a.inj_re + at) =
              make_float2(inj_re[0], inj_re[1]);
          *reinterpret_cast<float2*>(a.inj_im + at) =
              make_float2(inj_im[0], inj_im[1]);
        } else {
          a.inj_re[at] = inj_re[0];
          a.inj_im[at] = inj_im[0];
          if (m + 1 < a.M) {
            a.inj_re[at + 1] = inj_re[1];
            a.inj_im[at + 1] = inj_im[1];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) inj_re[e] = inj_im[e] = 0.f;
    }
    __syncthreads();   // this stage's buffers are free for the next loads
  }
}

long long blocks(int O, int M) {
  const int m_tiles = (M + kBN - 1) / kBN;
  return (long long)O * ((m_tiles + kTilesPerBlock - 1) / kTilesPerBlock);
}

template <int kVec, int kT>
int launch_t(const Args& a, int O, void* stream) {
  auto kernel = span_inject_tc_stacked<kVec, kT>;
  const int smem = T::kSmemBytes + 2 * 2 * kSlots * kBN * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks(O, a.M), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// the fewest of 3, 5 or 9 tiles that hold a slot group's rows
template <int kVec>
int launch_x(const Args& a, int O, void* stream) {
  const int rows = min(a.K, kSlots) * kChunks;
  if (rows <= 48) return launch_t<kVec, 3>(a, O, stream);
  if (rows <= 80) return launch_t<kVec, 5>(a, O, stream);
  return launch_t<kVec, kTiles>(a, O, stream);
}

// X <= kChunks chunks an object
int launch(const ::Args& base, int O, int vec4, int restart_k8,
           void* stream) {
  if (base.X > kChunks) return (int)cudaErrorInvalidValue;
  // restart_k8 k8 steps between restarts: kBK / 8 a stage
  const Args a{base, restart_k8 / (kBK / 8) > 0 ? restart_k8 / (kBK / 8) : 1,
               (base.m_tiles + kTilesPerBlock - 1) / kTilesPerBlock};
  return vec4 ? launch_x<4>(a, O, stream) : launch_x<1>(a, O, stream);
}

}  // namespace st


extern "C" {

// The variants (ops/span_inject.py::VARIANTS): 0 mma16, 1 mma64 (the
// cp.async and mma.sync design at 16 or 64 rows a block), 2 wgmma (the
// TMA and wgmma pipeline), 3 stacked (an object's slots stacked as rows,
// X <= 8 chunks).

// Blocks of one launch of ``variant`` (the wrapper checks them against
// the grid limit).
long long span_inject_blocks(int O, int X, int M, long long tbl_stride,
                             int variant) {
  if (variant == 2)
    return wg::blocks(O, X, M, tbl_stride == 0, wg::Cfg::kBM);
  if (variant == 3) return st::blocks(O, M);
  int rows, groups;
  row_groups(O, X, tbl_stride, rows, groups);
  const int m_tiles = (M + kBN - 1) / kBN;
  const int bm = variant == 0 ? Tile<1, 1>::kBM : Tile<2, 2>::kBM;
  return (long long)groups * ((rows + bm - 1) / bm) * m_tiles;
}

// f [O, K, X*C]; be_re, be_im [O, K, M]; b_re, b_im [Og, C+1, M],
// tbl_stride floats apart (0: one shared table); bt_re, bt_im, lo_re,
// lo_im [Og, M, C], the reversed K-major table and the lo planes of its
// split (read by the wgmma variants only); inj_re, inj_im [O, X, M].
// float32, contiguous; O, X, C, M >= 1, K >= 1, O X below 2^31. vec4 != 0
// takes 16-byte copies in the mma and stacked variants (4 | C, 4 | M, f
// and the tables 16-byte aligned); pairs != 0 float2 stores (2 | M, the
// outputs 8-byte aligned). The wgmma variants need 4 | C, f and the planes
// 16-byte aligned (the TMA); the stacked variant X <= 8. restart_k8: the
// k8 steps between restarts of the wgmma and stacked variants' products (a
// multiple of 4). Returns the first cudaError_t (0 = success).
int span_inject(const float* f, const float* be_re, const float* be_im,
                const float* b_re, const float* b_im, const float* bt_re,
                const float* bt_im, const float* lo_re, const float* lo_im,
                long long tbl_stride, float* inj_re, float* inj_im, int O,
                int K, int X, int C, int M, int vec4, int pairs, int variant,
                int restart_k8, void* stream) {
  if (variant == 2)
    return wg::launch(f, be_re, be_im, bt_re, bt_im, lo_re, lo_im,
                      tbl_stride == 0 ? 1 : O, inj_re, inj_im, O, K, X, C, M,
                      pairs, restart_k8, stream);
  int rows, groups;
  row_groups(O, X, tbl_stride, rows, groups);
  const int m_tiles = (M + kBN - 1) / kBN;
  const bool small = variant == 0;
  const int bm = small ? Tile<1, 1>::kBM : Tile<2, 2>::kBM;
  const Args a{f, be_re, be_im, b_re, b_im, tbl_stride, inj_re, inj_im,
               K, X, C, M, rows, (rows + bm - 1) / bm, m_tiles, pairs};
  if (variant == 3) return st::launch(a, O, vec4, restart_k8, stream);
  const long long blocks = span_inject_blocks(O, X, M, tbl_stride, variant);
  if (small)
    return vec4 ? launch<1, 1, 4>(a, blocks, stream)
                : launch<1, 1, 1>(a, blocks, stream);
  return vec4 ? launch<2, 2, 4>(a, blocks, stream)
              : launch<2, 2, 1>(a, blocks, stream);
}

}  // extern "C"
