// Within-chunk causal convolution of the chunked span, Hopper (sm_90a),
// on the tensor cores with the 3xTF32 split.
//
// Replaces the Toeplitz gather + einsum of
// openpbso_tpu/ops/span.py::_integrate_span_chunked (span.py:574-585),
// which materialised t_g [O, L*K, C, C] in device memory (268 MB at 256
// objects, K = 1, C = 512; 4.3 GB at K = 16) for one batched product:
//
//   out[o, l, x, c] = sum_k sum_{j<=c} g[o, l, k, c-j] f[o, k, x, j]
//
// for L listener rows, K force slots and X chunks of C samples. Per (o, l)
// that is a triangular GEMM, out[X, C] = sum_k F_k[X, C] T_k, with the
// Toeplitz operand T_k[j, c] = g[o, l, k, c-j] for j <= c.
//
// Bound: the triangle is O L K X C(C+1)/2 multiply-adds (1.7e10 at 256
// objects, one listener and slot, X = 512, C = 512), against 3 O X C
// floats of inputs and output (0.16 ms at the data sheet's 3.35 TB/s). On
// the CUDA cores that is ~0.51 ms at 67 TFLOP/s; as three TF32 products
// on the tensor cores ~0.21 ms at 495 TFLOP/s (data-sheet reckonings;
// mma.sync reaches ~320 TFLOP/s of TF32 on the card, bench/mma_rate.py).
//
// Precision: float32 in, float32 out, FP32-accurate. Each operand x is
// split into two TF32 numbers, x = hi + lo, and each product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi (the a_lo b_lo term is below float32
// rounding). For g, split once per slot, hi = rna(x) and lo = rna(x - hi);
// for f, split as each A fragment is loaded, hi = x with its low 13 bits
// cleared and lo = x - hi (exact), of which the tensor cores read the top
// 19 bits: two instructions an element. The tensor cores' own float32
// accumulation truncates, so the products start from zero every kFlush = 8
// k8 steps (four on the diagonal) and their sum is added to float32
// accumulators on the CUDA cores, with rounding to nearest. This split
// lives only inside this kernel and is admitted by its measured error
// against the FP32 twin (<= -110 dB, chip_smoke.py,
// tests/test_torch_gpu.py); the TF32 pin of precision.py (cuBLAS, cuDNN)
// stays.
//
// Design: one block per (object, tile of kBM = 16 chunks, group of up to
// kGroup = 512 output columns, listener row). For each slot k the block
// stages the tile's f rows (all C columns) and g[o, l, k, :] in shared
// memory with cp.async: every byte of f is read from device memory once
// per column group (once for C <= 512), and two blocks per SM overlap one's
// copies with the other's products (persistent blocks that double-buffer
// their stages measured slower: their last round is short). g is split
// into hi and lo once per slot and stored behind kGPad zeros, so entry
// (j, c) of T_k is g[kGPad + c - j]: nothing of size C x C exists. Each
// warp owns two strips of four n8 column tiles, one from each end of the
// group, so every warp does the same share of the triangle, and holds
// their [16 x 64] outputs in registers across every slot. A strip walks
// its k8 steps j8 = 0 .. its last tile: the B fragment of tile n at step
// j8 depends only on n - j8, so the strip keeps a window of four fragments
// in registers and loads one new fragment per step (a warp's lanes read
// 11 consecutive words: broadcasts, no bank conflicts); the A fragment
// (ldmatrix, rows width + 4 floats apart: conflict-free) is split in
// registers as it is loaded and feeds the strip's four tiles. Steps below
// the diagonal are branch-free; the last four steps of a strip, on its
// diagonal, skip the tiles above it at compile time, so the waste is the
// upper half of the diagonal n8 tiles (1.6% at C = 512). Each output is
// written once, without atomics, so two runs are bitwise equal.
//
// A second design, short (namespace st below), takes the live stream's
// short spans with a busy slot bucket (X <= 8 chunks, C <= 256; routed by
// ops/toeplitz_conv.py::variant_for), where this one's 16-row tiles are
// half empty and at C <= 192 only 1-3 of its 8 warps have columns: 0.011
// ms at one-block K = 17 against 0.029, 0.065 at four-block against 0.082
// (bench/toeplitz_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
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
using tf32x3::mma_tf32;
using tf32x3::smem_addr;
using tf32x3::split_tf32;
using tf32x3::split_trunc;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16;                         // chunk rows per block
constexpr int kStrip = 4;                       // n8 tiles per strip
constexpr int kGroup = 2 * kWarps * kStrip * 8; // output columns per block
constexpr int kFlush = 8;                       // k8 steps per FP32 add
constexpr int kGPad = 8;                        // zeros before g

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// dynamic shared memory, offsets in floats: the f tile [kBM][ld] (width
// columns, zero past C), the raw g row [width], g split into hi and lo
// behind kGPad zeros
struct Layout {
  int width, ld, raw, hi, lo, total;
  __host__ __device__ explicit Layout(int C) {
    width = round_up(C, 8 * kStrip);
    ld = width + 4;   // 4 (mod 32) words: ldmatrix rows hit distinct banks
    raw = kBM * ld;
    hi = raw + width;
    lo = hi + kGPad + width;
    total = lo + kGPad + width;
  }
};

// B fragment of the Toeplitz tile at diagonal offset d = n - j8 (d >= 0):
// lane (gid, tig) holds T[tig (+4)][gid] = g[8 d + gid - tig (- 4)];
// hi and lo point at g[gid - tig] of the split row
struct BFrag {
  uint32_t h0, h1, l0, l1;
};

__device__ __forceinline__ BFrag load_b(const float* hi, const float* lo,
                                        int d) {
  return {__float_as_uint(hi[8 * d]), __float_as_uint(hi[8 * d - 4]),
          __float_as_uint(lo[8 * d]), __float_as_uint(lo[8 * d - 4])};
}

// window slot of tile i's B fragment at k8 step u (mod kStrip)
__host__ __device__ constexpr int slot(int i, int u) {
  return ((i - u) % kStrip + kStrip) % kStrip;
}

// the three products of k8 step kU of a flush group of kG steps for the
// strip's tiles i >= kFrom; small terms first, started from zero at the
// group's first step
template <int kU, int kFrom, int kG>
__device__ __forceinline__ void step(float (&part)[kStrip][4], const AFrag& a,
                                     const BFrag (&w)[kStrip]) {
  constexpr bool kZero = kU % kG == 0;
#pragma unroll
  for (int i = kFrom; i < kStrip; ++i)
    mma_tf32<kZero>(part[i], a.lo, w[slot(i, kU)].h0, w[slot(i, kU)].h1);
#pragma unroll
  for (int i = kFrom; i < kStrip; ++i)
    mma_tf32<false>(part[i], a.hi, w[slot(i, kU)].l0, w[slot(i, kU)].l1);
#pragma unroll
  for (int i = kFrom; i < kStrip; ++i)
    mma_tf32<false>(part[i], a.hi, w[slot(i, kU)].h0, w[slot(i, kU)].h1);
}

// at the end of a flush group (step kU), add the tiles that took part
template <int kU, int kFrom, int kG>
__device__ __forceinline__ void flush(float (&acc)[kStrip][4],
                                      const float (&part)[kStrip][4]) {
  if constexpr ((kU + 1) % kG == 0) {
#pragma unroll
    for (int i = kFrom; i < kStrip; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] += part[i][q];
  }
}

// one k8 step j8 = j8_base + kU below the diagonal, every tile: the
// fragment of tile 0 at the next step replaces the one of tile 3 at this
// step, in the same window slot
template <int kU, int kG>
__device__ __forceinline__ void full_step(float (&acc)[kStrip][4],
                                          float (&part)[kStrip][4],
                                          BFrag (&w)[kStrip], uint32_t a_addr,
                                          const float* bh, const float* bl,
                                          int nb0, int j8_base) {
  const int j8 = j8_base + kU;
  const AFrag a = load_a<false>(a_addr + 32 * j8);
  const BFrag next = load_b(bh, bl, nb0 - j8 - 1);
  step<kU, 0, kG>(part, a, w);
  flush<kU, 0, kG>(acc, part);
  w[slot(kStrip - 1, kU)] = next;
}

// diagonal step kU: tiles i >= kU (B fragments d = i - kU, the window's),
// one flush group; the tiles that took part are all of them
template <int kU>
__device__ __forceinline__ void diagonal_step(float (&acc)[kStrip][4],
                                              float (&part)[kStrip][4],
                                              const BFrag (&w)[kStrip],
                                              uint32_t a_diag) {
  const AFrag a = load_a<false>(a_diag + 32 * kU);
  step<kU, kU, kStrip>(part, a, w);
  flush<kU, 0, kStrip>(acc, part);
}

// One strip s (n8 tiles 4s .. 4s+3) of this warp's 16 rows over one slot:
// k8 steps j8 = 0 .. 4s-1 with every tile, in flush groups of kFlush steps
// and a last group of four, then the four diagonal steps. a_addr: this
// lane's ldmatrix address at column 0; bh/bl: the split g row at this
// lane's gid - tig.
__device__ __forceinline__ void strip(float (&acc)[kStrip][4], int s,
                                      uint32_t a_addr, const float* bh,
                                      const float* bl) {
  static_assert(kStrip == 4 && kFlush == 8, "the unrolled steps below");
  const int nb0 = kStrip * s;
  BFrag w[kStrip];
#pragma unroll
  for (int i = 0; i < kStrip; ++i) w[i] = load_b(bh, bl, nb0 + i);
  float part[kStrip][4];
  int j8 = 0;
  for (; j8 + kFlush <= nb0; j8 += kFlush) {
    full_step<0, kFlush>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<1, kFlush>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<2, kFlush>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<3, kFlush>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<4, kFlush>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<5, kFlush>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<6, kFlush>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<7, kFlush>(acc, part, w, a_addr, bh, bl, nb0, j8);
  }
  if (j8 < nb0) {
    full_step<0, kStrip>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<1, kStrip>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<2, kStrip>(acc, part, w, a_addr, bh, bl, nb0, j8);
    full_step<3, kStrip>(acc, part, w, a_addr, bh, bl, nb0, j8);
  }
  const uint32_t a_diag = a_addr + 32 * nb0;
  diagonal_step<0>(acc, part, w, a_diag);
  diagonal_step<1>(acc, part, w, a_diag);
  diagonal_step<2>(acc, part, w, a_diag);
  diagonal_step<3>(acc, part, w, a_diag);
}

struct Args {
  const float* g;   // [O, L, K, C]
  const float* f;   // [O, K, X, C]
  float* out;       // [O, L, X, C]
  int L, K, X, C, x_tiles, groups;
};

// the tile's f rows of slot k (rows past X and columns past C zero-filled)
// and g[o, l, k, :] (zero past C)
template <int kVec>
__device__ __forceinline__ void load_slot(const Args& a, float* smem,
                                          const Layout& lay, int o, int ol,
                                          int k, int x0, int rows) {
  const int tid = threadIdx.x;
  const float* fk = a.f + ((long long)(o * a.K + k) * a.X + x0) * a.C;
  const int per_row = lay.width / kVec;
  for (int v = tid; v < kBM * per_row; v += kThreads) {
    const int r = v / per_row, j = (v - r * per_row) * kVec;
    const bool ok = r < rows && j < a.C;   // kVec = 4 only when 4 | C
    copy_async<4 * kVec>(smem + r * lay.ld + j,
                         ok ? fk + (long long)r * a.C + j : a.f,
                         ok ? 4 * kVec : 0);
  }
  const float* gk = a.g + ((long long)ol * a.K + k) * a.C;
  for (int j = tid * kVec; j < lay.width; j += kThreads * kVec) {
    const bool ok = j < a.C;
    copy_async<4 * kVec>(smem + lay.raw + j, ok ? gk + j : a.g,
                         ok ? 4 * kVec : 0);
  }
}

// grid: one block per (object, x tile, column group, listener row), the
// listener rows and column groups that read the same f tile adjacent
template <int kVec>
__global__ void __launch_bounds__(kThreads, 2)
    toeplitz_conv_tc(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(a.C);
  int bid = blockIdx.x;
  const int l = bid % a.L;
  bid /= a.L;
  const int grp = bid % a.groups;
  bid /= a.groups;
  const int xt = bid % a.x_tiles;
  const int o = bid / a.x_tiles;
  const int ol = o * a.L + l;
  const int x0 = xt * kBM, rows = min(kBM, a.X - x0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;   // fragment row, column
  // this warp's strips: a pair from both ends of the group's strips
  const int first = grp * (kGroup / (8 * kStrip));
  const int in_group = min(kGroup, lay.width - first * 8 * kStrip) /
                       (8 * kStrip);
  const int s0 = first + warp, s1 = first + in_group - 1 - warp;

  float* ghi = smem + lay.hi;
  float* glo = smem + lay.lo;
  if (tid < kGPad) ghi[tid] = glo[tid] = 0.f;
  const uint32_t a_addr = smem_addr(
      smem + ((lane & 7) + 8 * ((lane >> 3) & 1)) * lay.ld + 4 * (lane >> 4));
  const float* bh = ghi + kGPad + gid - tig;
  const float* bl = glo + kGPad + gid - tig;

  float acc[2][kStrip][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < kStrip; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][i][q] = 0.f;

  for (int k = 0; k < a.K; ++k) {
    if (k > 0) __syncthreads();   // the previous slot's reads are done
    load_slot<kVec>(a, smem, lay, o, ol, k, x0, rows);
    copy_commit();
    copy_wait<0>();
    __syncthreads();              // the slot has landed
    for (int j = tid; j < lay.width; j += kThreads) {
      uint32_t hi, lo;
      split_tf32(__float_as_uint(smem[lay.raw + j]), hi, lo);
      ghi[kGPad + j] = __uint_as_float(hi);
      glo[kGPad + j] = __uint_as_float(lo);
    }
    __syncthreads();              // the split row is visible
    if (s0 <= s1) strip(acc[0], s0, a_addr, bh, bl);
    if (s0 < s1) strip(acc[1], s1, a_addr, bh, bl);
  }

  // accumulator q of tile i: row gid (+8 for q >= 2), column 8 n + 2 tig
  // (+1 for odd q)
  float* o_tile = a.out + ((long long)ol * a.X + x0) * a.C;
  const bool pairs = (a.C & 1) == 0;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int s = p == 0 ? s0 : s1;
    if (p == 0 ? s0 > s1 : s0 >= s1) continue;
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      const int c = 8 * (kStrip * s + i) + 2 * tig;
      if (c >= a.C) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = gid + 8 * h;
        if (r >= rows) continue;
        float* dst = o_tile + (long long)r * a.C + c;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[p][i][2 * h], acc[p][i][2 * h + 1]);
        } else {
          dst[0] = acc[p][i][2 * h];
          if (c + 1 < a.C) dst[1] = acc[p][i][2 * h + 1];
        }
      }
    }
  }
}

template <int kVec>
int launch(const Args& a, long long blocks, void* stream) {
  const size_t smem = sizeof(float) * Layout(a.C).total;
  cudaError_t err = cudaFuncSetAttribute(
      toeplitz_conv_tc<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  toeplitz_conv_tc<kVec><<<(unsigned)blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ short chunks

// The transposed product for short chunks (X <= 8, C <= 256): per (o, l),
// out^T[c, x] = sum_k sum_j T_k[c, j] f_k^T[j, x], T_k[c, j] = g[k, c-j].
// The C output samples are the m16 rows, the X <= 8 chunks one n8 tile,
// the slots and the triangle's depth the k8 steps. One block per (object,
// listener row). A warp walks strips of four m16 row tiles (64 samples),
// a pair from both ends of the chunk (every pair the same depth) or one,
// over its group of slots (s, s + groups, ...): at C = 64 one strip and
// eight slot groups, at C = 256 two pairs and four groups, so all eight
// warps have work. The A fragment of row tile t at k8 step j8 is a window
// of g, entry (r, j) = g[16 t - 8 j8 + r - j]: it depends on 2 t - j8
// alone, so tile i of a strip takes at step j8 the fragment tile 0 took
// at step j8 - 2i, and each step loads one new fragment (a warp's lanes
// read 11 consecutive words: broadcasts) into a ring of eight, split by
// rounding, for 12 products; the B fragment (f, split by truncation) is
// shared by the strip's four tiles. The last eight steps of a strip, on
// its diagonal, drop tiles in pairs of steps at compile time. Products
// restart every eight steps and are added to the warp's own float32
// partial tile in shared memory. Slots stream through a ring of kStages
// stages (cp.async; a stage holds one slot of each group: f [8][ld], g
// behind kPadG zeros). The slot groups' partial tiles are summed in group
// order and written once, coalesced: two runs are bitwise equal. Bound
// (bench/roofline.py): bytes at the one-block span (0.0031 ms at 256
// objects, K = 17, C = 64), the 3xTF32 operations at the four-block one
// (0.0139 ms at C = 256); this design reaches 29% and 21% of them.

namespace st {

constexpr int kMaxX = 8;     // chunks: one n8 tile
constexpr int kMaxC = 256;   // samples a chunk: at most four strips
constexpr int kPadG = 16;    // zeros before g (the windows reach 15 back)
constexpr int kSteps = 8;    // k8 steps between restarts (an unrolled group)
constexpr int kBudget = 113 * 1024 / 4;   // floats a block: two an SM

struct Shape {
  int strips;   // strips of four m16 row tiles (64 samples)
  int width;    // 64 strips: samples a row holds (zero past C)
  int ld;       // f rows and the partial tiles, width + 4
  int glen;     // a g row: kPadG zeros, then width samples
  int units;    // strip pairs from both ends (one strip alone)
  int groups;   // slot groups: warps that share a unit
  int stage;    // floats a stage: one slot of each group
  int red;      // floats of the partial tiles [groups][8][ld]
  __host__ __device__ explicit Shape(int C) {
    strips = (C + 63) / 64;
    width = 64 * strips;
    ld = width + 4;
    glen = kPadG + width;
    units = (strips + 1) / 2;
    groups = kWarps / units;
    stage = groups * (8 * ld + glen);
    red = groups * 8 * ld;
  }
  // stages in flight: four where they fit two blocks an SM, else two
  __host__ __device__ int stages() const {
    return 4 * stage + red <= kBudget ? 4 : 2;
  }
};

// stage s: slot s groups + j of group j, its f rows (zero past X and C)
// and its g row (zero outside 0 .. C-1); slots past K zero
template <int kVec>
__device__ __forceinline__ void load_stage(const Args& a, const Shape& sh,
                                           float* st, int o, int ol,
                                           int s) {
  const int tid = threadIdx.x;
  const int per_row = sh.width / kVec;
  for (int v = tid; v < sh.groups * 8 * per_row; v += kThreads) {
    const int row = v / per_row, j = (v - row * per_row) * kVec;
    const int grp = row / 8, x = row - grp * 8;
    const int k = s * sh.groups + grp;
    const bool ok = k < a.K && x < a.X && j < a.C;   // kVec = 4: 4 | C
    copy_async<4 * kVec>(
        st + row * sh.ld + j,
        ok ? a.f + ((long long)(o * a.K + k) * a.X + x) * a.C + j : a.f,
        ok ? 4 * kVec : 0);
  }
  float* gs = st + sh.groups * 8 * sh.ld;
  const int per_g = sh.glen / kVec;
  for (int v = tid; v < sh.groups * per_g; v += kThreads) {
    const int grp = v / per_g, p = (v - grp * per_g) * kVec;
    const int k = s * sh.groups + grp, idx = p - kPadG;
    const bool ok = k < a.K && idx >= 0 && idx < a.C;
    copy_async<4 * kVec>(
        gs + grp * sh.glen + p,
        ok ? a.g + ((long long)ol * a.K + k) * a.C + idx : a.g,
        ok ? 4 * kVec : 0);
  }
}

// the A fragment of window e (entries g[8 e + r - j]): registers q = 0..3
// at words 8 e, 8 e + 8, 8 e - 4, 8 e + 4 (+ gid - tig, in gr)
__device__ __forceinline__ void window(AFrag& w, const float* gr, int e) {
  const int d = 8 * e;
  split_tf32(__float_as_uint(gr[d]), w.hi[0], w.lo[0]);
  split_tf32(__float_as_uint(gr[d + 8]), w.hi[1], w.lo[1]);
  split_tf32(__float_as_uint(gr[d - 4]), w.hi[2], w.lo[2]);
  split_tf32(__float_as_uint(gr[d + 4]), w.hi[3], w.lo[3]);
}

// k8 step j8 = base + kU of a strip whose first tile is t0: the new
// window (kLoad: tile 0 is active) into ring slot kU, the B fragment,
// then the three products of every tile i >= kFrom with the window tile
// 0 took 2i steps before (ring slot kU - 2i), small terms first
template <int kU, int kFrom, bool kLoad>
__device__ __forceinline__ void step(float (&part)[kStrip][4],
                                     AFrag (&h)[kSteps], const float* fr,
                                     const float* gr, int t0, int j8) {
  if constexpr (kLoad) window(h[kU], gr, 2 * t0 - j8);
  uint32_t bh0, bl0, bh1, bl1;
  split_trunc(__float_as_uint(fr[8 * j8]), bh0, bl0);
  split_trunc(__float_as_uint(fr[8 * j8 + 4]), bh1, bl1);
  constexpr bool kZero = kU == 0;
#pragma unroll
  for (int i = kFrom; i < kStrip; ++i)
    mma_tf32<kZero>(part[i], h[(kU - 2 * i + 2 * kSteps) % kSteps].lo, bh0,
                    bh1);
#pragma unroll
  for (int i = kFrom; i < kStrip; ++i)
    mma_tf32<false>(part[i], h[(kU - 2 * i + 2 * kSteps) % kSteps].hi, bl0,
                    bl1);
#pragma unroll
  for (int i = kFrom; i < kStrip; ++i)
    mma_tf32<false>(part[i], h[(kU - 2 * i + 2 * kSteps) % kSteps].hi, bh0,
                    bh1);
}

// the group's products into the warp's partial tile: accumulator q of
// tile i is chunk 2 tig (+1 for odd q), sample 16 (t0 + i) + gid (+8 for
// q >= 2); mine: the partial tile at chunk 2 tig, sample gid
__device__ __forceinline__ void flush(const float (&part)[kStrip][4],
                                      float* mine, int ld, int t0) {
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    float* at = mine + 16 * (t0 + i);
    at[0] += part[i][0];
    at[ld] += part[i][1];
    at[8] += part[i][2];
    at[ld + 8] += part[i][3];
  }
}

// One strip s (tiles t0 = 4 s .. t0 + 3) of one slot: k8 steps 0 .. 2 t0
// + 7, tile i active to step 2 (t0 + i) + 1; s groups of eight steps with
// every tile, then the last group on the diagonal. fr: f[x = gid][j =
// tig] of the slot; gr: g[gid - tig] of the slot.
__device__ __forceinline__ void strip(int s, const float* fr, const float* gr,
                                      float* mine, int ld) {
  const int t0 = kStrip * s;
  AFrag h[kSteps];
  // the windows tile 0 would have taken at steps -1 .. -6
#pragma unroll
  for (int i = 1; i <= 6; ++i) window(h[kSteps - i], gr, 2 * t0 + i);
  float part[kStrip][4];
  int j8 = 0;
  for (int g = 0; g < s; ++g, j8 += kSteps) {
    step<0, 0, true>(part, h, fr, gr, t0, j8 + 0);
    step<1, 0, true>(part, h, fr, gr, t0, j8 + 1);
    step<2, 0, true>(part, h, fr, gr, t0, j8 + 2);
    step<3, 0, true>(part, h, fr, gr, t0, j8 + 3);
    step<4, 0, true>(part, h, fr, gr, t0, j8 + 4);
    step<5, 0, true>(part, h, fr, gr, t0, j8 + 5);
    step<6, 0, true>(part, h, fr, gr, t0, j8 + 6);
    step<7, 0, true>(part, h, fr, gr, t0, j8 + 7);
    flush(part, mine, ld, t0);
  }
  step<0, 0, true>(part, h, fr, gr, t0, j8 + 0);
  step<1, 0, true>(part, h, fr, gr, t0, j8 + 1);
  step<2, 1, false>(part, h, fr, gr, t0, j8 + 2);
  step<3, 1, false>(part, h, fr, gr, t0, j8 + 3);
  step<4, 2, false>(part, h, fr, gr, t0, j8 + 4);
  step<5, 2, false>(part, h, fr, gr, t0, j8 + 5);
  step<6, 3, false>(part, h, fr, gr, t0, j8 + 6);
  step<7, 3, false>(part, h, fr, gr, t0, j8 + 7);
  flush(part, mine, ld, t0);
}

template <int kVec, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
    toeplitz_conv_tc_short(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Shape sh(a.C);
  const int l = blockIdx.x % a.L, o = blockIdx.x / a.L;
  const int ol = o * a.L + l;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int unit = warp % sh.units, grp = warp / sh.units;
  const int sa = unit, sb = sh.strips - 1 - unit;   // sa == sb: one strip
  const int stages = (a.K + sh.groups - 1) / sh.groups;
  float* red = smem + kStages * sh.stage;
  for (int i = tid; i < sh.red; i += kThreads) red[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load_stage<kVec>(a, sh, smem + s * sh.stage, o, ol, s);
    copy_commit();
  }
  float* mine = red + (grp * 8 + 2 * tig) * sh.ld + gid;
  for (int s = 0; s < stages; ++s) {
    copy_wait<kStages - 2>();
    __syncthreads();   // stage s has landed; stage s - 1 is read
    const int next = s + kStages - 1;
    if (next < stages)
      load_stage<kVec>(a, sh, smem + next % kStages * sh.stage, o, ol, next);
    copy_commit();
    if (s * sh.groups + grp < a.K) {
      const float* st = smem + s % kStages * sh.stage;
      const float* fr = st + (grp * 8 + gid) * sh.ld + tig;
      const float* gr =
          st + sh.groups * 8 * sh.ld + grp * sh.glen + kPadG + gid - tig;
      strip(sa, fr, gr, mine, sh.ld);
      if (sb != sa) strip(sb, fr, gr, mine, sh.ld);
    }
  }
  copy_wait<0>();
  __syncthreads();   // every warp's partial tile is complete
  float* o_rows = a.out + (long long)ol * a.X * a.C;
  for (int v = tid; v < a.X * a.C; v += kThreads) {
    const int x = v / a.C, c = v - x * a.C;
    float sum = red[x * sh.ld + c];
    for (int j = 1; j < sh.groups; ++j) sum += red[(j * 8 + x) * sh.ld + c];
    o_rows[v] = sum;
  }
}

long long smem_bytes(int C) {
  const Shape sh(C);
  return (long long)sizeof(float) * (sh.stages() * sh.stage + sh.red);
}

template <int kVec, int kStages>
int launch_stages(const Args& a, long long blocks, void* stream) {
  const size_t smem = smem_bytes(a.C);
  cudaError_t err = cudaFuncSetAttribute(
      toeplitz_conv_tc_short<kVec, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  toeplitz_conv_tc_short<kVec, kStages>
      <<<(unsigned)blocks, kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <int kVec>
int launch(const Args& a, long long blocks, void* stream) {
  return Shape(a.C).stages() == 4 ? launch_stages<kVec, 4>(a, blocks, stream)
                                  : launch_stages<kVec, 2>(a, blocks, stream);
}

}  // namespace st

}  // namespace

extern "C" {

// The variants (ops/toeplitz_conv.py::VARIANTS): 0 v3 (chunk rows as A,
// 16 a block), 1 short (the transposed product; X <= 8, C <= 256).

// Dynamic shared memory (bytes) one block of ``variant`` needs for chunks
// of C samples.
long long toeplitz_conv_smem_bytes(int C, int variant) {
  if (variant == 1) return st::smem_bytes(C);
  return (long long)sizeof(float) * Layout(C).total;
}

// Blocks of one launch of ``variant`` (the wrapper checks them against
// the grid limit).
long long toeplitz_conv_blocks(int O, int L, int X, int C, int variant) {
  if (variant == 1) return (long long)O * L;
  return (long long)O * L * ((X + kBM - 1) / kBM) *
         ((C + kGroup - 1) / kGroup);
}

// g [O, L, K, C]; f [O, K, X, C]; out [O, L, X, C]; float32, contiguous,
// O, L, X, C >= 1 and K >= 0; variant 1 needs X <= 8 and C <= 256. vec4
// != 0 takes 16-byte copies (4 | C and g, f 16-byte aligned). Returns the
// first cudaError_t (0 = success).
int toeplitz_conv(const float* g, const float* f, float* out, int O, int L,
                  int K, int X, int C, int vec4, int variant, void* stream) {
  const Args a{g, f, out, L, K, X, C, (X + kBM - 1) / kBM,
               (C + kGroup - 1) / kGroup};
  const long long blocks = toeplitz_conv_blocks(O, L, X, C, variant);
  if (variant == 1) {
    if (X > st::kMaxX || C > st::kMaxC) return (int)cudaErrorInvalidValue;
    return vec4 ? st::launch<4>(a, blocks, stream)
                : st::launch<1>(a, blocks, stream);
  }
  return vec4 ? launch<4>(a, blocks, stream) : launch<1>(a, blocks, stream);
}

}  // extern "C"
