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
// Five designs, chosen by the wrapper from the shape alone
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
// leave a 128-row wgmma tile mostly empty on long chunks (per-object hom
// and g of many slots at C = 512): those read their whole per-object
// table once and bytes bound them, so the table's own split in registers
// reads half the bytes of a lo plane; for calls too small to fill the card
// with 128-row tiles (a shared table's g); and for modes the TMA cannot
// stride (M not a multiple of 4).
//
// split (variant split): per-object tables of 5 to 32 rows an object on
// short chunks, the live stream's one- and four-block spans (g: 17 rows,
// a full bucket and the AR channel; hom: 8 chunks; C = 64 and 256). The
// mma design gave them two 16-row tiles for 17 rows (the table read
// twice) and 128-column tiles half empty at C = 64. Here the product is
// transposed, out^T[c, n] = sum_m B[off+c, m] w[n, m]: the table's rows
// are A (64 columns, four m16 tiles, a block), all of an object's rows
// are B (n8 tiles), so the table is read once. Its rows, v's and t's
// stream through a four-stage cp.async ring of 32 modes each, every
// thread's copies of a stage found once (their address arithmetic on each
// stage's path had held it to 55% of the bytes' rate); each stage's
// weights are formed once, in the twin's order, and split into one of two
// buffers a stage ahead of the products, one barrier a stage. Each warp
// takes one column tile and one depth half, the depth permuted inside a
// step of 16 modes so a lane's 16-byte shared loads are its fragments;
// the halves are summed in a fixed order. Bytes bound it: 0.051 ms at 256
// objects, 17 rows, C = 64, M = 1024 (bench/roofline.py::span_reduce).
// Measured (bench/span_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md): g
// 0.067 ms at C = 64 against 0.136 for mma16, 0.231-0.239 at C = 256
// against 0.277-0.280; hom (8 rows) 0.058 against 0.073 and 0.196
// against 0.203. Tried and dropped (PERF.md): the table's rows loaded
// into registers by each warp, 16 warps splitting the modes (0.091,
// 0.320); each warp forming its own weights (0.111); whole-object blocks
// of 256 columns at C = 256 (0.341).
//
// cluster (variant cluster): g on a shared table of one slot (256-512
// rows of 2M = 2048 depth against 64-512 columns): its output is too
// small to fill the card with tiles that each walk all the modes (mma16
// gave 64 blocks of 32 serial stages). Here the modes split over a
// thread-block cluster: every block takes one output tile (16, 32 or 64
// rows by 128 columns) and its share of the stages; twelve producer
// warps stream the stages' table rows and the tile's v and t rows by
// cp.async two stages ahead into a four-stage ring and form the split
// weights in place, eight consumer warps run the mma design's products,
// full and empty mbarriers between them; the partial tiles are summed in rank
// order through distributed shared memory (no atomics: two runs are
// bitwise equal). The cluster is the widest (up to 8) whose clusters all
// run at once (cudaOccupancyMaxActiveClusters: 15 of 8 blocks fit at one
// block an SM on the H100), so the launch is one wave. Bound: the 3xTF32
// operations, 0.0033 ms at 256 objects, C = 512 (14% reached). Measured
// (bench/span_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md): 0.0236 ms
// at C = 512, L = 1 against mma16's 0.048 and one PyTorch call's 0.0227;
// the producers' issue bounds it (four producer warps 0.028, eight
// 0.024: with four, the consumers waited 0.58 us of each 1.76 us stage
// of 16 modes; each copy's source found once: 0.018 -> 0.0157 at C =
// 256, where one PyTorch call takes 0.0167). Tried and dropped: the loop split over a cluster as it
// was (0.033), a ring of every copy without producer warps (0.044: the
// copies' issue, ~0.7 us a stage, serial with the products), a producer
// lead of 3 and a ring of 2 stages at 2 blocks an SM.
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the first error is returned as a cudaError_t.

#include <cooperative_groups.h>
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

// ------------------------------------------------------------------ split

namespace sp {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 4;         // m16 tiles of columns a block
constexpr int kBC = 16 * kMT;  // columns a block
constexpr int kSM = 32;        // modes a stage: a step of 16 a depth half
constexpr int kStages = 4;
constexpr int kRestart = 4;    // stages between restarts (16 k8 steps)
constexpr int kLdR = 16 + 4;   // the reduction's rows
constexpr int kMaxRows = 32;

struct Args {
  const float *t_re, *t_im;   // [O, L, M]; t_im null: real rows
  const float *v_re, *v_im;   // [O, R, M]
  const float *b_re, *b_im;   // [Og, C+1, M]
  long long tbl_stride;       // floats between objects' tables (0: shared)
  const float* add;           // [O, L, R, C] or null
  float* out;                 // [O, L, R, C]
  int L, R, C, M, off, c_tiles;
  int stage;                  // floats a stage
};

// rows of kSM floats (a stage's table, v and t rows; the weight planes):
// the 16-byte chunk c of row r sits at chunk c ^ 4 (r & 1), so the eight
// lanes of a phase, rows gid and gid + 1 at one chunk, read both halves'
// banks
__device__ __forceinline__ int swz(int row, int col) {
  return row * kSM + (col ^ ((row & 1) << 4));
}

// a stage's rows: the table's kBC rows (re, then im), v's R rows (re,
// im), t's L rows (re, and im for complex rows)
__device__ __forceinline__ int stage_rows(const Args& a) {
  return 2 * kBC + 2 * a.R + (a.t_im != nullptr ? 2 : 1) * a.L;
}

// the first mode of a stage's row ``row`` in device memory
__device__ __forceinline__ const float* row_source(const Args& a,
                                                   const float* tb_re,
                                                   const float* tb_im, int o,
                                                   int c0, int row) {
  int r = row;
  if (r < 2 * kBC) {   // the table: column c0 + r (mod kBC), clamped
    const bool im = r >= kBC;
    r -= im ? kBC : 0;
    return (im ? tb_im : tb_re) +
           (long long)(a.off + min(c0 + r, a.C - 1)) * a.M;
  }
  if ((r -= 2 * kBC) < 2 * a.R) {
    const bool im = r >= a.R;
    r -= im ? a.R : 0;
    return (im ? a.v_im : a.v_re) + ((long long)o * a.R + r) * a.M;
  }
  r -= 2 * a.R;
  const bool im = r >= a.L;
  r -= im ? a.L : 0;
  return (im ? a.t_im : a.t_re) + ((long long)o * a.L + r) * a.M;
}

// A thread's 16-byte copies of every stage (4 | M, rows 16-byte aligned),
// their sources and places found once: a stage's copies are then an add
// and a compare each (at most 2 kBC + 66 rows of kSM / 4 copies)
constexpr int kPlan = (2 * kBC + 2 * (kMaxRows + 1)) * (kSM / 4) / kThreads + 1;

struct CopyPlan {
  const float* src[kPlan];
  int dst[kPlan];
  int lim[kPlan];   // the copy holds modes while m0 < lim

  __device__ __forceinline__ CopyPlan(const Args& a, const float* tb_re,
                                      const float* tb_im, int o, int c0) {
    const int n = stage_rows(a) * (kSM / 4);
#pragma unroll
    for (int i = 0; i < kPlan; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int row = v / (kSM / 4), col = 4 * (v - row * (kSM / 4));
      src[i] = v < n ? row_source(a, tb_re, tb_im, o, c0, row) + col : a.b_re;
      dst[i] = swz(row, col);
      lim[i] = v < n ? a.M - col : -1;   // -1: no copy
    }
  }

  __device__ __forceinline__ void load(float* st, int s) const {
    const int m0 = s * kSM;
#pragma unroll
    for (int i = 0; i < kPlan; ++i) {
      if (lim[i] < 0) break;
      const bool ok = m0 < lim[i];
      copy_async<16>(st + dst[i], ok ? src[i] + m0 : src[i], ok ? 16 : 0);
    }
  }
};

// stage s's rows, modes s kSM .. s kSM + kSM - 1 (zero past M), one float
// a copy (rows not on 16 bytes, or M not a multiple of 4)
__device__ __forceinline__ void load_stage_scalar(const Args& a, float* st,
                                                  const float* tb_re,
                                                  const float* tb_im, int o,
                                                  int c0, int s) {
  const int m0 = s * kSM;
  const int rows = stage_rows(a);
  for (int v = threadIdx.x; v < rows * kSM; v += kThreads) {
    const int row = v / kSM, col = v - row * kSM;
    const float* src = row_source(a, tb_re, tb_im, o, c0, row);
    const bool ok = m0 + col < a.M;
    copy_async<4>(st + swz(row, col), ok ? src + m0 + col : src, ok ? 4 : 0);
  }
}

// the weights of a stage's kNT 8 rows n = (l, r) (zero past L R) from its
// v and t rows, in the twin's rounding order, split by rounding into the
// planes w [4][kNT 8][kSM]: w_pr hi, lo, w_pi hi, lo
template <int kNT>
__device__ __forceinline__ void form_weights(const Args& a, const float* st,
                                             float* w) {
  const float* vs = st + 2 * kBC * kSM;
  const float* ts = vs + 2 * a.R * kSM;
  const bool cplx = a.t_im != nullptr;
  const int rows = a.L * a.R;
  for (int v = threadIdx.x; v < kNT * 8 * (kSM / 4); v += kThreads) {
    const int n = v / (kSM / 4), col = 4 * (v - n * (kSM / 4));
    float pr[4] = {0.f, 0.f, 0.f, 0.f}, pi[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < rows) {
      const int l = n / a.R, r = n - l * a.R;
      const float4 vr = *reinterpret_cast<const float4*>(vs + swz(r, col));
      const float4 vi =
          *reinterpret_cast<const float4*>(vs + swz(a.R + r, col));
      const float4 tr = *reinterpret_cast<const float4*>(ts + swz(l, col));
      const float4 ti =
          cplx ? *reinterpret_cast<const float4*>(ts + swz(a.L + l, col))
               : make_float4(0.f, 0.f, 0.f, 0.f);
      weights(tr.x, ti.x, vr.x, vi.x, cplx, pr[0], pi[0]);
      weights(tr.y, ti.y, vr.y, vi.y, cplx, pr[1], pi[1]);
      weights(tr.z, ti.z, vr.z, vi.z, cplx, pr[2], pi[2]);
      weights(tr.w, ti.w, vr.w, vi.w, cplx, pr[3], pi[3]);
    }
    float4 hi, lo;
    split4(pr, hi, lo);
    *reinterpret_cast<float4*>(w + swz(n, col)) = hi;
    *reinterpret_cast<float4*>(w + kNT * 8 * kSM + swz(n, col)) = lo;
    split4(pi, hi, lo);
    *reinterpret_cast<float4*>(w + 2 * kNT * 8 * kSM + swz(n, col)) = hi;
    *reinterpret_cast<float4*>(w + 3 * kNT * 8 * kSM + swz(n, col)) = lo;
  }
}

// The transposed product out^T[c, n] = sum_m B[off+c, m] w[n, m] of one
// object: the table's rows are A (kBC columns c a block), the L R weight
// rows w are B (kNT n8 tiles), the modes the depth. The table, v and t
// rows of kSM modes at a time stream through a ring of kStages stages by
// cp.async (the table read once, at the card's bandwidth); the block forms
// each stage's weights once, split, into one of two weight buffers a
// stage ahead of the products, so one barrier a stage suffices. Warp w
// takes the m16 tile w % kMT of the columns and the depth half w / kMT of
// each stage; the table is split by truncation in registers. The depth is
// permuted inside a step of 16 modes: lane (gid, tig) holds modes 4 tig ..
// 4 tig + 3 of its rows, k8 step s reads the pair 2s, 2s + 1 as logical k
// = tig and tig + 4, in A and B alike, so each lane's 16-byte shared
// loads are its fragments. The two depth halves are summed through shared
// memory in a fixed order.
template <int kNT, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
    span_reduce_split(const Args a) {
  constexpr int kW = 4 * kNT * 8 * kSM;   // floats of a weight buffer
  extern __shared__ __align__(16) float smem[];   // ring, then 2 weights
  float* wbuf = smem + kStages * a.stage;
  const int ct = blockIdx.x % a.c_tiles, o = blockIdx.x / a.c_tiles;
  const int c0 = ct * kBC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp % kMT, hh = warp / kMT;
  const int rows = a.L * a.R;
  const float* tb_re = a.b_re + (long long)o * a.tbl_stride;
  const float* tb_im = a.b_im + (long long)o * a.tbl_stride;
  const int col = 16 * hh + 4 * tig;   // this lane's modes in a stage

  float acc[kNT][4], part[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = part[j][q] = 0.f;

  // the ring: stages s + 1 and s + 2 in flight while stage s is
  // multiplied; its slot's last reader is stage s - 1
  const int stages = (a.M + kSM - 1) / kSM;
  const CopyPlan plan(a, tb_re, tb_im, o, c0);
  auto load_stage = [&](int s) {
    float* st = smem + s % kStages * a.stage;
    if (kVec == 4)
      plan.load(st, s);
    else
      load_stage_scalar(a, st, tb_re, tb_im, o, c0, s);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load_stage(s);
    copy_commit();
  }
  copy_wait<kStages - 2>();
  __syncthreads();   // stage 0 has landed
  form_weights<kNT>(a, smem, wbuf);
  for (int s = 0; s < stages; ++s) {
    copy_wait<kStages - 3>();
    // stage s + 1 has landed, stage s's weights are formed, and every
    // warp is done with stage s - 1
    __syncthreads();
    if (s + kStages - 1 < stages)   // into the slot stage s - 1 left
      load_stage(s + kStages - 1);
    copy_commit();
    const float* st = smem + s % kStages * a.stage;
    const float* w = wbuf + (s & 1) * kW;
    if (s % kRestart == 0) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
    }
    // A: the table rows 16 mt + gid (+8), re and im, split by truncation;
    // register q: row gid (+8 for odd q), element 2k (+1 for q >= 2)
    AFrag are[2], aim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + 8 * h + gid;
      const float4 re = *reinterpret_cast<const float4*>(st + swz(row, col));
      const float4 im =
          *reinterpret_cast<const float4*>(st + swz(kBC + row, col));
      split_trunc(__float_as_uint(re.x), are[0].hi[h], are[0].lo[h]);
      split_trunc(__float_as_uint(re.y), are[0].hi[h + 2], are[0].lo[h + 2]);
      split_trunc(__float_as_uint(re.z), are[1].hi[h], are[1].lo[h]);
      split_trunc(__float_as_uint(re.w), are[1].hi[h + 2], are[1].lo[h + 2]);
      split_trunc(__float_as_uint(im.x), aim[0].hi[h], aim[0].lo[h]);
      split_trunc(__float_as_uint(im.y), aim[0].hi[h + 2], aim[0].lo[h + 2]);
      split_trunc(__float_as_uint(im.z), aim[1].hi[h], aim[1].lo[h]);
      split_trunc(__float_as_uint(im.w), aim[1].hi[h + 2], aim[1].lo[h + 2]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (8 * j >= rows) break;
      // B: the split weights of row 8 j + gid at the four modes; k8 step
      // k takes elements 2k, 2k + 1 (b0, b1)
      const int at = swz(8 * j + gid, col);
      const uint4 prh = *reinterpret_cast<const uint4*>(w + at);
      const uint4 prl = *reinterpret_cast<const uint4*>(w + kNT * 8 * kSM + at);
      const uint4 pih =
          *reinterpret_cast<const uint4*>(w + 2 * kNT * 8 * kSM + at);
      const uint4 pil =
          *reinterpret_cast<const uint4*>(w + 3 * kNT * 8 * kSM + at);
      mma3<false>(part[j], are[0], prh.x, prh.y, prl.x, prl.y);
      mma3<false>(part[j], aim[0], pih.x, pih.y, pil.x, pil.y);
      mma3<false>(part[j], are[1], prh.z, prh.w, prl.z, prl.w);
      mma3<false>(part[j], aim[1], pih.z, pih.w, pil.z, pil.w);
    }
    if ((s + 1) % kRestart == 0 || s + 1 == stages) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
    }
    if (s + 1 < stages)   // the next stage's weights, into the other buffer
      form_weights<kNT>(a, smem + (s + 1) % kStages * a.stage,
                        wbuf + ((s + 1) & 1) * kW);
  }
  copy_wait<0>();
  __syncthreads();   // every warp is done with the ring

  // accumulator q of tile j: column 16 mt + gid (+8 for q >= 2), row 8 j
  // + 2 tig (+1 for odd q); the two depth halves summed in order
  float* red = smem;   // [kWarps][kNT 8][kLdR], over the ring
  float* mine = red + warp * (kNT * 8) * kLdR;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mine[(8 * j + 2 * tig + (q & 1)) * kLdR + gid + 8 * (q >> 1)] =
          acc[j][q];
  __syncthreads();
  for (int v = threadIdx.x; v < rows * kBC; v += kThreads) {
    const int n = v / kBC, c = v - n * kBC;
    if (c0 + c >= a.C) continue;
    const int at_red = n * kLdR + c % 16;
    const float sum = red[(c / 16) * (kNT * 8) * kLdR + at_red] +
                      red[(c / 16 + kMT) * (kNT * 8) * kLdR + at_red];
    const int l = n / a.R, r = n - l * a.R;
    const long long at =
        (((long long)o * a.L + l) * a.R + r) * a.C + c0 + c;
    a.out[at] = a.add ? sum + a.add[at] : sum;
  }
}

long long blocks(int O, int C) {
  return (long long)O * ((C + kBC - 1) / kBC);
}

template <int kNT, int kVec>
int launch_rows(const Args& a, int O, void* stream) {
  auto kernel = span_reduce_split<kNT, kVec>;
  const int smem =
      (kStages * a.stage + 2 * 4 * kNT * 8 * kSM) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)O * a.c_tiles), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <int kVec>
int launch_vec(const Args& a, int O, void* stream) {
  const int rows = a.L * a.R;
  if (rows <= 8) return launch_rows<1, kVec>(a, O, stream);
  if (rows <= 16) return launch_rows<2, kVec>(a, O, stream);
  if (rows <= 24) return launch_rows<3, kVec>(a, O, stream);
  return launch_rows<4, kVec>(a, O, stream);
}

// L R <= kMaxRows rows an object
int launch(const float* t_re, const float* t_im, const float* v_re,
           const float* v_im, const float* b_re, const float* b_im,
           long long tbl_stride, const float* add, float* out, int O, int L,
           int R, int C, int M, int off, int vec4, void* stream) {
  if (L * R > kMaxRows) return (int)cudaErrorInvalidValue;
  const int cplx = t_im != nullptr;
  // a stage's rows (table, v, t) of kSM floats; the reduction fits in it
  const int stage = (2 * kBC + 2 * R + (1 + cplx) * L) * kSM;
  const Args a{t_re, t_im, v_re, v_im, b_re, b_im, tbl_stride, add, out,
               L, R, C, M, off, (C + kBC - 1) / kBC, stage};
  return vec4 ? launch_vec<4>(a, O, stream) : launch_vec<1>(a, O, stream);
}

}  // namespace sp


// ---------------------------------------------------------------- cluster

namespace cl {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kWant = 128;       // blocks that fill the card, one an SM
constexpr int kStages = 4;       // ring stages
constexpr int kLead = 2;         // stages the copies run ahead of the weights
constexpr int kProd = 384;       // producer threads (twelve warps)
constexpr int kBlock = kThreads + kProd;
constexpr int kLdP = kBN + 4;    // the partial tile's rows (floats)
constexpr int kMaxDevices = 64;

// a stage of the ring, in floats: the table's rows [2][kBN][kLd] (re,
// im), then the tile's rows of v_re, v_im, t_re, t_im [4][kBM][kLd],
// which the producers turn into the weight planes in place (w_pr hi, lo,
// w_pi hi, lo); then the tile rows' sources
template <int kWM, int kMT>
struct Ring {
  using T = Tile<kWM, kMT>;
  static constexpr int kTbl = 2 * kBN * T::kLd;
  static constexpr int kStage = kTbl + 4 * T::kBM * T::kLd;
  static constexpr int kRows = kStages * kStage;   // [4][kBM] long longs
  static constexpr int kSmemBytes =
      kRows * (int)sizeof(float) + 4 * T::kBM * 8 + 16 * kStages;
  static_assert(T::kBM * kLdP <= kRows, "the partial tile fits");
};

template <int kWM, int kMT, int kVec>
__global__ void __launch_bounds__(kBlock, 1)
    span_reduce_cluster(const Args a);

// one device's largest clusters of 1 .. kMaxCluster blocks of a tile's
// kernel that run at once, asked of the runtime once
template <int kWM, int kMT, int kVec>
int max_clusters(int q) {
  static int found[kMaxDevices][kMaxCluster + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (found[dev][q] == 0) {
    using R = Ring<kWM, kMT>;
    auto kernel = span_reduce_cluster<kWM, kMT, kVec>;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             R::kSmemBytes) != cudaSuccess)
      return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(q * kWant, 1, 1);
    cfg.blockDim = dim3(kBlock, 1, 1);
    cfg.dynamicSmemBytes = R::kSmemBytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = q;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
      return 0;
    found[dev][q] = n > 0 ? n : -1;
  }
  return found[dev][q];
}

// a launch's tile rows (64, 32 or 16: Tile<2, 2>, <2, 1>, <1, 1>) and its
// cluster size q: the widest tile whose tiles, times the largest cluster,
// reach kWant blocks; then the largest q whose clusters, one a tile, all
// run at once (so the launch is one wave), else one block a tile
struct Plan {
  int bm, q;
  long long tiles;   // output tiles: groups x row tiles x column tiles
  Plan(long long rows, long long groups, int C, int vec4) {
    const long long c_tiles = (C + kBN - 1) / kBN;
    auto count = [&](int b) {
      return groups * ((rows + b - 1) / b) * c_tiles;
    };
    bm = count(64) * kMaxCluster >= kWant   ? 64
         : count(32) * kMaxCluster >= kWant ? 32
                                            : 16;
    tiles = count(bm);
    for (q = kMaxCluster; q > 1; --q)
      if (tiles <= fits(q, vec4)) break;
  }
  int fits(int q, int vec4) const {
    if (bm == 64)
      return vec4 ? max_clusters<2, 2, 4>(q) : max_clusters<2, 2, 1>(q);
    if (bm == 32)
      return vec4 ? max_clusters<2, 1, 4>(q) : max_clusters<2, 1, 1>(q);
    return vec4 ? max_clusters<1, 1, 4>(q) : max_clusters<1, 1, 1>(q);
  }
};

// A producer thread's 16-byte copies of every stage, their sources and
// places found once: a stage's copy is then an add and a compare
template <int kN>
struct Copies {
  const float* src[kN];
  int dst[kN];
  int lim[kN];   // the copy holds modes while m0 < lim; -1: no copy

  __device__ __forceinline__ void issue(float* st, int m0) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (lim[i] < 0) break;
      const bool ok = m0 < lim[i];
      copy_async<16>(st + dst[i], ok ? src[i] + m0 : src[i], ok ? 16 : 0);
    }
  }
};

// One block of a cluster of q: one output tile's rank-th share of the
// modes' stages, warp-specialised. Twelve producer warps stream each stage's
// table rows and the tile's v and t rows into a ring of kStages stages by
// cp.async, kLead stages ahead, and, once a stage has landed, turn its v
// and t rows in place
// into the four split weight planes (the twin's rounding order), then
// arrive on the stage's full barrier; eight consumer warps wait on it, run
// the mma design's products (the table split in registers) and arrive on
// its empty barrier. No block-wide barrier stands between the copies and
// the products, so the copies, which the SM's rate from L2 bounds, run
// under the tensor cores' work. Then the consumers' partial tile goes into
// shared memory; after a cluster barrier, block rank sums rows rank kBM /
// q .. of the tile over the cluster's blocks in rank order through
// distributed shared memory and writes them, adding ``add``.
template <int kWM, int kMT, int kVec>
__global__ void __launch_bounds__(kBlock, 1)
    span_reduce_cluster(const Args a) {
  using T = Tile<kWM, kMT>;
  using R = Ring<kWM, kMT>;
  constexpr int kNT = T::kNT, kBK = T::kBK, kLd = T::kLd;
  extern __shared__ __align__(16) float smem[];
  long long* src = reinterpret_cast<long long*>(smem + R::kRows);
  const uint32_t bars = smem_addr(src + 4 * T::kBM);
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (kStages + i); };
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int bid = blockIdx.x / q;
  const int ct = bid % a.c_tiles;
  bid /= a.c_tiles;
  const int rt = bid % a.r_tiles;
  const int grp = bid / a.r_tiles;
  const int r0 = rt * T::kBM, c0 = ct * kBN;   // r0: within the group
  const int row0 = grp * a.rows + r0;          // flat (o, l, r): < 2^31
  const long long og = (long long)grp * a.tbl_stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool cplx = a.t_im != nullptr;

  // this block's stages s0 .. s0+n-1 (none when q exceeds the stages)
  const int stages = (a.M + kBK - 1) / kBK;
  const int per = (stages + q - 1) / q;
  const int s0 = min(stages, rank * per), n = min(stages, s0 + per) - s0;

  // the tile rows' first elements: v_re, v_im, t_re, t_im (-1: past the
  // group's rows, zero)
  for (int v = tid; v < 4 * T::kBM; v += kBlock) {
    const int arr = v / T::kBM, r = v - arr * T::kBM;
    long long at = -1;
    if (r0 + r < a.rows) {
      const int row = row0 + r, lr = a.L * a.R;
      const int o = row / lr, ol = row - o * lr, l = ol / a.R;
      at = arr < 2 ? ((long long)o * a.R + (ol - l * a.R)) * a.M
                   : ((long long)o * a.L + l) * a.M;
    }
    src[v] = at;
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full(i), kProd);
      hopper::mbar_init(empty(i), kWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (tid >= kThreads) {   // the producers
    const int p = tid - kThreads;
    constexpr int kPerRow = kBK / kVec;
    // 16-byte copies: each one's source and place found once (measured
    // 13-16% faster at C <= 256 than finding them every stage)
    constexpr int kTblN = (2 * kBN * kPerRow + kProd - 1) / kProd;
    constexpr int kRawN = (4 * T::kBM * kPerRow + kProd - 1) / kProd;
    Copies<kVec == 4 ? kTblN : 1> tbl_copies;
    Copies<kVec == 4 ? kRawN : 1> raw_copies;
    if constexpr (kVec == 4) {
#pragma unroll
      for (int i = 0; i < kTblN; ++i) {
        const int v = p + i * kProd;
        const int part = v / (kBN * kPerRow);
        const int rem = v - part * kBN * kPerRow;
        const int c = rem / kPerRow, j = (rem - c * kPerRow) * 4;
        const bool in = v < 2 * kBN * kPerRow, ok = in && c0 + c < a.C;
        tbl_copies.src[i] = ok ? (part ? a.b_im : a.b_re) + og +
                                     (long long)(a.off + c0 + c) * a.M + j
                               : a.b_re;
        tbl_copies.dst[i] = (part * kBN + c) * kLd + j;
        tbl_copies.lim[i] = in ? (ok ? a.M - j : 0) : -1;
      }
#pragma unroll
      for (int i = 0; i < kRawN; ++i) {
        const int v = p + i * kProd;
        const int row = v / kPerRow, j = (v - row * kPerRow) * 4;
        const bool in = v < (cplx ? 4 : 3) * T::kBM * kPerRow;
        const long long at = in ? src[row] : -1;
        const int arr = row / T::kBM;
        const float* base = arr == 0   ? a.v_re
                            : arr == 1 ? a.v_im
                            : arr == 2 ? a.t_re
                                       : a.t_im;
        raw_copies.src[i] = at >= 0 ? base + at + j : a.v_re;
        raw_copies.dst[i] = R::kTbl + row * kLd + j;
        raw_copies.lim[i] = in ? (at >= 0 ? a.M - j : 0) : -1;
      }
    }
    for (int s = 0; s < n + kLead; ++s) {
      if (s < n) {
        const int slot = s % kStages;
        if (s >= kStages)   // the consumers are done with its last use
          hopper::mbar_wait(empty(slot), (s / kStages - 1) & 1);
        float* st = smem + slot * R::kStage;
        const int m0 = (s0 + s) * kBK;
        if constexpr (kVec == 4) {
          tbl_copies.issue(st, m0);
          raw_copies.issue(st, m0);
        } else {
          for (int v = p; v < 2 * kBN * kPerRow; v += kProd) {
            const int part = v / (kBN * kPerRow);
            const int rem = v - part * kBN * kPerRow;
            const int c = rem / kPerRow, j = (rem - c * kPerRow) * kVec;
            const float* tbl = part ? a.b_im : a.b_re;
            const bool ok = c0 + c < a.C && m0 + j < a.M;
            copy_async<4 * kVec>(
                st + (part * kBN + c) * kLd + j,
                ok ? tbl + og + (long long)(a.off + c0 + c) * a.M + m0 + j
                   : tbl,
                ok ? 4 * kVec : 0);
          }
          float* raw = st + R::kTbl;
          for (int v = p; v < (cplx ? 4 : 3) * T::kBM * kPerRow; v += kProd) {
            const int row = v / kPerRow, j = (v - row * kPerRow) * kVec;
            const long long at = src[row];
            const bool ok = at >= 0 && m0 + j < a.M;
            const int arr = row / T::kBM;
            const float* base = arr == 0   ? a.v_re
                                : arr == 1 ? a.v_im
                                : arr == 2 ? a.t_re
                                           : a.t_im;
            copy_async<4 * kVec>(raw + row * kLd + j,
                                 ok ? base + at + m0 + j : a.v_re,
                                 ok ? 4 * kVec : 0);
          }
        }
      }
      copy_commit();
      if (s < kLead) continue;
      copy_wait<kLead>();   // this thread's copies of stage s - kLead
      asm volatile("bar.sync 1, %0;\n" ::"n"(kProd) : "memory");
      const int slot = (s - kLead) % kStages;
      float* w = smem + slot * R::kStage + R::kTbl;
      for (int v = p; v < T::kBM * (kBK / 4); v += kProd) {
        const int qr = v / (kBK / 4), qc = 4 * (v - qr * (kBK / 4));
        const float* at = w + qr * kLd + qc;
        Quad qd;
        qd.vr = *reinterpret_cast<const float4*>(at);
        qd.vi = *reinterpret_cast<const float4*>(at + T::kBM * kLd);
        qd.tr = *reinterpret_cast<const float4*>(at + 2 * T::kBM * kLd);
        qd.ti = cplx ? *reinterpret_cast<const float4*>(at + 3 * T::kBM * kLd)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        store_weights<T::kBM, kLd>(w, qr, qc, qd, cplx);
      }
      hopper::mbar_arrive(full(slot));
    }
  } else {   // the consumers
    const int wm = warp / T::kWN, wn = warp % T::kWN;
    float part[kMT][kNT][4];
    for (int i = 0; i < n; ++i) {
      const int slot = i % kStages;
      hopper::mbar_wait(full(slot), (i / kStages) & 1);
      const float* st = smem + slot * R::kStage;
      products<kWM, kMT>(part, st + R::kTbl, st, wm, wn, lane);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(slot));
    }
  }
  __syncthreads();   // every stage is consumed; the ring is free

  // the partial tile [kBM][kLdP] over the ring: accumulator i of tile (mt,
  // nt) is row gid (+8 for i >= 2), column 2 tig (+1 for odd i)
  float* mine = smem;
  if (tid < kThreads) {
    const int wm = warp / T::kWN, wn = warp % T::kWN;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = wm * kMT * 16 + mt * 16 + gid + 8 * h;
          const int cc = wn * kNT * 8 + nt * 8 + 2 * tig;
          *reinterpret_cast<float2*>(mine + rr * kLdP + cc) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
  }
  cluster.sync();   // every block's partial tile is in its shared memory
  const int first = rank * T::kBM / q, last = (rank + 1) * T::kBM / q;
  for (int v = tid; v < (last - first) * (kBN / 4); v += kBlock) {
    const int rr = first + v / (kBN / 4), cc = 4 * (v % (kBN / 4));
    // every rank's partial loaded first, then summed in rank order
    float4 pt[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < q)
        pt[j] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(mine, j) + rr * kLdP + cc);
    float4 sum = pt[0];
#pragma unroll
    for (int j = 1; j < kMaxCluster; ++j) {
      if (j < q) {
        sum.x += pt[j].x;
        sum.y += pt[j].y;
        sum.z += pt[j].z;
        sum.w += pt[j].w;
      }
    }
    if (r0 + rr >= a.rows) continue;
    const long long at = ((long long)row0 + rr) * a.C + c0 + cc;
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + cc + e < a.C)
        a.out[at + e] = a.add ? vals[e] + a.add[at + e] : vals[e];
  }
  cluster.sync();   // no block leaves while its partial is still read
}

template <int kWM, int kMT, int kVec>
int launch_tile(const Args& a, const Plan& p, void* stream) {
  using R = Ring<kWM, kMT>;
  auto kernel = span_reduce_cluster<kWM, kMT, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.tiles * p.q), 1, 1);
  cfg.blockDim = dim3(kBlock, 1, 1);
  cfg.dynamicSmemBytes = R::kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int kVec>
int launch_vec(const Args& a, const Plan& p, void* stream) {
  if (p.bm == 64) return launch_tile<2, 2, kVec>(a, p, stream);
  if (p.bm == 32) return launch_tile<2, 1, kVec>(a, p, stream);
  return launch_tile<1, 1, kVec>(a, p, stream);
}

long long blocks(int O, int L, int R, int C, long long tbl_stride) {
  long long rows, groups;
  row_groups(O, L, R, tbl_stride, rows, groups);
  const Plan p(rows, groups, C, 1);
  return p.tiles * p.q;
}

int launch(const float* t_re, const float* t_im, const float* v_re,
           const float* v_im, const float* b_re, const float* b_im,
           long long tbl_stride, const float* add, float* out, int O, int L,
           int R, int C, int M, int off, int vec4, void* stream) {
  long long rows, groups;
  row_groups(O, L, R, tbl_stride, rows, groups);
  const Plan p(rows, groups, C, vec4);
  const Args a{t_re, t_im, v_re, v_im, b_re, b_im, tbl_stride, add, out,
               L, R, C, M, off, (int)rows,
               (int)((rows + p.bm - 1) / p.bm), (C + kBN - 1) / kBN, 0};
  return vec4 ? launch_vec<4>(a, p, stream) : launch_vec<1>(a, p, stream);
}

}  // namespace cl


extern "C" {

// The variants (ops/span_reduce.py::VARIANTS): 0 mma16, 1 mma64 (the
// cp.async and mma.sync design at 16 or 64 rows a block), 2 wgmma (the
// TMA and wgmma pipeline), 3 fp32 (the streaming design on the
// CUDA cores, L R <= 4 rows an object), 4 split (an object's table rows
// as A, the modes split over warps; L R <= 32 rows an object), 5 cluster
// (the mma design's tiles with the modes split over a thread-block
// cluster, reduced through distributed shared memory).

// Blocks of one launch of ``variant`` (the wrapper checks them against
// the grid limit).
long long span_reduce_blocks(int O, int L, int R, int C,
                             long long tbl_stride, int variant) {
  if (variant == 2)
    return wg::blocks(O, L, R, C, tbl_stride == 0, wg::Cfg::kBM);
  if (variant == 3) return fp32::blocks(O, C);
  if (variant == 4) return sp::blocks(O, C);
  if (variant == 5) return cl::blocks(O, L, R, C, tbl_stride);
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
  if (variant == 4)
    return sp::launch(t_re, t_im, v_re, v_im, b_re, b_im, tbl_stride, add,
                      out, O, L, R, C, M, off, vec4, stream);
  if (variant == 5)
    return cl::launch(t_re, t_im, v_re, v_im, b_re, b_im, tbl_stride, add,
                      out, O, L, R, C, M, off, vec4, stream);
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
