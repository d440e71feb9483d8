// Fused per-block modal step for heterogeneous banks, Hopper (sm_90a).
//
// Replaces openpbso_tpu/ops/pallas_integrator.py::_fused_kernel together
// with the XLA within-chunk Toeplitz convolution of its wrapper
// (step_block_pallas). For one S-sample block of every (object, mode)
// oscillator, with beff = b*space and t = transfer*mask, in K = S/C chunks
// of C samples, P_d = lam^d:
//
//   inj_k,m  = sum_d P_d,m f[kC + C-1-d]                d in [0, C)
//   z_k+1    = P_C z_k + beff inj_k
//   hom_k[c] = sum_m Re P_c+1,m t Im z_k,m + Im P_c+1,m t Re z_k,m
//   G[c]     = sum_m Re P_c,m t Im beff_m + Im P_c,m t Re beff_m
//   sound    = hom + G (*) f                           within each chunk
//
// Bound: memory, on the chunk tables lam^0..lam^C ([Og, C+1, M], re and
// im): at 256 objects x 1024 modes and C = 64 a heterogeneous bank reads
// ~136 MB of tables per block, ~41 us at the data sheet's 3.35 TB/s. The
// two mode contractions (the injections and hom) are ~2 (K+1) C + 2 K C
// multiply-adds per mode: ~0.29 ms on the CUDA cores' FP32 at 67 TFLOP/s,
// ~11 us as three TF32 products at the 321.7 TFLOP/s that mma.sync reaches
// on the card (bench/mma_rate.py), so on the tensor cores the kernel can
// be byte-bound. Those are reckonings (bench/roofline.py), not
// measurements.
//
// Precision: both contractions run as mma.sync m16n8k8 TF32 with the
// 3xTF32 split of csrc/tf32x3.cuh: every operand split by rounding in
// registers, each k8 step's three products started from zero and added to
// float32 registers with rounding to nearest. An emulation of these
// products (tests/test_torch_fused.py) reads -136 dB against float64;
// splits by truncation with eight-step chains read -112 dB there (the sums
// over modes amplify the products' error). Admitted by the measured error
// against the FP32 twin (<= -110 dB, chip_smoke.py, tests/test_torch_gpu.py).
// The chunk recurrence, G and the within-chunk convolution stay in FP32 on
// the CUDA cores.
//
// Design: a block of eight warps takes a tile of tm modes of one object at
// a time. The T = M/tm tiles of an object are shared by a thread-block
// cluster of Q blocks, block r walking tiles r, r + Q, ...; Q is as small
// as still gives every SM a block (Q = 1 from 132 objects up on an H100:
// one block per object walks all its tiles, two blocks per SM).
//   - Tables arrive by bulk asynchronous copy (cp.async.bulk) in kStages
//     stages of rows, each stage with its own mbarrier. The wrapper keeps
//     the tables tile-major, [Og, T, C+1, tm + 4] with the row pad zero
//     (ops/fused_integrator.py::_kernel_tables), so that a stage of one
//     table is one contiguous copy into rows 4 (mod 32) words apart: two
//     copies a stage. The next tile's mode rows are loaded into registers
//     once hom is done, and its copies issued once the block is done with
//     this tile (issued while it still summed the tile's partials, they
//     measured up to 8% slower).
//   - Injection: inj[m, k] = sum_d P[d, m] frev[d, k], A = the table tile
//     transposed (16 modes x 8 powers, scalar loads), B = the reversed
//     profile chunks (8 powers x 8 chunks: the chunk index is n8). Within a
//     k8 step, k index q reads power 2q (q < 4) or 2(q-4)+1 of the step, so
//     that with rows 4 (mod 32) words apart the A loads are conflict-free.
//     A warp starts on the first stage while the rest lands.
//   - The serial recurrence runs on the CUDA cores, one lane per mode, K
//     complex multiply-adds from the injections in shared memory; it leaves
//     the weights t Im z_k, t Re z_k of every chunk in shared memory. G,
//     one row against the unshifted rows, runs meanwhile on the other
//     threads, on the CUDA cores (C x tm multiply-adds a tile).
//   - hom: [16 rows c] x [8 modes] A fragments by ldmatrix from table rows
//     c+1 (conflict-free at the same pad), B = the weights (8 modes x 8
//     chunks); the modes are split over warps and the partials added in a
//     fixed order.
//   - One launch, no scratch in device memory: each block sums its tiles'
//     [K+1, C] in shared memory; after a cluster barrier, block r sums its
//     share of the outputs over the cluster's blocks in rank order through
//     distributed shared memory, adds the within-chunk Toeplitz term (a few
//     lanes per output, reduced by shuffles) and writes the sound; a second
//     cluster barrier keeps every block until its sum is read. Fixed orders
//     everywhere and no atomics, so two runs are bitwise equal.
//
// Measured (bench/fused_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// builds with one phase left out showed the phases' times add (copies,
// injections, recurrence and G, hom, the sums): a block runs them one after
// another, each latency-bound, so what counts is how many blocks an SM
// interleaves. Clusters of 8 blocks, one per tile, ran as slow as the v4b
// kernel this replaces; one block per object with the next tile's tables
// double-buffered (one block per SM) 1.1x faster; one block per object
// with one buffer, two blocks per SM, 1.5x (0.090 against 0.136 ms at
// 256 x 1024 hetero).
//
// Plain C interface (loaded with ctypes); the launch goes on the stream
// passed in, and the first error is returned as a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

using tf32x3::AFrag;
using tf32x3::load_a;
using tf32x3::mma3;
using tf32x3::smem_addr;
using tf32x3::split_tf32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;        // table row stages, one mbarrier each
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kPad = 4;           // table row pad: rows 4 (mod 32) words apart
constexpr int kQuarters = 4;      // mode quarters of the G row
constexpr int kMaxSmem = 232448 - 1024;   // dynamic shared memory, sm_90
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) {
  return cdiv(a, b) * b;
}

// sizes derived from (tm, S, C)
struct Shape {
  int tm, S, C, K, nt, kw, c8, ct, rows, ld, stage_rows, stages, parts;
  __host__ __device__ Shape(int tm_, int S_, int C_) {
    tm = tm_;
    S = S_;
    C = C_;
    K = S / C;
    nt = cdiv(K, 8);        // n8 tiles of chunks
    kw = 8 * nt;            // chunk columns held per mode
    c8 = cdiv(C, 8);        // injection k8 steps
    ct = cdiv(C, 16);       // hom row tiles
    rows = 16 * ct + 1;     // table rows held: C+1 copied, the rest zero
    ld = tm + kPad;
    stage_rows = round_up(cdiv(C + 1, kStages), 8);
    stages = cdiv(C + 1, stage_rows);
    parts = 1;              // hom: the tile's k8 steps split over warps
    while (parts < tm / 8 && 2 * ct * nt * parts <= kWarps) parts *= 2;
  }
};

// dynamic shared memory, offsets in floats (each a multiple of 4), for
// clusters of Q blocks
struct Layout {
  int tbl, fs, bfr, inj, w, wg, red, gred, part, gsum, rem, rem_ld, total;
  __host__ __device__ Layout(const Shape& s, int Q) {
    tbl = 0;                                        // [2][rows][ld]
    fs = tbl + 2 * s.rows * s.ld;                   // [S] profile
    bfr = fs + round_up(s.S, 4);                    // [nt][c8][32][2]
    inj = bfr + s.nt * s.c8 * 64;                   // [2][tm][kw]
    w = inj + 2 * s.tm * s.kw;                      // [2][tm][kw]
    wg = w + 2 * s.tm * s.kw;                       // [2][tm]
    red = wg + 2 * s.tm;                            // [parts][16 ct][kw]
    gred = red + s.parts * 16 * s.ct * s.kw;        // [kQuarters][C]
    part = gred + round_up(kQuarters * s.C, 4);     // [K+1][C]
    gsum = part + round_up((s.K + 1) * s.C, 4);     // [C]
    rem = gsum + round_up(s.C, 4);                  // [Q][rem_ld]
    rem_ld = s.C + cdiv(s.S, Q);   // a rank's G row and output share
    total = rem + Q * rem_ld;
  }
};

struct Args {
  const float* tbl_re;   // [Og, tiles, C+1, tm + kPad], tile-major
  const float* tbl_im;
  long long tbl_stride;  // floats between objects' tables (0: shared)
  const float *b_re, *b_im, *space, *transfer, *mask, *z_re, *z_im;  // [O, M]
  const float* f;        // [O, S]
  float *z_re_out, *z_im_out, *sound;
  int M, S, C, tm, tiles;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both ends 16-byte aligned) global -> this
// block's shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// the recurrence's inputs of mode m of object o, as loaded (zero past M or
// when !ok): loads only, so that they stay in flight until used
struct ModeRow {
  float b_re, b_im, sp, tr, mk, zr, zi;
};

__device__ __forceinline__ ModeRow mode_row(const Args& a, int o, int m,
                                            bool ok) {
  ModeRow r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (ok && m < a.M) {
    const long long om = (long long)o * a.M + m;
    r = {a.b_re[om], a.b_im[om], a.space[om], a.transfer[om], a.mask[om],
         a.z_re[om], a.z_im[om]};
  }
  return r;
}

// One thread: the copies of one tile's tables into (pr, pi), two
// per stage, each stage's barrier armed with its bytes first.
__device__ void issue_tile(const Args& a, const Shape& sh, float* pr,
                           float* pi, uint64_t* bars, int tile, int o) {
  // earlier reads of this buffer (ordered by a __syncthreads) before the
  // async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const long long base = (long long)o * a.tbl_stride +
                         (long long)tile * (a.C + 1) * sh.ld;
  for (int s = 0; s < sh.stages; ++s) {
    const int r0 = s * sh.stage_rows;
    const uint32_t bytes = 4u * min(sh.stage_rows, a.C + 1 - r0) * sh.ld;
    mbar_expect_tx(bars + s, 2 * bytes);
    bulk_copy(pr + r0 * sh.ld, a.tbl_re + base + r0 * sh.ld, bytes, bars + s);
    bulk_copy(pi + r0 * sh.ld, a.tbl_im + base + r0 * sh.ld, bytes, bars + s);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    fused_block_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  cg::cluster_group cluster = cg::this_cluster();
  const int Q = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int o = blockIdx.y;
  const Shape sh(a.tm, a.S, a.C);
  const Layout lay(sh, Q);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = a.C, K = sh.K, kw = sh.kw, ld = sh.ld;
  const int my_tiles = cdiv(a.tiles - rank, Q);   // tiles rank + i Q

  float* fs = smem + lay.fs;
  float2* bfr = reinterpret_cast<float2*>(smem + lay.bfr);
  float* inj_re = smem + lay.inj;
  float* inj_im = inj_re + a.tm * kw;
  float* wa = smem + lay.w;          // t Im z_k, against Re P
  float* wb = wa + a.tm * kw;        // t Re z_k, against Im P
  float* wga = smem + lay.wg;        // t Im beff, against Re P
  float* wgb = wga + a.tm;           // t Re beff, against Im P
  float* red = smem + lay.red;
  float* gred = smem + lay.gred;
  float* part = smem + lay.part;
  float* gsum = smem + lay.gsum;
  float* pr = smem + lay.tbl;         // the tile's tables, re and im
  float* pi = pr + sh.rows * ld;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the rows past C, which no copy writes, are zero
  for (int i = tid; i < (sh.rows - C - 1) * ld; i += kThreads)
    pr[(C + 1) * ld + i] = pi[(C + 1) * ld + i] = 0.f;
  for (int i = tid; i < a.S; i += kThreads) fs[i] = a.f[(long long)o * a.S + i];
  __syncthreads();   // barriers initialised, the profile in shared memory
  if (tid == 0) issue_tile(a, sh, pr, pi, bars, rank, o);
  // the injection's B fragments: lane (g, t) of k8 step j8, n8 tile nn
  // holds frev[d][k] = f[k C + C-1-d] at k = 8 nn + g, d = 8 j8 + 2 t (+1)
  for (int idx = tid; idx < sh.nt * sh.c8 * 32; idx += kThreads) {
    const int l = idx & 31, j8 = (idx >> 5) % sh.c8, nn = (idx >> 5) / sh.c8;
    const int k = 8 * nn + (l >> 2), d = 8 * j8 + 2 * (l & 3);
    float2 v = make_float2(0.f, 0.f);
    if (k < K && d < C) v.x = fs[k * C + C - 1 - d];
    if (k < K && d + 1 < C) v.y = fs[k * C + C - 2 - d];
    bfr[idx] = v;
  }

  // the first tile's mode rows; each later tile's are loaded while the
  // previous tile finishes
  ModeRow next = mode_row(a, o, rank * a.tm + tid, tid < a.tm);

  for (int i = 0; i < my_tiles; ++i) {
    const int tile = rank + i * Q;
    const uint32_t parity = i & 1;   // the barriers' phase of this tile
    const int m = tile * a.tm + tid;
    const bool live = tid < a.tm && m < a.M;
    const long long om = (long long)o * a.M + m;
    const float be_r = next.b_re * next.sp, be_i = next.b_im * next.sp;
    const float t = next.tr * next.mk;
    float zr = next.zr, zi = next.zi;
    if (tid < a.tm) {
      wga[tid] = t * be_i;
      wgb[tid] = t * be_r;
    }
    __syncthreads();   // B fragments built (first tile), G's weights

    // injections: warp item = (16-mode group, n8 tile)
    int waited = 0;
    const int groups = a.tm / 16;
    for (int item = warp; item < groups * sh.nt; item += kWarps) {
      const int m0 = 16 * (item % groups), nn = item / groups;
      float acc_r[4] = {0.f, 0.f, 0.f, 0.f}, acc_i[4] = {0.f, 0.f, 0.f, 0.f};
      for (int st = 0; st < sh.stages; ++st) {
        for (; waited <= st; ++waited) mbar_wait(bars + waited, parity);
        const int j_end = min(sh.c8, (st + 1) * sh.stage_rows / 8);
#pragma unroll 2
        for (int j8 = st * sh.stage_rows / 8; j8 < j_end; ++j8) {
          const int r0 = (8 * j8 + 2 * tig) * ld + m0 + gid;
          const int offs[4] = {r0, r0 + 8, r0 + ld, r0 + ld + 8};
          AFrag ar, ai;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            split_tf32(__float_as_uint(pr[offs[q]]), ar.hi[q], ar.lo[q]);
            split_tf32(__float_as_uint(pi[offs[q]]), ai.hi[q], ai.lo[q]);
          }
          const float2 bv = bfr[(nn * sh.c8 + j8) * 32 + lane];
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(__float_as_uint(bv.x), bh0, bl0);
          split_tf32(__float_as_uint(bv.y), bh1, bl1);
          float p_r[4], p_i[4];
          mma3<true>(p_r, ar, bh0, bh1, bl0, bl1);
          mma3<true>(p_i, ai, bh0, bh1, bl0, bl1);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc_r[q] += p_r[q];
            acc_i[q] += p_i[q];
          }
        }
      }
      // accumulator q: mode m0 + gid (+8 for q >= 2), chunk 8 nn + 2 tig
      // (+1 for odd q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (m0 + gid + 8 * h) * kw + 8 * nn + 2 * tig;
        *reinterpret_cast<float2*>(inj_re + at) =
            make_float2(acc_r[2 * h], acc_r[2 * h + 1]);
        *reinterpret_cast<float2*>(inj_im + at) =
            make_float2(acc_i[2 * h], acc_i[2 * h + 1]);
      }
    }
    for (; waited < sh.stages; ++waited) mbar_wait(bars + waited, parity);
    __syncthreads();   // injections in shared memory, every row landed

    if (tid < a.tm) {   // the serial recurrence of mode tid
      const float pcr = pr[C * ld + tid], pci = pi[C * ld + tid];
      float* w_a = wa + tid * kw;
      float* w_b = wb + tid * kw;
      for (int k = 0; k < K; ++k) {
        w_a[k] = t * zi;   // hom of chunk k reads its start state
        w_b[k] = t * zr;
        const float s_re = inj_re[tid * kw + k];
        const float s_im = inj_im[tid * kw + k];
        const float nzr = pcr * zr - pci * zi + be_r * s_re - be_i * s_im;
        const float nzi = pci * zr + pcr * zi + be_r * s_im + be_i * s_re;
        zr = nzr;
        zi = nzi;
      }
      for (int k = K; k < kw; ++k) w_a[k] = w_b[k] = 0.f;
      if (live) {
        a.z_re_out[om] = zr;
        a.z_im_out[om] = zi;
      }
    } else {
      // meanwhile the other threads: G on the CUDA cores, quarter q of the
      // modes against rows c
      const int qm = a.tm / kQuarters;
      for (int idx = tid - a.tm; idx < C * kQuarters;
           idx += kThreads - a.tm) {
        const int c = idx % C, q = idx / C;
        const float4* gr =
            reinterpret_cast<const float4*>(pr + c * ld + q * qm);
        const float4* gi =
            reinterpret_cast<const float4*>(pi + c * ld + q * qm);
        const float4* xa = reinterpret_cast<const float4*>(wga + q * qm);
        const float4* xb = reinterpret_cast<const float4*>(wgb + q * qm);
        float acc = 0.f;
        for (int j = 0; j < qm / 4; ++j)
          acc += dot4(gr[j], xa[j]) + dot4(gi[j], xb[j]);
        gred[q * C + c] = acc;
      }
    }
    __syncthreads();   // weights and G's partials in shared memory

    // hom: warp item = (16-row tile, n8 tile, share of the tile's modes)
    const int spp = a.tm / 8 / sh.parts;   // k8 steps per share
    for (int item = warp; item < sh.ct * sh.nt * sh.parts; item += kWarps) {
      const int p = item % sh.parts, ct = (item / sh.parts) % sh.ct;
      const int nn = item / sh.parts / sh.ct;
      const int row = 16 * ct + 1 + (lane & 7) + 8 * ((lane >> 3) & 1);
      const uint32_t ar_addr = smem_addr(pr + row * ld + 4 * (lane >> 4));
      const uint32_t ai_addr = smem_addr(pi + row * ld + 4 * (lane >> 4));
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int u = 0; u < spp; ++u) {
        const int s = p * spp + u;
        const AFrag ar = load_a<true>(ar_addr + 32 * s);
        const AFrag ai = load_a<true>(ai_addr + 32 * s);
        const int w0 = (8 * s + tig) * kw + 8 * nn + gid, w1 = w0 + 4 * kw;
        uint32_t ah0, al0, ah1, al1, bh0, bl0, bh1, bl1;
        split_tf32(__float_as_uint(wa[w0]), ah0, al0);
        split_tf32(__float_as_uint(wa[w1]), ah1, al1);
        split_tf32(__float_as_uint(wb[w0]), bh0, bl0);
        split_tf32(__float_as_uint(wb[w1]), bh1, bl1);
        float pa[4], pb[4];
        mma3<true>(pa, ar, ah0, ah1, al0, al1);
        mma3<true>(pb, ai, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += pa[q] + pb[q];
      }
      // accumulator q: row c = 16 ct + gid (+8 for q >= 2), chunk 8 nn +
      // 2 tig (+1 for odd q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 16 * ct + gid + 8 * h;
        *reinterpret_cast<float2*>(
            red + (p * 16 * sh.ct + c) * kw + 8 * nn + 2 * tig) =
            make_float2(acc[2 * h], acc[2 * h + 1]);
      }
    }
    __syncthreads();   // hom's partials in shared memory: tables free
    if (i + 1 < my_tiles)   // the next tile's mode rows
      next = mode_row(a, o, (tile + Q) * a.tm + tid, tid < a.tm);

    // this tile's [K+1, C] into the block's sum, in a fixed order
    for (int idx = tid; idx < (K + 1) * C; idx += kThreads) {
      const int r = idx / C, c = idx - r * C;
      float v = 0.f;
      if (r < K) {
        for (int p = 0; p < sh.parts; ++p)
          v += red[(p * 16 * sh.ct + c) * kw + r];
      } else {
        for (int q = 0; q < kQuarters; ++q) v += gred[q * C + c];
      }
      part[idx] = i == 0 ? v : part[idx] + v;
    }
    __syncthreads();   // the tile's buffers are free
    if (i + 1 < my_tiles && tid == 0)   // the next tile's copies
      issue_tile(a, sh, pr, pi, bars, tile + Q, o);
  }

  cluster.sync();   // every block's sum is in its shared memory
  // this block's share of the outputs, s in [s_lo, s_hi): every thread
  // copies remote values first (rank q's G row and its sums of the share)
  const int s_lo = rank * a.S / Q, n_out = (rank + 1) * a.S / Q - s_lo;
  float* rem = smem + lay.rem;
  for (int idx = tid; idx < Q * (C + n_out); idx += kThreads) {
    const int q = idx / (C + n_out), e = idx - q * (C + n_out);
    const float* src = cluster.map_shared_rank(part, q);
    rem[q * lay.rem_ld + e] = e < C ? src[K * C + e] : src[s_lo + e - C];
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {   // G over the cluster
    float g = 0.f;
    for (int q = 0; q < Q; ++q) g += rem[q * lay.rem_ld + c];
    gsum[c] = g;
  }
  __syncthreads();
  // hom over the cluster plus the within-chunk convolution G (*) f: L
  // lanes per output each take every L-th term, reduced by shuffles
  int L = 1;
  while (L < 32 && 2 * L * n_out <= kThreads) L *= 2;
  const int sub = tid & (L - 1);
  for (int e0 = 0; e0 < n_out; e0 += kThreads / L) {
    const int e = e0 + tid / L;
    const int s = s_lo + e, k = s / C, c = s - k * C;
    float conv = 0.f;
    if (e < n_out) {
      const float* fk = fs + k * C;
      for (int j = sub; j <= c; j += L) conv += gsum[c - j] * fk[j];
    }
    for (int off = 1; off < L; off <<= 1)
      conv += __shfl_xor_sync(0xffffffffu, conv, off);
    if (e < n_out && sub == 0) {
      float h = 0.f;
      for (int q = 0; q < Q; ++q) h += rem[q * lay.rem_ld + C + e];
      a.sound[(long long)o * a.S + s] = h + conv;
    }
  }
  cluster.sync();   // no block leaves while its sum is still read
}

// one launch's cluster size: clusters only as wide as it takes to give
// every SM a block; with as many objects as SMs one block per object walks
// all its tiles
struct Plan {
  int cluster;
  size_t smem;
  Plan(int tiles, int tm, int S, int C, int O, int sms) {
    const int want = min(min(tiles, kMaxCluster), max(1, cdiv(sms, O)));
    cluster = cdiv(tiles, cdiv(tiles, want));
    smem = 4ull * Layout(Shape(tm, S, C), cluster).total;
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of a block with one table buffer, for
// tiles of tm modes (the wrapper picks the widest tile that fits).
long long fused_block_smem_bytes(int tm, int S, int C) {
  return 4LL * Layout(Shape(tm, S, C), kMaxCluster).total;
}

// Floats of one tile's table (C+1 rows of tm + kPad): the wrapper's
// tile-major layout [Og, T, C+1, tm + kPad].
int fused_block_row_floats(int tm) { return tm + kPad; }

// One block step. Tables tile-major [Og, T, C+1, tm + kPad] (modes past M
// and the pad zero; tbl_obj_stride = 0 for a shared bank, T (C+1)
// (tm + kPad) otherwise; tm one of 32, 64, 128); b/space/transfer/mask/z
// [O, M]; f [O, S]; outputs z' [O, M] and sound [O, S]; S a multiple of C;
// every array contiguous and 16-byte aligned. Returns the first
// cudaError_t (0 = success).
int fused_block_step(const float* tbl_re, const float* tbl_im,
                     long long tbl_obj_stride, int tiles, const float* b_re,
                     const float* b_im, const float* space,
                     const float* transfer, const float* mask,
                     const float* z_re, const float* z_im, const float* f,
                     float* z_re_out, float* z_im_out, float* sound, int O,
                     int M, int S, int C, int tm, void* stream) {
  // per device, queried once: its SM count; the largest shared-memory
  // attribute set so far
  static int sms[kMaxDevices] = {};
  static size_t attr_bytes[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const Plan plan(tiles, tm, S, C, O, sms[dev]);
  if (plan.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (plan.smem > attr_bytes[dev]) {
    err = cudaFuncSetAttribute(fused_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    attr_bytes[dev] = plan.smem;
  }
  const Args a{tbl_re, tbl_im, tbl_obj_stride, b_re, b_im, space, transfer,
               mask, z_re, z_im, f, z_re_out, z_im_out, sound, M, S, C, tm,
               tiles};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.cluster, O, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_block_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The message of a cudaError_t returned by any entry point of the library.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
