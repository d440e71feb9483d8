// Fused per-block modal step for heterogeneous banks, Hopper (sm_90a).
//
// Replaces openpbso_tpu/ops/pallas_integrator.py::_fused_kernel together
// with the XLA within-chunk Toeplitz convolution of its wrapper
// (step_block_pallas). For one S-sample block of every (object, mode)
// oscillator, with beff = b*space and t = transfer*mask, in K = S/C chunks
// of C samples:
//
//   G[d]     = sum_m t_m Im(lam^d beff_m)              d in [0, C), once
//   hom_k[c] = sum_m t_m Im(lam^(c+1) z_k,m)           c in [0, C)
//   z_k+1    = lam^C z_k + beff sum_j lam^(C-1-j) f_kC+j
//   sound    = hom + G (*) f                           within each chunk
//
// Bound: memory, on the chunk tables lam^0..lam^C ([Og, C+1, M], re and
// im). At 256 objects x 1024 modes and C = 64 a heterogeneous bank reads
// ~136 MB of tables per block; from the H100 SXM data sheet (3.35 TB/s)
// that is a floor of ~41 us per block (a reckoning, not a measurement).
// Everything else per block is O(O*M) state or O(O*S) profiles, and the
// arithmetic is ~2*(K+1)*C + 2*K*C multiply-adds per mode.
//
// Design against that bound:
//   - Launch 1 (grid: mode tile x object) reads each table element from
//     device memory exactly once: the tile's columns go to shared memory
//     by 4-byte cp.async, every copy of a thread in flight at once (the
//     same loads staged through registers left the load phase
//     latency-bound), and serve the injections and the reductions of
//     every chunk. A shared bank (Og = 1) is read with object stride 0,
//     never broadcast.
//   - Two threads per mode. The halves split the table load and the
//     injection sums (each takes half of the chunks); then one half runs
//     the mode's serial recurrence z_k -> z_k+1, which is only K complex
//     multiply-adds, and leaves the weights t*z_k of every chunk (and
//     t*beff for G) in shared memory. Nothing is reduced inside the
//     serial loop.
//   - The tile's mode reduction is one small product [K+1, TM] x
//     [TM, C] from shared memory: each thread owns one column and a
//     quarter of the modes, holds up to 8 rows in registers, reads the
//     weights as broadcast float4s, and the partial sums of the quarters
//     are added in shared memory in a fixed order. The state z' is per
//     mode and is written directly; per-tile partials of hom and G go to
//     a small scratch ([O, T, S] and [O, T, C] for T mode tiles).
//   - Launch 2 (one block per object) sums the T partials in a fixed
//     order (deterministic, no atomics) and adds the Toeplitz term. Two
//     runs give bitwise-equal results.
//
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, and the first error is returned as a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kChunkBatch = 4;  // chunks whose injection sums share a pass
constexpr int kRowBatch = 8;    // hom rows held in registers at once
constexpr int kPad = 4;         // row padding of the shared tables (floats)

struct Layout {  // launch 1's dynamic shared memory, offsets in floats
  int tp, s4, split, pr, pi, fs, inj, wa, wb, red, total;
  __host__ __device__ Layout(int tm, int S, int C) {
    const int K = S / C, R = K + 1, threads = 2 * tm;
    tp = tm + kPad;                           // padded table row
    s4 = (S + 3) & ~3;                        // keeps float4 alignment
    split = threads / C > 1 ? threads / C : 1;  // product split over modes
    pr = 0;                                   // [C+1][tp] lam^d, re
    pi = pr + (C + 1) * tp;                   // [C+1][tp] lam^d, im
    fs = pi + (C + 1) * tp;                   // [s4] time profile
    inj = fs + s4;                            // [2][K][tm] injection sums
    wa = inj + 2 * K * tm;                    // [R][tm] weights on re
    wb = wa + R * tm;                         // [R][tm] weights on im
    red = wb + R * tm;                        // [split][R][C] partials
    total = red + split * R * C;
  }
};

// 4-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Block of 2*tm threads for one (mode tile, object). Weight rows k < K are
// t*Im z_k (wa, against Re lam^(c+1)) and t*Re z_k (wb, against Im
// lam^(c+1)): hom of chunk k. Row K is t*Im beff, t*Re beff against
// lam^c: G.
__global__ void chunk_recurrence_kernel(
    const float* __restrict__ tbl_re, const float* __restrict__ tbl_im,
    long long tbl_obj_stride,
    const float* __restrict__ b_re, const float* __restrict__ b_im,
    const float* __restrict__ space, const float* __restrict__ transfer,
    const float* __restrict__ mask,
    const float* __restrict__ z_re, const float* __restrict__ z_im,
    const float* __restrict__ f,
    float* __restrict__ z_re_out, float* __restrict__ z_im_out,
    float* __restrict__ hom_part, float* __restrict__ g_part,
    int M, int S, int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int threads = blockDim.x;
  const int tm = threads / 2;
  const Layout L(tm, S, C);
  const int tid = threadIdx.x;
  const int mt = tid % tm;   // the mode within the tile
  const int half = tid / tm;
  const int tile = blockIdx.x;
  const int ntiles = gridDim.x;
  const int o = blockIdx.y;
  const int m = tile * tm + mt;
  const bool live = m < M;
  const int K = S / C;
  const int R = K + 1;
  const int tp = L.tp;
  float* pr = smem + L.pr;
  float* pi = smem + L.pi;
  float* fs = smem + L.fs;
  float* inj = smem + L.inj;
  float* wa = smem + L.wa;
  float* wb = smem + L.wb;
  float* red = smem + L.red;

  // this thread's column, every other power (modes past the ragged edge
  // are zero-filled and carry zero weights, so they add nothing)
  const float* tr = tbl_re + (long long)o * tbl_obj_stride + m;
  const float* ti = tbl_im + (long long)o * tbl_obj_stride + m;
#pragma unroll 8
  for (int d = half; d <= C; d += 2) {
    cp_async4(pr + d * tp + mt, live ? tr + (long long)d * M : tbl_re, live);
    cp_async4(pi + d * tp + mt, live ? ti + (long long)d * M : tbl_im, live);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < S; i += threads) fs[i] = f[(long long)o * S + i];
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // injection sum_j lam^(C-1-j) f_kC+j of this half's chunks, d = C-1-j
  const int k_per_half = (K + 1) / 2;
  const int k_end = min(K, (half + 1) * k_per_half);
  for (int k0 = half * k_per_half; k0 < k_end; k0 += kChunkBatch) {
    const int nk = min(kChunkBatch, k_end - k0);
    float s_re[kChunkBatch], s_im[kChunkBatch];
#pragma unroll
    for (int j = 0; j < kChunkBatch; ++j) s_re[j] = s_im[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < C; ++d) {
      const float a = pr[d * tp + mt];
      const float b = pi[d * tp + mt];
      const float* fd = fs + k0 * C + (C - 1 - d);
#pragma unroll
      for (int j = 0; j < kChunkBatch; ++j) {
        if (j < nk) {
          const float fv = fd[j * C];
          s_re[j] += a * fv;
          s_im[j] += b * fv;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kChunkBatch; ++j) {
      if (j < nk) {
        inj[(k0 + j) * tm + mt] = s_re[j];
        inj[(K + k0 + j) * tm + mt] = s_im[j];
      }
    }
  }
  __syncthreads();

  if (half == 0) {  // the serial recurrence of this mode
    float be_r = 0.f, be_i = 0.f, t = 0.f, zr = 0.f, zi = 0.f;
    const long long om = (long long)o * M + m;
    if (live) {
      const float sp = space[om];
      be_r = b_re[om] * sp;
      be_i = b_im[om] * sp;
      t = transfer[om] * mask[om];
      zr = z_re[om];
      zi = z_im[om];
    }
    const float pcr = pr[C * tp + mt], pci = pi[C * tp + mt];
    for (int k = 0; k < K; ++k) {
      wa[k * tm + mt] = t * zi;   // hom of chunk k reads its start state
      wb[k * tm + mt] = t * zr;
      const float s_re = inj[k * tm + mt];
      const float s_im = inj[(K + k) * tm + mt];
      const float nzr = pcr * zr - pci * zi + be_r * s_re - be_i * s_im;
      const float nzi = pci * zr + pcr * zi + be_r * s_im + be_i * s_re;
      zr = nzr;
      zi = nzi;
    }
    wa[K * tm + mt] = t * be_i;
    wb[K * tm + mt] = t * be_r;
    if (live) {
      z_re_out[om] = zr;
      z_im_out[om] = zi;
    }
  }
  __syncthreads();

  // the tile's mode reduction: out[r][c] = sum_m Re P[c+s_r][m] wa[r][m]
  //   + Im P[c+s_r][m] wb[r][m], s_r = 1 for hom rows, 0 for G; column c,
  //   modes split `split` ways, partials to red[split][R][C]
  const int quads = tm / 4;
  const int q_per_split = (quads + L.split - 1) / L.split;
  const float4* wa4 = reinterpret_cast<const float4*>(wa);
  const float4* wb4 = reinterpret_cast<const float4*>(wb);
  for (int task = tid; task < C * L.split; task += threads) {
    const int c = task % C;
    const int sp = task / C;
    const int q0 = sp * q_per_split;
    const int q1 = min(quads, q0 + q_per_split);
    const float4* hr = reinterpret_cast<const float4*>(pr + (c + 1) * tp);
    const float4* hi = reinterpret_cast<const float4*>(pi + (c + 1) * tp);
    const float4* gr = reinterpret_cast<const float4*>(pr + c * tp);
    const float4* gi = reinterpret_cast<const float4*>(pi + c * tp);
    float* out = red + sp * R * C + c;
    float acc_g = 0.f;
#pragma unroll 2
    for (int q = q0; q < q1; ++q) {
      acc_g += dot4(gr[q], wa4[K * quads + q]) + dot4(gi[q], wb4[K * quads + q]);
    }
    out[K * C] = acc_g;
    for (int k0 = 0; k0 < K; k0 += kRowBatch) {
      const int nk = min(kRowBatch, K - k0);
      float acc[kRowBatch];
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) acc[j] = 0.f;
#pragma unroll 2
      for (int q = q0; q < q1; ++q) {
        const float4 h_r = hr[q], h_i = hi[q];
#pragma unroll
        for (int j = 0; j < kRowBatch; ++j) {
          if (j < nk) {
            acc[j] += dot4(h_r, wa4[(k0 + j) * quads + q])
                    + dot4(h_i, wb4[(k0 + j) * quads + q]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        if (j < nk) out[(k0 + j) * C] = acc[j];
      }
    }
  }
  __syncthreads();
  const long long part = (long long)o * ntiles + tile;
  for (int idx = tid; idx < R * C; idx += threads) {
    float acc = 0.f;
    for (int sp = 0; sp < L.split; ++sp) acc += red[sp * R * C + idx];
    const int r = idx / C;
    const int c = idx - r * C;
    if (r < K) hom_part[part * S + r * C + c] = acc;
    else g_part[part * C + c] = acc;
  }
}

// Launch 2: one block per object. Shared memory: g [C], fs [S].
__global__ void toeplitz_finish_kernel(
    const float* __restrict__ hom_part, const float* __restrict__ g_part,
    const float* __restrict__ f, float* __restrict__ sound,
    int S, int C, int ntiles) {
  extern __shared__ float smem[];
  float* g = smem;
  float* fs = g + C;
  const int o = blockIdx.x;
  const long long part0 = (long long)o * ntiles;
  for (int d = threadIdx.x; d < C; d += blockDim.x) {
    float acc = 0.f;
    for (int tl = 0; tl < ntiles; ++tl) acc += g_part[(part0 + tl) * C + d];
    g[d] = acc;
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) fs[i] = f[(long long)o * S + i];
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int k0 = (s / C) * C;
    const int cc = s - k0;
    float h = 0.f;
    for (int tl = 0; tl < ntiles; ++tl) h += hom_part[(part0 + tl) * S + s];
    float conv = 0.f;
    for (int j = 0; j <= cc; ++j) conv += g[cc - j] * fs[k0 + j];
    sound[(long long)o * S + s] = h + conv;
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) that launch 1 needs for a tile of tm modes.
long long fused_block_smem_bytes(int tm, int S, int C) {
  return 4LL * Layout(tm, S, C).total;
}

// One block step. Tables [Og, C+1, M] (tbl_obj_stride = 0 for a shared
// bank, (C+1)*M otherwise); b/space/transfer/mask/z [O, M]; f [O, S];
// outputs z' [O, M] and sound [O, S]; scratch hom_part [O, T, S] and
// g_part [O, T, C] with T = ceil(M / tm). tm is a multiple of 32, S a
// multiple of C. Returns the first cudaError_t (0 = success).
int fused_block_step(
    const float* tbl_re, const float* tbl_im, long long tbl_obj_stride,
    const float* b_re, const float* b_im, const float* space,
    const float* transfer, const float* mask,
    const float* z_re, const float* z_im, const float* f,
    float* z_re_out, float* z_im_out, float* sound,
    float* hom_part, float* g_part,
    int O, int M, int S, int C, int tm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (M + tm - 1) / tm;
  const size_t smem1 = (size_t)fused_block_smem_bytes(tm, S, C);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  chunk_recurrence_kernel<<<dim3(ntiles, O), 2 * tm, smem1, st>>>(
      tbl_re, tbl_im, tbl_obj_stride, b_re, b_im, space, transfer, mask,
      z_re, z_im, f, z_re_out, z_im_out, hom_part, g_part, M, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = sizeof(float) * (size_t)(C + S);
  err = cudaFuncSetAttribute(
      toeplitz_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem2);
  if (err != cudaSuccess) return (int)err;
  toeplitz_finish_kernel<<<O, 256, smem2, st>>>(hom_part, g_part, f, sound,
                                                S, C, ntiles);
  return (int)cudaGetLastError();
}

// The message of a cudaError_t returned by any entry point of the library.
const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
