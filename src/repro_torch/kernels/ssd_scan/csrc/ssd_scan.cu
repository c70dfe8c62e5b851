// Mamba-2 SSD chunk scan for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels src/repro/kernels/ssd_scan/kernel.py:
// ssd_scan_fwd (_ssd_kernel, _ssd_res_kernel) and ssd_scan_bwd
// (_ssd_bwd_kernel).
//
// Inputs: x (b, l, h, p) and B, C (b, l, n) in fp32 or bf16, a (b, l, h)
// fp32 log-decays (<= 0), l a multiple of the chunk c (c <= 256, any
// value; p, n <= 64).  All arithmetic is fp32.
//
// Forward, per chunk, with cum = cumsum(a) over the chunk and
// L[l, s] = exp(cum_l - cum_s) for l >= s (0 above the diagonal, where
// exp is never evaluated):
//   y[l]  = sum_{s <= l} (C_l . B_s) L[l, s] x[s] + exp(cum_l) h C_l
//   h    <- sum_s exp(cum_end - cum_s) x[s] (x) B[s] + exp(cum_end) h
// y is written in x's dtype, h_final (b, h, p, n) in fp32, and, for the
// backward, the state entering each chunk, h_prev (b, nc, h, p, n) fp32.
//
// Backward, walking the chunks in reverse from dh = dL/dh_final: the TPU
// kernel's formulas (dx, dcum and its reverse cumsum da, dB, dC, and the
// state carry dh <- sum_l exp(cum_l) dy[l] (x) C[l] + exp(cum_end) dh).
// dx and da are per head and written by the block in the primal dtypes;
// dB and dC are sums over heads, so each block writes its head's share
// to an fp32 buffer (b, h, l, n) and the caller sums over h in a fixed
// order: no float atomics, the gradient is the same bit for bit from run
// to run.  Every reduction inside a block (cumsums, row sums, the dcum
// of the chunk's last row) runs in a fixed order too.
//
// Design.  One block of 256 threads per (batch, head) — 128 blocks for
// the training batch of 2 x 64 heads — walks the chunks in order
// (reverse in the backward), so the carried state (p x n fp32, 16 KB)
// stays in shared memory.  Within a chunk, rows are cut into tiles of 64:
// the block stages one 64-row tile each of the operands it needs in
// shared memory (fp32, rows padded to 65 floats against bank conflicts),
// forms each (l-tile, s-tile) block of C B^T, and of dy x^T in the
// backward, in registers (4 x 4 per thread), builds L on the fly only
// where l >= s, and accumulates the products in registers.  No (c, c)
// or (h, c, c) matrix is ever materialised in device memory.  Shared
// memory: 82 KB forward, 132 KB backward.
//
// What bounds it on the H100: per chunk and head the forward does about
// c^2 (n + p) / 2 + 2 c p n multiply-adds, the backward about three times
// that, in fp32 on the CUDA cores; each input byte is read once (plus
// the re-reads of earlier tiles, which hit L2).  At the training shape
// (b 2, l 2048, h 64, p = n = 64, c 256) that is about 4 G multiply-adds
// forward against 34 MB moved: operations bound it (fp32 non-tensor
// peak).  C B^T is shared by all heads and each block recomputes it;
// tensor-core products and sharing C B^T across heads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // tile rows; p, n <= kTile
constexpr int kStride = kTile + 1;      // padded shared-memory row
constexpr int kTileFloats = kTile * kStride;
constexpr int kMaxChunk = kThreads;     // one thread per row for the scans
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [0, 64) of a slab with row stride `ld` elements into a 64 x kStride
// fp32 tile; rows >= nrows and columns >= ncols read as 0.
template <typename T>
__device__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                          long long ld, int nrows, int ncols) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    dst[r * kStride + c] =
        (r < nrows && c < ncols) ? to_f(src[r * ld + c]) : 0.f;
  }
}

// Inclusive prefix sum over the block's threads, in a fixed order.
__device__ float block_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  __syncthreads();
  return v + base;
}

// Sum over the block's threads, the same value in every thread.
__device__ float block_sum(float v, float* warp_tot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += warp_tot[w];
  __syncthreads();
  return s;
}

// Sum over the 16 lanes of a half warp (the threads of one row group).
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Thread t owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of a
// 64 x 64 tile: ty = t / 16, tx = t % 16.
#define FOR4(i) _Pragma("unroll") for (int i = 0; i < 4; ++i)

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               T* __restrict__ y, float* __restrict__ hfin,
               float* __restrict__ hprev, int L, int H, int P, int N,
               int chunk) {
  extern __shared__ float smem[];
  float* Ct = smem;                     // C, rows of the l tile   [l][n]
  float* Bt = Ct + kTileFloats;         // B, rows of the s tile   [s][n]
  float* Xt = Bt + kTileFloats;         // x, rows of the s tile   [s][p]
  float* Wt = Xt + kTileFloats;         // (C B^T) o L             [l][s]
  float* Hs = Wt + kTileFloats;         // carried state           [p][n]
  float* cum = Hs + kTileFloats;        // cumsum(a) over the chunk
  float* red = cum + kMaxChunk;         // 32 floats of scratch

  const int hi = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nc = L / chunk, ntiles = (chunk + kTile - 1) / kTile;
  const long long rowx = static_cast<long long>(H) * P;

  for (int e = tid; e < kTileFloats; e += kThreads) Hs[e] = 0.f;
  for (int ci = 0; ci < nc; ++ci) {
    const long long t0 = static_cast<long long>(bi) * L +
                         static_cast<long long>(ci) * chunk;
    const float av = tid < chunk ? a[(t0 + tid) * H + hi] : 0.f;
    cum[tid] = block_scan(av, red);
    if (hprev != nullptr) {
      float* hp = hprev + ((static_cast<long long>(bi) * nc + ci) * H + hi) *
                              P * N;
      for (int e = tid; e < P * N; e += kThreads)
        hp[e] = Hs[(e / N) * kStride + e % N];
    }
    __syncthreads();
    const float cend = cum[chunk - 1];
    float acc_h[4][4] = {};             // (p = ty + 16 i, n = tx + 16 j)
    for (int lt = 0; lt < ntiles; ++lt) {
      const int l0 = lt * kTile, lrows = min(kTile, chunk - l0);
      load_tile(Ct, Cm + (t0 + l0) * N, N, lrows, N);
      float acc[4][4] = {};             // y (l = ty + 16 i, p = tx + 16 j)
      for (int st = 0; st <= lt; ++st) {
        const int s0 = st * kTile, srows = min(kTile, chunk - s0);
        load_tile(Bt, Bm + (t0 + s0) * N, N, srows, N);
        load_tile(Xt, x + (t0 + s0) * rowx + static_cast<long long>(hi) * P,
                  rowx, srows, P);
        __syncthreads();
        float sc[4][4] = {};            // C B^T (l = ty + 16 i, s = tx + 16 j)
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
          FOR4(i) cv[i] = Ct[(ty + 16 * i) * kStride + k];
          FOR4(j) bv[j] = Bt[(tx + 16 * j) * kStride + k];
          FOR4(i) FOR4(j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
        FOR4(i) FOR4(j) {
          const int l = l0 + ty + 16 * i, s = s0 + tx + 16 * j;
          float w = 0.f;
          if (s <= l && l < chunk) w = sc[i][j] * expf(cum[l] - cum[s]);
          Wt[(ty + 16 * i) * kStride + tx + 16 * j] = w;
        }
        __syncthreads();
        for (int s = 0; s < srows; ++s) {
          float wv[4], xv[4];
          FOR4(i) wv[i] = Wt[(ty + 16 * i) * kStride + s];
          FOR4(j) xv[j] = Xt[s * kStride + tx + 16 * j];
          FOR4(i) FOR4(j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
        if (lt == ntiles - 1) {         // the last l tile visits every s tile
          for (int s = 0; s < srows; ++s) {
            const float de = expf(cend - cum[s0 + s]);
            float xv[4], bv[4];
            FOR4(i) xv[i] = de * Xt[s * kStride + ty + 16 * i];
            FOR4(j) bv[j] = Bt[s * kStride + tx + 16 * j];
            FOR4(i) FOR4(j) acc_h[i][j] = fmaf(xv[i], bv[j], acc_h[i][j]);
          }
        }
        __syncthreads();
      }
      // the carried state's share: exp(cum_l) * sum_n C[l][n] h[p][n]
      float off[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float cv[4], hv[4];
        FOR4(i) cv[i] = Ct[(ty + 16 * i) * kStride + k];
        FOR4(j) hv[j] = Hs[(tx + 16 * j) * kStride + k];
        FOR4(i) FOR4(j) off[i][j] = fmaf(cv[i], hv[j], off[i][j]);
      }
      FOR4(i) {
        const int l = l0 + ty + 16 * i;
        if (l >= chunk) continue;
        const float el = expf(cum[l]);
        T* yr = y + (t0 + l) * rowx + static_cast<long long>(hi) * P;
        FOR4(j) {
          const int p = tx + 16 * j;
          if (p < P) store_f(yr + p, acc[i][j] + el * off[i][j]);
        }
      }
      __syncthreads();
    }
    const float eend = expf(cend);
    FOR4(i) FOR4(j) {
      float* hv = &Hs[(ty + 16 * i) * kStride + tx + 16 * j];
      *hv = fmaf(*hv, eend, acc_h[i][j]);
    }
    __syncthreads();
  }
  float* hf = hfin + (static_cast<long long>(bi) * H + hi) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    hf[e] = Hs[(e / N) * kStride + e % N];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ hprev, const T* __restrict__ dy,
               const float* __restrict__ dhfin, T* __restrict__ dx,
               float* __restrict__ da, float* __restrict__ dBp,
               float* __restrict__ dCp, int L, int H, int P, int N,
               int chunk) {
  extern __shared__ float smem[];
  float* Ct = smem;                     // C, rows of the l tile   [l][n]
  float* Dt = Ct + kTileFloats;         // dy, rows of the l tile  [l][p]
  float* Bt = Dt + kTileFloats;         // B, rows of the s tile   [s][n]
  float* Xt = Bt + kTileFloats;         // x, rows of the s tile   [s][p]
  float* P1 = Xt + kTileFloats;         // (C B^T) o L             [s][l]
  float* P2 = P1 + kTileFloats;         // L o (dy x^T)        [l][s]/[s][l]
  float* Hin = P2 + kTileFloats;        // state entering the chunk [p][n]
  float* Dh = Hin + kTileFloats;        // dL/d(state leaving it)   [p][n]
  float* cum = Dh + kTileFloats;        // cumsum(a) over the chunk
  float* dcum = cum + kMaxChunk;        // dL/dcum
  float* red = dcum + kMaxChunk;        // 32 floats of scratch

  const int hi = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nc = L / chunk, ntiles = (chunk + kTile - 1) / kTile;
  const long long rowx = static_cast<long long>(H) * P;
  const long long part = (static_cast<long long>(bi) * H + hi) * L;

  load_tile(Dh, dhfin + (static_cast<long long>(bi) * H + hi) * P * N, N, P,
            N);
  for (int ci = nc - 1; ci >= 0; --ci) {
    const long long t0 = static_cast<long long>(bi) * L +
                         static_cast<long long>(ci) * chunk;
    const long long c0 = static_cast<long long>(ci) * chunk;
    const float av = tid < chunk ? a[(t0 + tid) * H + hi] : 0.f;
    cum[tid] = block_scan(av, red);
    dcum[tid] = 0.f;
    load_tile(Hin,
              hprev + ((static_cast<long long>(bi) * nc + ci) * H + hi) * P *
                          N,
              N, P, N);
    __syncthreads();
    const float cend = cum[chunk - 1];

    // ---- pass A, by l tile: dC, the row sums of (C B^T) o L o (dy x^T),
    // the carried state's terms
    float acc_dh[4][4] = {};            // (p = ty + 16 i, n = tx + 16 j)
    for (int lt = 0; lt < ntiles; ++lt) {
      const int l0 = lt * kTile, lrows = min(kTile, chunk - l0);
      load_tile(Ct, Cm + (t0 + l0) * N, N, lrows, N);
      load_tile(Dt, dy + (t0 + l0) * rowx + static_cast<long long>(hi) * P,
                rowx, lrows, P);
      float acc[4][4] = {};             // dC (l = ty + 16 i, n = tx + 16 j)
      float rowm[4] = {};
      for (int st = 0; st <= lt; ++st) {
        const int s0 = st * kTile, srows = min(kTile, chunk - s0);
        load_tile(Bt, Bm + (t0 + s0) * N, N, srows, N);
        load_tile(Xt, x + (t0 + s0) * rowx + static_cast<long long>(hi) * P,
                  rowx, srows, P);
        __syncthreads();
        float sc[4][4] = {}, g[4][4] = {};   // (l = ty + 16 i, s = tx + 16 j)
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
          FOR4(i) cv[i] = Ct[(ty + 16 * i) * kStride + k];
          FOR4(j) bv[j] = Bt[(tx + 16 * j) * kStride + k];
          FOR4(i) FOR4(j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
        for (int k = 0; k < P; ++k) {
          float dv[4], xv[4];
          FOR4(i) dv[i] = Dt[(ty + 16 * i) * kStride + k];
          FOR4(j) xv[j] = Xt[(tx + 16 * j) * kStride + k];
          FOR4(i) FOR4(j) g[i][j] = fmaf(dv[i], xv[j], g[i][j]);
        }
        FOR4(i) FOR4(j) {
          const int l = l0 + ty + 16 * i, s = s0 + tx + 16 * j;
          float p2 = 0.f;
          if (s <= l && l < chunk) p2 = expf(cum[l] - cum[s]) * g[i][j];
          rowm[i] = fmaf(sc[i][j], p2, rowm[i]);
          P2[(ty + 16 * i) * kStride + tx + 16 * j] = p2;
        }
        __syncthreads();
        for (int s = 0; s < srows; ++s) {
          float pv[4], bv[4];
          FOR4(i) pv[i] = P2[(ty + 16 * i) * kStride + s];
          FOR4(j) bv[j] = Bt[s * kStride + tx + 16 * j];
          FOR4(i) FOR4(j) acc[i][j] = fmaf(pv[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
      // inter-chunk: hC[l][n] = sum_p dy[l][p] h_in[p][n]
      float hc[4][4] = {};
      for (int k = 0; k < P; ++k) {
        float dv[4], hv[4];
        FOR4(i) dv[i] = Dt[(ty + 16 * i) * kStride + k];
        FOR4(j) hv[j] = Hin[k * kStride + tx + 16 * j];
        FOR4(i) FOR4(j) hc[i][j] = fmaf(dv[i], hv[j], hc[i][j]);
      }
      FOR4(i) {
        const int l = l0 + ty + 16 * i;
        const float el = l < chunk ? expf(cum[l]) : 0.f;
        float rowdot = 0.f;
        FOR4(j) {
          rowdot = fmaf(hc[i][j], Ct[(ty + 16 * i) * kStride + tx + 16 * j],
                        rowdot);
          acc[i][j] = fmaf(hc[i][j], el, acc[i][j]);
        }
        const float r = row16_sum(fmaf(el, rowdot, rowm[i]));
        if (tx == 0 && l < chunk) dcum[l] += r;
        if (l < chunk) {
          float* dc = dCp + (part + c0 + l) * N;
          FOR4(j) {
            const int n = tx + 16 * j;
            if (n < N) dc[n] = acc[i][j];
          }
        }
      }
      // dh_in += sum_l exp(cum_l) dy[l][p] C[l][n]
      for (int l = 0; l < lrows; ++l) {
        const float el = expf(cum[l0 + l]);
        float dv[4], cv[4];
        FOR4(i) dv[i] = el * Dt[l * kStride + ty + 16 * i];
        FOR4(j) cv[j] = Ct[l * kStride + tx + 16 * j];
        FOR4(i) FOR4(j) acc_dh[i][j] = fmaf(dv[i], cv[j], acc_dh[i][j]);
      }
      __syncthreads();
    }

    // ---- pass B, by s tile: dx, dB, the column sums, the state carry
    float sde = 0.f;                    // sum_s exp(cum_end - cum_s) dde[s]
    for (int st = 0; st < ntiles; ++st) {
      const int s0 = st * kTile, srows = min(kTile, chunk - s0);
      load_tile(Bt, Bm + (t0 + s0) * N, N, srows, N);
      load_tile(Xt, x + (t0 + s0) * rowx + static_cast<long long>(hi) * P,
                rowx, srows, P);
      float adx[4][4] = {};             // dx (s = ty + 16 i, p = tx + 16 j)
      float adb[4][4] = {};             // dB (s = ty + 16 i, n = tx + 16 j)
      float colm[4] = {};
      for (int lt = st; lt < ntiles; ++lt) {
        const int l0 = lt * kTile, lrows = min(kTile, chunk - l0);
        load_tile(Ct, Cm + (t0 + l0) * N, N, lrows, N);
        load_tile(Dt, dy + (t0 + l0) * rowx + static_cast<long long>(hi) * P,
                  rowx, lrows, P);
        __syncthreads();
        float sc[4][4] = {}, g[4][4] = {};   // (s = ty + 16 i, l = tx + 16 j)
        for (int k = 0; k < N; ++k) {
          float bv[4], cv[4];
          FOR4(i) bv[i] = Bt[(ty + 16 * i) * kStride + k];
          FOR4(j) cv[j] = Ct[(tx + 16 * j) * kStride + k];
          FOR4(i) FOR4(j) sc[i][j] = fmaf(bv[i], cv[j], sc[i][j]);
        }
        for (int k = 0; k < P; ++k) {
          float xv[4], dv[4];
          FOR4(i) xv[i] = Xt[(ty + 16 * i) * kStride + k];
          FOR4(j) dv[j] = Dt[(tx + 16 * j) * kStride + k];
          FOR4(i) FOR4(j) g[i][j] = fmaf(xv[i], dv[j], g[i][j]);
        }
        FOR4(i) FOR4(j) {
          const int s = s0 + ty + 16 * i, l = l0 + tx + 16 * j;
          const float lv =
              (s <= l && l < chunk) ? expf(cum[l] - cum[s]) : 0.f;
          const float p1 = sc[i][j] * lv, p2 = lv * g[i][j];
          colm[i] = fmaf(p1, g[i][j], colm[i]);
          P1[(ty + 16 * i) * kStride + tx + 16 * j] = p1;
          P2[(ty + 16 * i) * kStride + tx + 16 * j] = p2;
        }
        __syncthreads();
        for (int l = 0; l < lrows; ++l) {
          float p1[4], p2[4], dv[4], cv[4];
          FOR4(i) p1[i] = P1[(ty + 16 * i) * kStride + l];
          FOR4(i) p2[i] = P2[(ty + 16 * i) * kStride + l];
          FOR4(j) dv[j] = Dt[l * kStride + tx + 16 * j];
          FOR4(j) cv[j] = Ct[l * kStride + tx + 16 * j];
          FOR4(i) FOR4(j) {
            adx[i][j] = fmaf(p1[i], dv[j], adx[i][j]);
            adb[i][j] = fmaf(p2[i], cv[j], adb[i][j]);
          }
        }
        __syncthreads();
      }
      // state carry: Bdh[s][p] = sum_n B[s][n] dh[p][n],
      // xd[s][n] = sum_p x[s][p] dh[p][n]
      float bdh[4][4] = {}, xd[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float bv[4], hv[4];
        FOR4(i) bv[i] = Bt[(ty + 16 * i) * kStride + k];
        FOR4(j) hv[j] = Dh[(tx + 16 * j) * kStride + k];
        FOR4(i) FOR4(j) bdh[i][j] = fmaf(bv[i], hv[j], bdh[i][j]);
      }
      for (int k = 0; k < P; ++k) {
        float xv[4], hv[4];
        FOR4(i) xv[i] = Xt[(ty + 16 * i) * kStride + k];
        FOR4(j) hv[j] = Dh[k * kStride + tx + 16 * j];
        FOR4(i) FOR4(j) xd[i][j] = fmaf(xv[i], hv[j], xd[i][j]);
      }
      FOR4(i) {
        const int s = s0 + ty + 16 * i;
        const float de = s < chunk ? expf(cend - cum[s]) : 0.f;
        float dde = 0.f;
        FOR4(j) {
          dde = fmaf(Xt[(ty + 16 * i) * kStride + tx + 16 * j], bdh[i][j],
                     dde);
          adx[i][j] = fmaf(de, bdh[i][j], adx[i][j]);
          adb[i][j] = fmaf(de, xd[i][j], adb[i][j]);
        }
        dde = row16_sum(dde);
        const float cm = row16_sum(colm[i]);
        if (tx == 0 && s < chunk) {
          dcum[s] -= cm + de * dde;
          sde = fmaf(de, dde, sde);
        }
        if (s < chunk) {
          T* dxr = dx + (t0 + s) * rowx + static_cast<long long>(hi) * P;
          float* dbr = dBp + (part + c0 + s) * N;
          FOR4(j) {
            const int q = tx + 16 * j;
            if (q < P) store_f(dxr + q, adx[i][j]);
            if (q < N) dbr[q] = adb[i][j];
          }
        }
      }
      __syncthreads();
    }

    // the chunk's last row: sum_s de dde + exp(cum_end) sum(h_in * dh)
    const float eend = expf(cend);
    float hd = 0.f;
    FOR4(i) FOR4(j) {
      const int e = (ty + 16 * i) * kStride + tx + 16 * j;
      hd = fmaf(Hin[e], Dh[e], hd);
    }
    const float last = block_sum(fmaf(eend, hd, sde), red);
    if (tid == 0) dcum[chunk - 1] += last;
    __syncthreads();
    // da[t] = sum_{u >= t} dcum[u]: a prefix sum over the reversed rows
    const int t = chunk - 1 - tid;
    const float r = block_scan(tid < chunk ? dcum[t] : 0.f, red);
    if (tid < chunk) da[(t0 + t) * H + hi] = r;
    // dL/d(state entering this chunk), the next step's dh
    FOR4(i) FOR4(j) {
      float* dv = &Dh[(ty + 16 * i) * kStride + tx + 16 * j];
      *dv = fmaf(*dv, eend, acc_dh[i][j]);
    }
    __syncthreads();
  }
}

constexpr size_t kFwdSmem = (5 * kTileFloats + kMaxChunk + 32) * sizeof(float);
constexpr size_t kBwdSmem =
    (8 * kTileFloats + 2 * kMaxChunk + 32) * sizeof(float);

bool bad_shape(int b, int L, int H, int P, int N, int chunk, int dtype) {
  return b < 1 || b > 65535 || H < 1 || P < 1 || P > kTile || N < 1 ||
         N > kTile || chunk < 1 || chunk > kMaxChunk || L < chunk ||
         L % chunk != 0 || (dtype != 0 && dtype != 1);
}

template <typename T>
int launch_fwd(const void* x, const void* a, const void* B, const void* C,
               void* y, void* hfin, void* hprev, int b, int L, int H, int P,
               int N, int chunk, cudaStream_t s) {
  auto kern = ssd_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(H, b), kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(hfin), static_cast<float*>(hprev), L, H, P, N,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* a, const void* B, const void* C,
               const void* hprev, const void* dy, const void* dhfin, void* dx,
               void* da, void* dBp, void* dCp, int b, int L, int H, int P,
               int N, int chunk, cudaStream_t s) {
  auto kern = ssd_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(H, b), kThreads, kBwdSmem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(hprev), static_cast<const T*>(dy),
      static_cast<const float*>(dhfin), static_cast<T*>(dx),
      static_cast<float*>(da), static_cast<float*>(dBp),
      static_cast<float*>(dCp), L, H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32 x / B / C (and y, dy, dx), 1 = bf16.  a, h_final, h_prev,
// dh_final, da and the dB / dC partials are fp32.  hprev may be null (no
// residual saved).  Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* B,
                            const void* C, void* y, void* hfin, void* hprev,
                            int b, int L, int H, int P, int N, int chunk,
                            int dtype, void* stream) {
  if (bad_shape(b, L, H, P, N, chunk, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, a, B, C, y, hfin, hprev, b, L, H, P, N,
                             chunk, s);
  return launch_fwd<__nv_bfloat16>(x, a, B, C, y, hfin, hprev, b, L, H, P, N,
                                   chunk, s);
}

extern "C" int ssd_scan_bwd(const void* x, const void* a, const void* B,
                            const void* C, const void* hprev, const void* dy,
                            const void* dhfin, void* dx, void* da, void* dBp,
                            void* dCp, int b, int L, int H, int P, int N,
                            int chunk, int dtype, void* stream) {
  if (bad_shape(b, L, H, P, N, chunk, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, a, B, C, hprev, dy, dhfin, dx, da, dBp, dCp,
                             b, L, H, P, N, chunk, s);
  return launch_bwd<__nv_bfloat16>(x, a, B, C, hprev, dy, dhfin, dx, da, dBp,
                                   dCp, b, L, H, P, N, chunk, s);
}
