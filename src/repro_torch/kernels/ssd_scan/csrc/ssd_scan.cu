// Mamba-2 SSD chunk scan for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels of src/repro/kernels/ssd_scan/kernel.py:
// ssd_scan_fwd (_ssd_kernel, and _ssd_res_kernel, which also saves each
// chunk's incoming state) and ssd_scan_bwd (_ssd_bwd_kernel).
//
// Inputs: x (b, l, h, p) and B, C (b, l, n) in bf16 (or fp32, below), a
// (b, l, h) fp32 log-decays (<= 0), l a multiple of the chunk c (c <= 256,
// any value; p, n <= 64).  Per chunk, with cum = cumsum(a) over the chunk,
// T = cum at its last row and L[l, s] = exp(cum_l - cum_s) for l >= s (0
// above the diagonal, where exp is never evaluated):
//   y[l]   = sum_{s <= l} (C_l . B_s) L[l, s] x[s] + exp(cum_l) h C_l
//   h_next = exp(T) h + S,   S = sum_s exp(T - cum_s) x[s] (x) B[s]
// y is written in x's dtype, h_final (b, h, p, n) in fp32 and, for the
// backward, the state entering each chunk, h_prev (b, nc, h, p, n) fp32.
// The backward runs the TPU kernel's formulas (dx, dcum and its reverse
// cumsum da, dB, dC) chunk by chunk from h_prev and dh, the gradient of
// the state leaving the chunk: dh_prev = exp(T) dh + D with
// D = sum_l exp(cum_l) dy[l] (x) C[l].
//
// What bounds it on the H100.  At the training shape (b 2, l 2048, h 64,
// p = n = 64, c 256) the forward needs ~4.3 G multiply-adds and moves
// ~88 MB (x and y, h_prev), the backward ~12.9 G against ~123 MB.  On the
// tensor cores -- the products with an fp32 operand at the TF32 rate, as
// two bf16 products -- that is ~17 us of work against ~26 us of traffic
// forward, ~48 us against ~37 backward.  The TPU kernel walks the chunk
// axis in order with the state in VMEM; a Hopper grid has no order, and
// the chunk-serial design of the first port (one block per (batch,
// head), fp32 FMAs on the CUDA cores, C B^T per head) ran at ~1/8 of its
// CUDA-core bound with half the SMs idle at a b 1 prefill.  This design
// splits the algebra into chunk-parallel products on the tensor cores
// and a small fold of per-chunk states, three kernels a direction, each
// launched as a programmatic dependent of the one before (the training
// forward, which saves h_prev, and the backward; serving: below):
//
// - ssd_state_kernel, one warpgroup per (chunk, batch, head): the chunk's
//   local state S (forward) or D (backward) and its decay total T, into
//   fp32 scratch the wrapper allocates.  The rows weighted by exp(T -
//   cum_s) (or exp(cum_l)) are fp32: each is split into hi = bf16(v) and
//   lo = bf16(v - hi), and the two M-major A operands run against the B (C)
//   rows on wgmma into one fp32 accumulator.
// - ssd_fold_kernel, one thread per four state elements of a (batch,
//   head): h_prev for every chunk from chunk 0 forwards and h_final, or
//   the backward's dh from dh_final through the chunks in reverse, in the
//   order of the TPU kernel and the plain version: no atomics, each
//   prefix computed once.  (Folding inside each output block, every
//   block the prefix it needs, read 28 states a (batch, head) for 8
//   chunks against 8 and cost a fifth of the output kernel's time.)
// - ssd_out_kernel (forward) and ssd_bwd_chunk_kernel (backward), one
//   block per (chunk, batch, group of G heads) of two warpgroups, from the
//   folded states.  The intra-chunk term is the flash forward's S -> P ->
//   P V with the softmax replaced by the decay mask: C B^T on bf16 wgmma
//   (exact products), P = (C B^T) o L in the accumulator registers with L
//   evaluated only where l >= s, P split hi + lo and repacked as register A
//   operands (hopper::acc_to_a_parts) against x; tiles above the diagonal
//   are skipped.  The backward runs the same pattern in both orientations:
//   by l tile, G = dy x^T and (L o G) B for dC and dcum's row sums; by s
//   tile, (C B^T)^T and G^T, then P^T dy for dx with dcum's column sums,
//   and in a second sweep (L o G)^T C for dB (one sweep would hold both
//   accumulators and serialize the wgmmas for want of registers).  Every
//   product with an fp32 operand (P, L o G, the weighted rows, h_prev, dh)
//   is two bf16 wgmmas (hi, lo) into one fp32 accumulator, ~2^-16 of the
//   operand, which keeps h_final, h_prev and da within 1e-4 of their
//   maximum; products of two bf16 inputs are exact.  C B^T is recomputed
//   per head (a third of a tile pair's wgmma work) so that only one
//   head's accumulators are live.
// - Operands are staged by cp.async into the 128-byte swizzle that the
//   wgmma descriptors read (hopper.cuh), rows past the chunk as zeros: a
//   chunk that is not a multiple of 64 never reads the next chunk's rows.
//   The forward loads the next head's x behind the current head's work.
//   The two warpgroups split a chunk's 64-row tiles by cost ({3, 0} and
//   {2, 1} of four).
// - dB and dC sum over heads.  A block adds its heads' shares in head
//   order into its group's fp32 partial (b, h / G, l, n), each element
//   owned by one thread (every old value read before any store); the
//   wrapper sums the partials over groups with one torch.sum, a fixed
//   order: the gradients repeat bit for bit.
// - G, the grid and the tiles come from the shapes alone
//   (kernel.py:scan_plan), so a launch can be captured in a CUDA graph.
//
// What holds it back now: each warpgroup runs its products, their waits
// and the elementwise work between them in series, with two warpgroups
// (one block) an SM, so latency, not the tensor cores or the bytes, sets
// the time; in the backward the partials' read-modify-write adds about a
// third.
//
// fp32 inputs (dtype 0), and the bf16 forward when it saves no h_prev
// (serving), keep the first port's CUDA-core kernels (ssd_fwd_kernel,
// ssd_bwd_kernel below).  No card path feeds the scan fp32.  Serving
// keeps them because their sequential fp32 sums round as the plain scan
// does: zamba2's SSD-only serving gate holds the logits of 38 layers to
// one bf16 ulp of the plain path's, and on slow-decay weights any
// independently rounded fp32-accurate forward -- this one, or the plain
// scan with 1e-7 noise on its own y -- lands 2.6-3 ulps away, although
// this forward is nearer fp64 than the plain scan (PERF.md; recorded
// every run by chip_smoke.py:ssd_gate_probe).  The CUDA-core kernels
// walk the chunks in order, one block of 256 threads per (batch, head),
// the carried state in shared memory, products on 4 x 4 register tiles
// from 64 x 65 fp32 tiles; the fp32 backward writes per-head dB / dC
// partials (G = 1).
#include "hopper.cuh"

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

// ============================ Hopper path (bf16) ============================

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;                         // rows of a tile
constexpr int TILE_BYTES = ROWS * 128;           // 64 x 64 bf16, swizzled
constexpr int MAX_TILES = kMaxChunk / ROWS;      // a chunk's tiles, <= 4
constexpr int SLAB = MAX_TILES * TILE_BYTES;     // one operand's chunk rows
constexpr int MAX_GROUP = 4;                     // heads a block, at most
constexpr int STATE_THREADS = 128;               // one warpgroup
constexpr int NT2 = 256;                         // two warpgroups
// bf16 terms an fp32 operand is split into (hi + lo: ~2^-17 of it)
constexpr int SPLIT_PARTS = 2;
constexpr int PASS_TILES = 2;                    // row tiles a state pass
constexpr int PASS_BYTES = PASS_TILES * TILE_BYTES;
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t kStateSmem = SLAB + SPLIT_PARTS * PASS_BYTES +
                              (kMaxChunk + STATE_THREADS + 32) *
                                  sizeof(float) + 1024;
constexpr size_t kOutSmem = 4 * SLAB + SPLIT_PARTS * TILE_BYTES +
                            (MAX_GROUP * kMaxChunk + 32) * sizeof(float) +
                            1024;
constexpr size_t kBwdChunkSmem =
    4 * SLAB + 4 * TILE_BYTES + ((MAX_GROUP + 3) * kMaxChunk + 32) *
    sizeof(float) + 1024;

// Byte offset of bf16 element (r, col) in a slab of 64-row tiles: 16-byte
// chunk c of row r at chunk c ^ (r % 8) (hopper.cuh's 128-byte swizzle).
__device__ __forceinline__ uint32_t sw_off(int r, int col) {
  return static_cast<uint32_t>((r >> 6) * TILE_BYTES + (r & 63) * 128 +
                               (((col >> 3) ^ (r & 7)) << 4) +
                               ((col & 7) << 1));
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* slab, int r,
                                          int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(slab + sw_off(r, col)));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the most recently committed group
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// This thread's shared-memory writes (stores, cp.async) made visible to
// the async proxy that wgmma reads its shared operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, 64 tiles) of a slab from the bf16 rows src + r * ld, columns
// [0, ncols); rows >= nrows and columns >= ncols are zeros.  vec: every
// row is 64 columns starting 16-byte aligned, copied by cp.async (the
// caller waits); otherwise element by element.
__device__ void load_slab(unsigned char* slab, const bf16* __restrict__ src,
                          long long ld, int nrows, int ncols, int tiles,
                          int vec, int tid, int nthr) {
  const uint32_t base = hopper::smem_u32(slab);
  for (int q = tid; q < tiles * ROWS * 8; q += nthr) {
    const int r = q >> 3, c8 = (q & 7) * 8;
    const uint32_t off = sw_off(r, c8);
    if (vec) {
      const bool ok = r < nrows;
      cp_async16(base + off, ok ? src + r * ld + c8 : src, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c8 + 2 * e;
        const float v0 =
            (r < nrows && c < ncols) ? __bfloat162float(src[r * ld + c]) : 0.f;
        const float v1 = (r < nrows && c + 1 < ncols)
                             ? __bfloat162float(src[r * ld + c + 1])
                             : 0.f;
        w[e] = hopper::pack_bf16x2(v0, v1);
      }
      *reinterpret_cast<uint4*>(slab + off) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Eight bf16 from src (16-byte aligned if vec), those at or past `cols`
// as zeros
__device__ __forceinline__ uint4 load8(const bf16* src, int cols, int vec) {
  if (vec) return *reinterpret_cast<const uint4*>(src);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v0 = 2 * e < cols ? __bfloat162float(src[2 * e]) : 0.f;
    const float v1 = 2 * e + 1 < cols ? __bfloat162float(src[2 * e + 1]) : 0.f;
    w[e] = hopper::pack_bf16x2(v0, v1);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// wgmma descriptors of the k-th 16-wide slice of tile t of a slab:
// K-major (the tile's columns are K) and MN-major (its rows are K)
__device__ __forceinline__ uint64_t dk(const unsigned char* slab, int t,
                                       int k) {
  return hopper::desc_kmajor(hopper::smem_u32(slab) + t * TILE_BYTES, k,
                             TILE_BYTES);
}

__device__ __forceinline__ uint64_t dm(const unsigned char* slab, int t,
                                       int k) {
  return hopper::desc_mnmajor(hopper::smem_u32(slab) + t * TILE_BYTES, k,
                              TILE_BYTES);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  const uint32_t a = hopper::smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// The 64-row tiles of a chunk that warpgroup w takes, balanced by cost:
// tile j of the forward (and of the backward's row pass) runs j + 1 tile
// pairs.  Four tiles go as {3, 0} and {2, 1}, three as {2} and {1, 0}, two
// as {1} and {0}.  The backward's column pass takes the mirror images.
__device__ __forceinline__ int owned(int w, int tiles) {
  if (w == 0) return tiles == 4 ? 2 : 1;
  return tiles >= 3 ? 2 : (tiles == 2 ? 1 : 0);
}

// the o-th of them
__device__ __forceinline__ int own_tile(int w, int tiles, int o) {
  return w == 0 ? (o == 0 ? tiles - 1 : 0) : (o == 0 ? tiles - 2 : tiles - 3);
}

// a 64 x 64 fp32 accumulator (32 registers a thread) set to 0
__device__ __forceinline__ void zero32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// wgmma_ss_n64 over the four 16-wide K slices of one 64-wide operand pair
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void mma4(float (&d)[32], const uint64_t (&da)[4],
                                     const uint64_t (&db)[4], int first) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    hopper::wgmma_ss_n64<TRANS_B, TRANS_A>(d, da[k], db[k],
                                           first && k == 0 ? 0 : 1);
}

// d += P B, P (64 x 64 fp32 accumulator) split into SPLIT_PARTS bf16
// terms as register A operands, B MN-major from shared memory, the
// smallest terms first; P's registers are free afterwards
__device__ __forceinline__ void mma_split(float (&d)[32], const float (&P)[32],
                                          const uint64_t (&db)[4]) {
  uint32_t f[4][SPLIT_PARTS][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hopper::acc_to_a_parts<SPLIT_PARTS>(P, k, f[k]);
    hopper::fence_regs(f[k]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int j = SPLIT_PARTS - 1; j >= 0; --j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_rs_n64<1>(d, f[k][j], db[k], 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// an fp32 pair as SPLIT_PARTS bf16 pairs: bf16 of the pair, then of what
// is left
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t (&out)[SPLIT_PARTS]) {
#pragma unroll
  for (int j = 0; j < SPLIT_PARTS; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    out[j] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__device__ __forceinline__ void retire(float (&d)[32]) {
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// rows r0 and r1 = r0 + 8 of a 64 x 64 fp32 accumulator (this thread's
// columns) into the rows of `base` (row stride N), or added to what is
// there (add); rows at or past `rows` and columns at or past N are left
// alone.  Every old value is read before any store.
__device__ __forceinline__ void put_rows(float* base, const float (&d)[32],
                                         int r0, int fcol, int rows, int N,
                                         bool add) {
  if ((N & 1) == 0) {   // column pairs, 8-byte aligned
    float2 old[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = r0 + 8 * (e & 1), n = 8 * (e >> 1) + fcol;
      old[e] = add && r < rows && n < N
                   ? *reinterpret_cast<const float2*>(
                         base + static_cast<long long>(r) * N + n)
                   : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = r0 + 8 * (e & 1), n = 8 * (e >> 1) + fcol;
      if (r < rows && n < N)
        *reinterpret_cast<float2*>(base + static_cast<long long>(r) * N + n) =
            make_float2(old[e].x + d[2 * e], old[e].y + d[2 * e + 1]);
    }
    return;
  }
  float old[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = r0 + 8 * ((e >> 1) & 1), n = 8 * (e >> 2) + fcol + (e & 1);
    old[e] = add && r < rows && n < N ? base[static_cast<long long>(r) * N + n]
                                      : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = r0 + 8 * ((e >> 1) & 1), n = 8 * (e >> 2) + fcol + (e & 1);
    if (r < rows && n < N)
      base[static_cast<long long>(r) * N + n] = old[e] + d[e];
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// ---------------------------- local states ---------------------------------

struct StateParams {
  const bf16* u;         // x (forward) or dy (backward): (b, L, H, P)
  const float* a;        // (b, L, H)
  const bf16* v;         // B (forward) or C (backward): (b, L, N)
  float* states;         // (b, nc, H, P, N)
  float* totals;         // (b, nc, H): cum at each chunk's last row
  int L, H, P, N, chunk, vec_u, vec_v;
};

// One warpgroup per (chunk, batch, head): the chunk's local state
//   forward  (BWD 0): S[p][n] = sum_s exp(T - cum_s) x[s][p] B[s][n]
//   backward (BWD 1): D[p][n] = sum_l exp(cum_l) dy[l][p] C[l][n]
// and its decay total T.  The weighted rows, fp32, are split into
// SPLIT_PARTS bf16 slabs, each an M-major A against the B (C) slab as
// MN-major B, PASS_TILES row tiles at a time.
template <int BWD>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_state_kernel(const StateParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* V = align1024(smem_raw);
  unsigned char* U = V + SLAB;                      // SPLIT_PARTS pass slabs
  float* cum = reinterpret_cast<float*>(U + SPLIT_PARTS * PASS_BYTES);
  float* pre = cum + kMaxChunk;
  float* red = pre + STATE_THREADS;
  // the fold kernel may start its prologue now (it waits for this grid
  // before it reads a state)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int ci = blockIdx.x, bi = blockIdx.y, hi = blockIdx.z;
  const int nc = p.L / p.chunk, tiles = (p.chunk + ROWS - 1) / ROWS;
  const long long t0 =
      static_cast<long long>(bi) * p.L + static_cast<long long>(ci) * p.chunk;
  const long long ldu = static_cast<long long>(p.H) * p.P;
  load_slab(V, p.v + t0 * p.N, p.N, p.chunk, p.N, tiles, p.vec_v, tid,
            STATE_THREADS);
  cp_async_commit();
  // cum over the chunk, thread t owning rows 2t and 2t + 1
  const int r0 = 2 * tid;
  const float a0 = r0 < p.chunk ? p.a[(t0 + r0) * p.H + hi] : 0.f;
  const float a1 = r0 + 1 < p.chunk ? p.a[(t0 + r0 + 1) * p.H + hi] : 0.f;
  pre[tid] = block_scan(a0 + a1, red);
  __syncthreads();
  const float c0 = (tid ? pre[tid - 1] : 0.f) + a0;
  cum[r0] = c0;
  cum[r0 + 1] = c0 + a1;
  __syncthreads();
  const float T = cum[p.chunk - 1];
  if (tid == 0)
    p.totals[(static_cast<long long>(bi) * nc + ci) * p.H + hi] = T;
  // S[m][n] = sum_r U[r][m] V[r][n], U the weighted rows split into
  // SPLIT_PARTS terms, built PASS_TILES row tiles at a time (each
  // thread's eight 16-byte loads of a pass in flight together)
  const bf16* ub = p.u + t0 * ldu + static_cast<long long>(hi) * p.P;
  constexpr int BATCH = PASS_TILES * ROWS * 8 / STATE_THREADS;
  float acc[32];
  zero32(acc);
  for (int tp = 0; tp < tiles; tp += PASS_TILES) {
    const int nt = min(PASS_TILES, tiles - tp);
    if (tp > 0) __syncthreads();   // the last pass's products are done
    uint4 raw[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int q = u * STATE_THREADS + tid, r = tp * ROWS + (q >> 3);
      raw[u] = q < nt * ROWS * 8 && r < p.chunk
                   ? load8(ub + r * ldu + (q & 7) * 8, p.P - (q & 7) * 8,
                           p.vec_u)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int q = u * STATE_THREADS + tid;
      if (q >= nt * ROWS * 8) continue;
      const int r = tp * ROWS + (q >> 3), c8 = (q & 7) * 8;
      const float w = BWD ? expf(cum[r]) : expf(T - cum[r]);
      const uint32_t wd[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      uint32_t part[4][SPLIT_PARTS];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&wd[e]));
        split_pair(w * v.x, w * v.y, part[e]);
      }
      const uint32_t off = sw_off(q >> 3, c8);
#pragma unroll
      for (int j = 0; j < SPLIT_PARTS; ++j)
        *reinterpret_cast<uint4*>(U + j * PASS_BYTES + off) =
            make_uint4(part[0][j], part[1][j], part[2][j], part[3][j]);
    }
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      uint64_t du[SPLIT_PARTS][4], dv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dv[k] = dm(V, tp + t, k);
#pragma unroll
        for (int j = 0; j < SPLIT_PARTS; ++j)
          du[j][k] = dm(U + j * PASS_BYTES, t, k);
      }
      // the tile's sum in its own accumulator, smallest terms first, then
      // added in fp32: the tensor cores' accumulation truncates, and a
      // chain of a whole chunk into one accumulator drifts (a quarter of
      // h_final's error at the training shape, measured with three parts)
      float part[32];
      zero32(part);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = SPLIT_PARTS - 1; j >= 0; --j) mma4<1, 1>(part, du[j], dv, 0);
      retire(part);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += part[e];
    }
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int row = 16 * warp + (lane >> 2), col = 2 * (lane & 3);
  float* out = p.states + ((static_cast<long long>(bi) * nc + ci) * p.H + hi) *
                              p.P * p.N;
  put_rows(out, acc, row, col, p.P, p.N, false);
}

// Thread tid's 16 elements of a (P, N) state in the 64 x 64 tile: pairs
// (r, c), (r, c + 1) at e = 2 (tid + 256 q), r = e / 64, c = e % 64.
struct StatePairs {
  int idx[8];            // r * N + c
  unsigned ok;           // bit 2q: (r, c) inside (P, N); bit 2q + 1: (r, c+1)
};

__device__ __forceinline__ StatePairs state_pairs(int tid, int P, int N) {
  StatePairs s;
  s.ok = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int e = 2 * (tid + NT2 * q), r = e >> 6, c = e & 63;
    s.idx[q] = r * N + c;
    if (r < P && c < N) s.ok |= 1u << (2 * q);
    if (r < P && c + 1 < N) s.ok |= 1u << (2 * q + 1);
  }
  return s;
}

__device__ __forceinline__ void load_state(float (&v)[16], const float* src,
                                           const StatePairs& s) {
#pragma unroll
  for (int q = 0; q < 16; ++q)
    v[q] = (s.ok >> q) & 1u ? src[s.idx[q >> 1] + (q & 1)] : 0.f;
}

// the state, split into SPLIT_PARTS bf16 terms, into as many swizzled
// 64 x 64 tiles from `tiles` on (rows p, columns n; zeros outside (P, N))
__device__ __forceinline__ void split_state(unsigned char* tiles,
                                            const float (&v)[16], int tid) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int e = 2 * (tid + NT2 * q), r = e >> 6, c = e & 63;
    uint32_t part[SPLIT_PARTS];
    split_pair(v[2 * q], v[2 * q + 1], part);
#pragma unroll
    for (int j = 0; j < SPLIT_PARTS; ++j)
      *reinterpret_cast<uint32_t*>(tiles + j * TILE_BYTES + sw_off(r, c)) =
          part[j];
  }
}

// -------------------------------- fold -------------------------------------

struct FoldParams {
  const float* states;   // (b, nc, H, P N): S (forward) or D (backward)
  const float* totals;   // (b, nc, H)
  const float* init;     // backward: dh_final (b, H, P N); forward: null
  float* seq;            // (b, nc, H, P N): forward h_prev (the state
                         // entering each chunk); backward dh (the gradient
                         // of the state leaving each chunk)
  float* last;           // forward: h_final (b, H, P N)
  int nc, H, PN;
};

constexpr int FOLD_THREADS = 256;

// The states across the chunks, one thread per four elements of one
// (batch, head), in the order of the TPU kernel and the plain version:
//   forward:  h_prev[0] = 0, h_prev[k + 1] = exp(T_k) h_prev[k] + S_k,
//             h_final = exp(T_last) h_prev[last] + S_last
//   backward: dh[nc - 1] = dh_final, dh[k - 1] = exp(T_k) dh[k] + D_k.
template <int BWD>
__global__ void __launch_bounds__(FOLD_THREADS)
ssd_fold_kernel(const FoldParams p) {
  // the output kernel may start its prologue now (it waits for this grid
  // before it reads a folded state)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // launched early (programmatic dependent launch): the local states are
  // complete and visible past this wait
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int bh = blockIdx.y, bi = bh / p.H, h = bh % p.H;
  const int e = 4 * (blockIdx.x * FOLD_THREADS + threadIdx.x);
  if (e >= p.PN) return;
  const int cnt = min(4, p.PN - e);
  const float* __restrict__ S = p.states;
  const float* __restrict__ T = p.totals;
  float* __restrict__ out = p.seq;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (BWD) {
    const float* src = p.init + static_cast<long long>(bh) * p.PN + e;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt) v[q] = src[q];
  }
#pragma unroll 4
  for (int i = 0; i < p.nc; ++i) {
    const int k = BWD ? p.nc - 1 - i : i;
    const long long row = (static_cast<long long>(bi) * p.nc + k) * p.H + h;
    float* dst = out + row * p.PN + e;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt) dst[q] = v[q];
    if (BWD && i + 1 == p.nc) break;   // dL/dh0 is not an output
    const float eT = expf(T[row]);
    const float* src = S + row * p.PN + e;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt) v[q] = fmaf(v[q], eT, src[q]);
  }
  if (!BWD) {
    float* dst = p.last + static_cast<long long>(bh) * p.PN + e;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt) dst[q] = v[q];
  }
}

// ------------------------------- forward -----------------------------------

struct OutParams {
  const bf16 *x, *B, *C;
  const float* a;
  const float* hprev;    // (b, nc, H, P, N): ssd_fold_kernel<0>
  bf16* y;
  int L, H, P, N, chunk, group, vec_x, vec_bc;
};

// The intra-chunk term of l tile lt: y = ((C B^T) o L) x over the s
// tiles up to lt, from this head's cum (cg) and x slab (xg).
__device__ __forceinline__ void out_diag(float (&y)[32], int lt,
                                         const unsigned char* Cs,
                                         const unsigned char* Bs,
                                         const unsigned char* xg,
                                         const float* cg, int chunk, int frow,
                                         int fcol) {
  const int r0 = lt * ROWS + frow, r1 = r0 + 8;
  const float c0 = cg[r0], c1 = cg[r1];
  zero32(y);
  for (int st = 0; st <= lt; ++st) {
    float s[32];
    {
      uint64_t dc[4], db[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dc[k] = dk(Cs, lt, k);
        db[k] = dk(Bs, st, k);
      }
      zero32(s);
      hopper::wgmma_fence();
      mma4<0>(s, dc, db, 1);
      retire(s);
    }
    // P = (C B^T) o L, L only where s <= l < chunk
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = st * ROWS + 8 * j + fcol + cc;
        const float cs = cg[col];
        s[4 * j + cc] *= (col <= r0 && r0 < chunk)
                             ? hopper::exp2_ftz((c0 - cs) * LOG2E)
                             : 0.f;
        s[4 * j + 2 + cc] *= (col <= r1 && r1 < chunk)
                                 ? hopper::exp2_ftz((c1 - cs) * LOG2E)
                                 : 0.f;
      }
    }
    uint64_t dx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) dx[k] = dm(xg, st, k);
    mma_split(y, s, dx);
  }
}

// y += exp(cum_l) C_l h_prev^T (h_prev as SPLIT_PARTS bf16 tiles from Hs),
// then the l tile's rows of y to yb (row stride ldx)
__device__ __forceinline__ void out_state_store(float (&y)[32], int lt,
                                                const unsigned char* Cs,
                                                const unsigned char* Hs,
                                                const float* cg, int chunk,
                                                int frow, int fcol, bf16* yb,
                                                long long ldx, int P) {
  const int r0 = lt * ROWS + frow, r1 = r0 + 8;
  float z[32];
  {
    uint64_t dc[4], dh[SPLIT_PARTS][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dc[k] = dk(Cs, lt, k);
#pragma unroll
      for (int j = 0; j < SPLIT_PARTS; ++j)
        dh[j][k] = dk(Hs + j * TILE_BYTES, 0, k);
    }
    zero32(z);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = SPLIT_PARTS - 1; j >= 0; --j)
      mma4<0>(z, dc, dh[j], j == SPLIT_PARTS - 1);
    retire(z);
  }
  const float e0 = r0 < chunk ? expf(cg[r0]) : 0.f;
  const float e1 = r1 < chunk ? expf(cg[r1]) : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r1 : r0, n = 8 * j + fcol;
      const float e = i ? e1 : e0;
      const float v0 = fmaf(e, z[4 * j + 2 * i], y[4 * j + 2 * i]);
      const float v1 = fmaf(e, z[4 * j + 2 * i + 1], y[4 * j + 2 * i + 1]);
      if (r >= chunk) continue;
      bf16* yr = yb + r * ldx + n;
      if (n + 1 < P && (P & 1) == 0)
        *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(v0, v1);
      else if (n < P)
        yr[0] = __float2bfloat16(v0);
      if (n + 1 < P && (P & 1)) yr[1] = __float2bfloat16(v1);
    }
  }
}

// One block per (chunk, batch, group of heads): for each head, y =
// ((C B^T) o L) x + e^cum C h_prev^T.  The intra-chunk term needs no
// folded state, so the first head's runs before the wait for the fold
// kernel, and each later head's h_prev loads behind its intra-chunk term.
__global__ void __launch_bounds__(NT2, 1) ssd_out_kernel(const OutParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Cs = align1024(smem_raw);
  unsigned char* Bs = Cs + SLAB;
  unsigned char* Xs = Bs + SLAB;
  unsigned char* Hs = Xs + SLAB;                 // h_prev, SPLIT_PARTS tiles
  unsigned char* X2 = Hs + SPLIT_PARTS * TILE_BYTES;   // the next head's x
  float* cum = reinterpret_cast<float*>(X2 + SLAB);
  float* red = cum + MAX_GROUP * kMaxChunk;

  const int tid = threadIdx.x;
  // warp-uniform as the compiler sees it: a wgmma under a branch it takes
  // for divergent is serialized
  const int warp = __shfl_sync(kFull, tid >> 5, 0), lane = tid & 31;
  const int wg = warp >> 2;
  const int frow = 16 * (warp & 3) + (lane >> 2), fcol = 2 * (lane & 3);
  const int ci = blockIdx.x, bi = blockIdx.y, grp = blockIdx.z;
  const int h0 = grp * p.group, nh = min(p.group, p.H - h0);
  const int nc = p.L / p.chunk, tiles = (p.chunk + ROWS - 1) / ROWS;
  const long long t0 =
      static_cast<long long>(bi) * p.L + static_cast<long long>(ci) * p.chunk;
  const long long ldx = static_cast<long long>(p.H) * p.P;
  const long long sz = static_cast<long long>(p.P) * p.N;
  const float* hp0 =
      p.hprev + (static_cast<long long>(bi) * nc + ci) * p.H * sz;

  load_slab(Cs, p.C + t0 * p.N, p.N, p.chunk, p.N, tiles, p.vec_bc, tid, NT2);
  load_slab(Bs, p.B + t0 * p.N, p.N, p.chunk, p.N, tiles, p.vec_bc, tid, NT2);
  load_slab(Xs, p.x + t0 * ldx + static_cast<long long>(h0) * p.P, ldx,
            p.chunk, p.P, tiles, p.vec_x, tid, NT2);
  cp_async_commit();
  float av[MAX_GROUP];
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g)
    av[g] = g < nh && tid < p.chunk ? p.a[(t0 + tid) * p.H + h0 + g] : 0.f;
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g)
    if (g < nh) cum[g * kMaxChunk + tid] = block_scan(av[g], red);
  const int nown = owned(wg, tiles);
  const int lt0 = own_tile(wg, tiles, 0), lt1 = own_tile(wg, tiles, 1);
  const StatePairs sp = state_pairs(tid, p.P, p.N);

  for (int g = 0; g < nh; ++g) {
    const int h = h0 + g;
    const float* cg = cum + g * kMaxChunk;
    unsigned char* xg = g & 1 ? X2 : Xs;
    __syncthreads();   // the last head's products are done with its x, Hs
    if (g + 1 < nh)    // the next head's x loads behind this head's work
      load_slab(g & 1 ? Xs : X2,
                p.x + t0 * ldx + static_cast<long long>(h + 1) * p.P, ldx,
                p.chunk, p.P, tiles, p.vec_x, tid, NT2);
    cp_async_commit();
    float hv[16];
    if (g > 0) load_state(hv, hp0 + h * sz, sp);   // in flight behind diag
    cp_async_wait_prior();   // this head's x (the next head's may be in flight)
    fence_proxy_async();
    __syncthreads();

    float ya[32], yb[32];
    if (nown > 0) out_diag(ya, lt0, Cs, Bs, xg, cg, p.chunk, frow, fcol);
    if (nown > 1) out_diag(yb, lt1, Cs, Bs, xg, cg, p.chunk, frow, fcol);
    if (g == 0) {
      // launched early (programmatic dependent launch): the folded states
      // are complete and visible past this wait
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      load_state(hv, hp0 + h * sz, sp);
    }
    split_state(Hs, hv, tid);
    fence_proxy_async();
    __syncthreads();
    bf16* yh = p.y + t0 * ldx + static_cast<long long>(h) * p.P;
    if (nown > 0)
      out_state_store(ya, lt0, Cs, Hs, cg, p.chunk, frow, fcol, yh, ldx, p.P);
    if (nown > 1)
      out_state_store(yb, lt1, Cs, Hs, cg, p.chunk, frow, fcol, yh, ldx, p.P);
  }
}

// ------------------------------- backward ----------------------------------

struct BwdParams {
  const bf16 *x, *B, *C, *dy;
  const float* a;
  const float* hprev;    // (b, nc, H, P, N)
  const float* dh;       // (b, nc, H, P, N): ssd_fold_kernel<1>
  bf16* dx;
  float* da;             // (b, L, H)
  float* dBp;            // (b, groups, L, N) per-group partials
  float* dCp;
  int L, H, P, N, chunk, group, vec_x, vec_bc;
};

// One block per (chunk, batch, group of heads): for each head, from h_prev
// and dh (the gradient of the state leaving the chunk), the chunk's dx, da
// and the head's shares of dB and dC, as _ssd_bwd_kernel writes them.
__global__ void __launch_bounds__(NT2, 1)
ssd_bwd_chunk_kernel(const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Cs = align1024(smem_raw);
  unsigned char* Bs = Cs + SLAB;
  unsigned char* Xs = Bs + SLAB;
  unsigned char* Ds = Xs + SLAB;                    // dy
  unsigned char* Hh = Ds + SLAB;                    // h_prev, hi and lo
  unsigned char* Hl = Hh + TILE_BYTES;
  unsigned char* Gh = Hl + TILE_BYTES;              // dh, hi and lo
  unsigned char* Gl = Gh + TILE_BYTES;
  // cumsum(a) over the chunk of every head, then one head's vectors
  float* cum_all = reinterpret_cast<float*>(Gl + TILE_BYTES);
  float* dcr = cum_all + MAX_GROUP * kMaxChunk;   // dcum's row terms
  float* dcc = dcr + kMaxChunk;      // dcum's column terms
  float* sdd = dcc + kMaxChunk;      // exp(T - cum_s) dde_s
  float* red = sdd + kMaxChunk;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(kFull, tid >> 5, 0), lane = tid & 31;
  const int wg = warp >> 2;
  const int frow = 16 * (warp & 3) + (lane >> 2), fcol = 2 * (lane & 3);
  const int ci = blockIdx.x, bi = blockIdx.y, grp = blockIdx.z;
  const int h0 = grp * p.group, nh = min(p.group, p.H - h0);
  const int groups = gridDim.z;
  const int nc = p.L / p.chunk, tiles = (p.chunk + ROWS - 1) / ROWS;
  const long long t0 =
      static_cast<long long>(bi) * p.L + static_cast<long long>(ci) * p.chunk;
  const long long ldx = static_cast<long long>(p.H) * p.P;
  const long long sz = static_cast<long long>(p.P) * p.N;
  const long long part0 =
      ((static_cast<long long>(bi) * groups + grp) * p.L +
       static_cast<long long>(ci) * p.chunk) * p.N;

  load_slab(Cs, p.C + t0 * p.N, p.N, p.chunk, p.N, tiles, p.vec_bc, tid, NT2);
  load_slab(Bs, p.B + t0 * p.N, p.N, p.chunk, p.N, tiles, p.vec_bc, tid, NT2);
  cp_async_commit();
  {
    float av[MAX_GROUP];   // a of every head, read once up front
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      av[g] = g < nh && tid < p.chunk ? p.a[(t0 + tid) * p.H + h0 + g] : 0.f;
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      if (g < nh) cum_all[g * kMaxChunk + tid] = block_scan(av[g], red);
  }
  // launched early (programmatic dependent launch): the folded state
  // gradients are complete and visible past this wait
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int nown = owned(wg, tiles);
  const StatePairs sp = state_pairs(tid, p.P, p.N);

  for (int g = 0; g < nh; ++g) {
    const int h = h0 + g;
    __syncthreads();   // the last head is done with every tile and vector
    const long long xoff = t0 * ldx + static_cast<long long>(h) * p.P;
    load_slab(Xs, p.x + xoff, ldx, p.chunk, p.P, tiles, p.vec_x, tid, NT2);
    load_slab(Ds, p.dy + xoff, ldx, p.chunk, p.P, tiles, p.vec_x, tid, NT2);
    cp_async_commit();
    const float* cum = cum_all + g * kMaxChunk;
    float hdp = 0.f;   // this thread's share of sum(h_prev o dh)
    {
      float hv[16], dv[16];
      const long long row = (static_cast<long long>(bi) * nc + ci) * p.H + h;
      load_state(hv, p.hprev + row * sz, sp);
      load_state(dv, p.dh + row * sz, sp);
#pragma unroll
      for (int q = 0; q < 16; ++q) hdp = fmaf(hv[q], dv[q], hdp);
      split_state(Hh, hv, tid);
      split_state(Gh, dv, tid);
    }
    const float hd = block_sum(hdp, red);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    const float T = cum[p.chunk - 1];

    // ---- by l tile: dC (this head's share) and dcum's row terms
    for (int o = 0; o < nown; ++o) {
      const int lt = own_tile(wg, tiles, o);
      const int r0 = lt * ROWS + frow, r1 = r0 + 8;
      const float c0 = cum[r0], c1 = cum[r1];
      float dC[32];
      zero32(dC);
      float m0 = 0.f, m1 = 0.f;
      for (int st = 0; st <= lt; ++st) {
        float sc[32], gg[32];
        {
          uint64_t d1[4], d2[4], d3[4], d4[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            d1[k] = dk(Cs, lt, k);
            d2[k] = dk(Bs, st, k);
            d3[k] = dk(Ds, lt, k);
            d4[k] = dk(Xs, st, k);
          }
          zero32(sc);
          zero32(gg);
          hopper::wgmma_fence();
          mma4<0>(sc, d1, d2, 1);   // C_l B_s^T
          mma4<0>(gg, d3, d4, 1);   // G = dy_l x_s^T
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
          hopper::fence_regs(gg);
        }
        // gg <- L o G; row sums of (C B^T) o L o G
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = st * ROWS + 8 * j + fcol + cc;
            const float cs = cum[col];
            const float l0 = (col <= r0 && r0 < p.chunk)
                                 ? hopper::exp2_ftz((c0 - cs) * LOG2E)
                                 : 0.f;
            const float l1 = (col <= r1 && r1 < p.chunk)
                                 ? hopper::exp2_ftz((c1 - cs) * LOG2E)
                                 : 0.f;
            const int i0 = 4 * j + cc, i1 = i0 + 2;
            gg[i0] *= l0;
            gg[i1] *= l1;
            m0 = fmaf(sc[i0], gg[i0], m0);
            m1 = fmaf(sc[i1], gg[i1], m1);
          }
        }
        uint64_t db[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) db[k] = dm(Bs, st, k);
        mma_split(dC, gg, db);   // dC += (L o G) B_s
      }
      // the carried state: hC = dy_l h_prev, h_prev as hi + lo
      float hc[32];
      {
        uint64_t d1[4], d2[4], d3[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          d1[k] = dk(Ds, lt, k);
          d2[k] = dm(Hh, 0, k);
          d3[k] = dm(Hl, 0, k);
        }
        zero32(hc);
        hopper::wgmma_fence();
        mma4<1>(hc, d1, d2, 1);
        mma4<1>(hc, d1, d3, 0);
        retire(hc);
      }
      const float e0 = r0 < p.chunk ? expf(c0) : 0.f;
      const float e1 = r1 < p.chunk ? expf(c1) : 0.f;
      float q0 = 0.f, q1 = 0.f;   // sum_n hC[l][n] C[l][n]
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + fcol;
        const float2 v0 = ld_pair(Cs, r0, n), v1 = ld_pair(Cs, r1, n);
        q0 = fmaf(hc[4 * j], v0.x, q0);
        q0 = fmaf(hc[4 * j + 1], v0.y, q0);
        q1 = fmaf(hc[4 * j + 2], v1.x, q1);
        q1 = fmaf(hc[4 * j + 3], v1.y, q1);
        dC[4 * j] = fmaf(e0, hc[4 * j], dC[4 * j]);
        dC[4 * j + 1] = fmaf(e0, hc[4 * j + 1], dC[4 * j + 1]);
        dC[4 * j + 2] = fmaf(e1, hc[4 * j + 2], dC[4 * j + 2]);
        dC[4 * j + 3] = fmaf(e1, hc[4 * j + 3], dC[4 * j + 3]);
      }
      const float t0v = quad_sum(fmaf(e0, q0, m0));
      const float t1v = quad_sum(fmaf(e1, q1, m1));
      if ((lane & 3) == 0) {
        if (r0 < p.chunk) dcr[r0] = t0v;
        if (r1 < p.chunk) dcr[r1] = t1v;
      }
      // this head's share into the group's partial, heads in order
      put_rows(p.dCp + part0, dC, r0, fcol, p.chunk, p.N, g > 0);
    }

    // ---- by s tile: dx, dB (this head's share), dcum's column terms.
    // Two sweeps over the l tiles (dx, then dB) keep one head's product
    // accumulators live at a time: one would serialize the wgmmas for
    // want of registers.
    for (int o = 0; o < nown; ++o) {
      const int st = tiles - 1 - own_tile(wg, tiles, o);
      const int r0 = st * ROWS + frow, r1 = r0 + 8;
      const float c0 = cum[r0], c1 = cum[r1];
      const float de0 = r0 < p.chunk ? expf(T - c0) : 0.f;
      const float de1 = r1 < p.chunk ? expf(T - c1) : 0.f;
      float acc[32];
      zero32(acc);
      float m0 = 0.f, m1 = 0.f;
      for (int lt = st; lt < tiles; ++lt) {
        float sc[32], gg[32];
        {
          uint64_t d1[4], d2[4], d3[4], d4[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            d1[k] = dk(Bs, st, k);
            d2[k] = dk(Cs, lt, k);
            d3[k] = dk(Xs, st, k);
            d4[k] = dk(Ds, lt, k);
          }
          zero32(sc);
          zero32(gg);
          hopper::wgmma_fence();
          mma4<0>(sc, d1, d2, 1);   // (C B^T)^T = B_s C_l^T
          mma4<0>(gg, d3, d4, 1);   // G^T = x_s dy_l^T
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
          hopper::fence_regs(gg);
        }
        // sc <- P^T = (C B^T)^T o L^T; column sums of (C B^T) o L o G
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = lt * ROWS + 8 * j + fcol + cc;
            const float cl = cum[col];
            const bool in = col < p.chunk;
            const int i0 = 4 * j + cc, i1 = i0 + 2;
            sc[i0] *= (r0 <= col && in) ? hopper::exp2_ftz((cl - c0) * LOG2E)
                                        : 0.f;
            sc[i1] *= (r1 <= col && in) ? hopper::exp2_ftz((cl - c1) * LOG2E)
                                        : 0.f;
            m0 = fmaf(sc[i0], gg[i0], m0);
            m1 = fmaf(sc[i1], gg[i1], m1);
          }
        }
        uint64_t dd[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) dd[k] = dm(Ds, lt, k);
        mma_split(acc, sc, dd);  // dx += P^T dy_l
      }
      float w[32];
      {
        // Bdh[s][p] = sum_n B[s][n] dh[p][n]
        uint64_t d1[4], d2[4], d3[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          d1[k] = dk(Bs, st, k);
          d2[k] = dk(Gh, 0, k);
          d3[k] = dk(Gl, 0, k);
        }
        zero32(w);
        hopper::wgmma_fence();
        mma4<0>(w, d1, d2, 1);
        mma4<0>(w, d1, d3, 0);
        retire(w);
      }
      float q0 = 0.f, q1 = 0.f;   // dde = sum_p x[s][p] Bdh[s][p]
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + fcol;
        const float2 v0 = ld_pair(Xs, r0, n), v1 = ld_pair(Xs, r1, n);
        q0 = fmaf(v0.x, w[4 * j], q0);
        q0 = fmaf(v0.y, w[4 * j + 1], q0);
        q1 = fmaf(v1.x, w[4 * j + 2], q1);
        q1 = fmaf(v1.y, w[4 * j + 3], q1);
        acc[4 * j] = fmaf(de0, w[4 * j], acc[4 * j]);
        acc[4 * j + 1] = fmaf(de0, w[4 * j + 1], acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(de1, w[4 * j + 2], acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(de1, w[4 * j + 3], acc[4 * j + 3]);
      }
      q0 = quad_sum(q0);
      q1 = quad_sum(q1);
      m0 = quad_sum(m0);
      m1 = quad_sum(m1);
      if ((lane & 3) == 0) {
        if (r0 < p.chunk) {
          dcc[r0] = -m0 - de0 * q0;
          sdd[r0] = de0 * q0;
        }
        if (r1 < p.chunk) {
          dcc[r1] = -m1 - de1 * q1;
          sdd[r1] = de1 * q1;
        }
      }
      bf16* dxb = p.dx + t0 * ldx + static_cast<long long>(h) * p.P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = i ? r1 : r0, n = 8 * j + fcol;
          if (r >= p.chunk) continue;
          bf16* xr = dxb + r * ldx + n;
          if (n < p.P) xr[0] = __float2bfloat16(acc[4 * j + 2 * i]);
          if (n + 1 < p.P) xr[1] = __float2bfloat16(acc[4 * j + 2 * i + 1]);
        }
      }

      zero32(acc);
      for (int lt = st; lt < tiles; ++lt) {
        float gg[32];
        {
          uint64_t d3[4], d4[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            d3[k] = dk(Xs, st, k);
            d4[k] = dk(Ds, lt, k);
          }
          zero32(gg);
          hopper::wgmma_fence();
          mma4<0>(gg, d3, d4, 1);   // G^T = x_s dy_l^T
          retire(gg);
        }
        // gg <- (L o G)^T
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = lt * ROWS + 8 * j + fcol + cc;
            const float cl = cum[col];
            const bool in = col < p.chunk;
            const int i0 = 4 * j + cc, i1 = i0 + 2;
            gg[i0] *= (r0 <= col && in) ? hopper::exp2_ftz((cl - c0) * LOG2E)
                                        : 0.f;
            gg[i1] *= (r1 <= col && in) ? hopper::exp2_ftz((cl - c1) * LOG2E)
                                        : 0.f;
          }
        }
        uint64_t dc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) dc[k] = dm(Cs, lt, k);
        mma_split(acc, gg, dc);  // dB += (L o G)^T C_l
      }
      {
        // xd[s][n] = sum_p x[s][p] dh[p][n]
        uint64_t d1[4], d2[4], d3[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          d1[k] = dk(Xs, st, k);
          d2[k] = dm(Gh, 0, k);
          d3[k] = dm(Gl, 0, k);
        }
        hopper::wgmma_fence();
        mma4<1>(w, d1, d2, 1);
        mma4<1>(w, d1, d3, 0);
        retire(w);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e)
        acc[e] = fmaf((e >> 1) & 1 ? de1 : de0, w[e], acc[e]);
      put_rows(p.dBp + part0, acc, r0, fcol, p.chunk, p.N, g > 0);
    }
    __syncthreads();
    // the chunk's last row: sum_s exp(T - cum_s) dde_s + e^T sum(h_prev o dh)
    const float last =
        block_sum(tid < p.chunk ? sdd[tid] : 0.f, red) + expf(T) * hd;
    // da[t] = sum_{u >= t} dcum[u]: a prefix sum over the reversed rows
    const int t = p.chunk - 1 - tid;
    float v = 0.f;
    if (tid < p.chunk) v = dcr[t] + dcc[t] + (tid == 0 ? last : 0.f);
    const float r = block_scan(v, red);
    if (tid < p.chunk) p.da[(t0 + t) * p.H + h] = r;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the shared-memory limits, raised once (a launch inside CUDA-graph
// capture then makes no attribute call)
cudaError_t hopper_setup() {
  static cudaError_t done = [] {
    cudaError_t e = allow_smem(ssd_state_kernel<0>, kStateSmem);
    if (e == cudaSuccess) e = allow_smem(ssd_state_kernel<1>, kStateSmem);
    if (e == cudaSuccess) e = allow_smem(ssd_out_kernel, kOutSmem);
    if (e == cudaSuccess) e = allow_smem(ssd_bwd_chunk_kernel, kBwdChunkSmem);
    return e;
  }();
  return done;
}

int rows16(const void* ptr, int cols) {
  return cols == 64 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// A launch as a programmatic dependent of the kernel before it on the
// stream: its blocks start once every block of that kernel has started,
// and wait in the kernel (griddepcontrol.wait) for its results.
template <typename Params>
cudaError_t launch_dependent(void (*kern)(Params), const Params& prm,
                             dim3 grid, int threads, size_t smem_bytes,
                             cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, prm);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the local states (one warpgroup per (chunk, batch, head)), then their
// fold across the chunks as a programmatic dependent
template <int BWD>
cudaError_t launch_states(const StateParams& sp, const FoldParams& fp, int b,
                          cudaStream_t s) {
  const int nc = sp.L / sp.chunk;
  ssd_state_kernel<BWD>
      <<<dim3(nc, b, sp.H), STATE_THREADS, kStateSmem, s>>>(sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per = 4 * FOLD_THREADS;
  return launch_dependent(ssd_fold_kernel<BWD>, fp,
                          dim3((fp.PN + per - 1) / per, b * sp.H),
                          FOLD_THREADS, 0, s);
}

int launch_fwd_hopper(const void* x, const void* a, const void* B,
                      const void* C, void* y, void* hfin, void* hprev,
                      void* states, void* totals, int b, int L, int H, int P,
                      int N, int chunk, int group, cudaStream_t s) {
  if (group < 1 || group > MAX_GROUP || states == nullptr ||
      totals == nullptr || hprev == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = hopper_setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = L / chunk, groups = (H + group - 1) / group;
  const StateParams sp{static_cast<const bf16*>(x),
                       static_cast<const float*>(a),
                       static_cast<const bf16*>(B), static_cast<float*>(states),
                       static_cast<float*>(totals), L, H, P, N, chunk,
                       rows16(x, P), rows16(B, N)};
  const FoldParams fp{static_cast<const float*>(states),
                      static_cast<const float*>(totals), nullptr,
                      static_cast<float*>(hprev), static_cast<float*>(hfin),
                      nc, H, P * N};
  err = launch_states<0>(sp, fp, b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const OutParams op{static_cast<const bf16*>(x), static_cast<const bf16*>(B),
                     static_cast<const bf16*>(C), static_cast<const float*>(a),
                     static_cast<const float*>(hprev), static_cast<bf16*>(y), L,
                     H, P, N, chunk, group, rows16(x, P),
                     rows16(B, N) && rows16(C, N)};
  return static_cast<int>(launch_dependent(
      ssd_out_kernel, op, dim3(nc, b, groups), NT2, kOutSmem, s));
}

int launch_bwd_hopper(const void* x, const void* a, const void* B,
                      const void* C, const void* hprev, const void* dy,
                      const void* dhfin, void* dx, void* da, void* dBp,
                      void* dCp, void* states, void* totals, void* dh, int b,
                      int L, int H, int P, int N, int chunk, int group,
                      cudaStream_t s) {
  if (group < 1 || group > MAX_GROUP || states == nullptr ||
      totals == nullptr || dh == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = hopper_setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = L / chunk, groups = (H + group - 1) / group;
  const StateParams sp{static_cast<const bf16*>(dy),
                       static_cast<const float*>(a),
                       static_cast<const bf16*>(C), static_cast<float*>(states),
                       static_cast<float*>(totals), L, H, P, N, chunk,
                       rows16(dy, P), rows16(C, N)};
  const FoldParams fp{static_cast<const float*>(states),
                      static_cast<const float*>(totals),
                      static_cast<const float*>(dhfin), static_cast<float*>(dh),
                      nullptr, nc, H, P * N};
  err = launch_states<1>(sp, fp, b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdParams bp{static_cast<const bf16*>(x), static_cast<const bf16*>(B),
                     static_cast<const bf16*>(C), static_cast<const bf16*>(dy),
                     static_cast<const float*>(a),
                     static_cast<const float*>(hprev),
                     static_cast<const float*>(dh), static_cast<bf16*>(dx),
                     static_cast<float*>(da), static_cast<float*>(dBp),
                     static_cast<float*>(dCp), L, H, P, N, chunk, group,
                     rows16(x, P) && rows16(dy, P),
                     rows16(B, N) && rows16(C, N)};
  return static_cast<int>(launch_dependent(ssd_bwd_chunk_kernel, bp,
                                           dim3(nc, b, groups), NT2,
                                           kBwdChunkSmem, s));
}

}  // namespace

// dtype: 0 = fp32 x / B / C (and y, dy, dx; the CUDA-core kernels), 1 =
// bf16.  a, h_final, h_prev, dh_final, da and the dB / dC partials are
// fp32.  The bf16 forward runs the Hopper kernels when it saves h_prev
// (training) and the CUDA-core kernel when hprev is null (serving).  states
// and dh (b, nc, h, p, n) and totals (b, nc, h) are fp32 scratch of the
// bf16 path (null for fp32); group is its heads a block (1..4, from
// kernel.py:scan_plan; 1 for fp32), and the dB / dC partials are
// (b, ceil(h / group), l, n).  Each returns cudaGetLastError() after its
// launches (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* B,
                            const void* C, void* y, void* hfin, void* hprev,
                            void* states, void* totals, int b, int L, int H,
                            int P, int N, int chunk, int dtype, int group,
                            void* stream) {
  if (bad_shape(b, L, H, P, N, chunk, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, a, B, C, y, hfin, hprev, b, L, H, P, N,
                             chunk, s);
  if (hprev == nullptr)   // serving: the CUDA-core forward (header)
    return launch_fwd<__nv_bfloat16>(x, a, B, C, y, hfin, nullptr, b, L, H,
                                     P, N, chunk, s);
  return launch_fwd_hopper(x, a, B, C, y, hfin, hprev, states, totals, b, L,
                           H, P, N, chunk, group, s);
}

extern "C" int ssd_scan_bwd(const void* x, const void* a, const void* B,
                            const void* C, const void* hprev, const void* dy,
                            const void* dhfin, void* dx, void* da, void* dBp,
                            void* dCp, void* states, void* totals, void* dh,
                            int b, int L, int H, int P, int N, int chunk,
                            int dtype, int group, void* stream) {
  if (bad_shape(b, L, H, P, N, chunk, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, a, B, C, hprev, dy, dhfin, dx, da, dBp, dCp,
                             b, L, H, P, N, chunk, s);
  return launch_bwd_hopper(x, a, B, C, hprev, dy, dhfin, dx, da, dBp, dCp,
                           states, totals, dh, b, L, H, P, N, chunk, group, s);
}
