// Tile machinery of the paged chunk-attention kernel
// (paged_chunk_attention.cu) for sm_90a, its one user: the flash forward
// moved to wgmma and TMA (flash_attention_fwd.cu, on hopper.cuh).
//
// One CUDA block owns BQ = 64 query rows and walks the keys in tiles of
// BK = 64.  Four warps split the rows: warp w owns rows 16w..16w+15 and
// does everything for them (S = Q K^T, the online softmax, O += P V)
// without talking to the other warps; only the K/V tile loads are shared
// and fenced with __syncthreads.  The two products run on the tensor
// cores through WMMA (bf16 inputs, fp32 accumulation, 16x16x16
// fragments).  The running max m, normaliser l (fp32, in registers) and
// the output accumulator O (fp32, in shared memory so it can be rescaled
// row by row) follow the flash-attention recurrence.
//
// Masking contract: a score that is not valid gets
// probability exactly 0 after the exp, not only a -1e30 logit, so a row
// that sees no valid key keeps l == 0 and the guarded divide writes an
// exact zero row -- never NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace attn {

using namespace nvcuda;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

// Shared-memory layout for head dim HD.  Row pitches are padded (+8 bf16
// / +4 fp32) against bank conflicts while keeping every 16-row fragment
// start 32-byte aligned, as WMMA requires.
template <int HD>
struct Smem {
  static constexpr int QLD = HD + 8;   // bf16 pitch of Q, K, V tiles
  static constexpr int SLD = BK + 4;   // fp32 pitch of S
  static constexpr int PLD = BK + 8;   // bf16 pitch of P
  static constexpr int OLD = HD + 4;   // fp32 pitch of O
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QLD * 2;
  static constexpr int V_OFF = K_OFF + BK * QLD * 2;
  static constexpr int S_OFF = V_OFF + BK * QLD * 2;
  static constexpr int P_OFF = S_OFF + BQ * SLD * 4;
  static constexpr int O_OFF = P_OFF + BQ * PLD * 2;
  static constexpr int BYTES = O_OFF + BQ * OLD * 4;
  static_assert(K_OFF % 128 == 0 && V_OFF % 128 == 0 && S_OFF % 128 == 0 &&
                    P_OFF % 128 == 0 && O_OFF % 128 == 0,
                "shared buffers must stay 128-byte aligned");
};

template <int HD>
struct Tile {
  __nv_bfloat16* q;
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  float* s;
  __nv_bfloat16* p;
  float* o;

  __device__ explicit Tile(unsigned char* base) {
    using L = Smem<HD>;
    q = reinterpret_cast<__nv_bfloat16*>(base + L::Q_OFF);
    k = reinterpret_cast<__nv_bfloat16*>(base + L::K_OFF);
    v = reinterpret_cast<__nv_bfloat16*>(base + L::V_OFF);
    s = reinterpret_cast<float*>(base + L::S_OFF);
    p = reinterpret_cast<__nv_bfloat16*>(base + L::P_OFF);
    o = reinterpret_cast<float*>(base + L::O_OFF);
  }
};

// 8 contiguous bf16 (16 bytes) from global memory, or zeros when src is
// null.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* src) {
  return src != nullptr ? *reinterpret_cast<const uint4*>(src)
                        : make_uint4(0u, 0u, 0u, 0u);
}

// Copy 8 contiguous bf16 (16 bytes) from global to shared memory, or
// write zeros when src is null.
__device__ __forceinline__ void copy8_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src) {
  *reinterpret_cast<uint4*>(dst) = load8_bf16(src);
}

// Zero this warp's 16 rows of the O accumulator.
template <int HD>
__device__ __forceinline__ void zero_o_rows(float* o, int warp, int lane) {
  using L = Smem<HD>;
  for (int i = lane; i < 16 * HD; i += 32) {
    o[(warp * 16 + i / HD) * L::OLD + (i % HD)] = 0.f;
  }
}

// S[16w.., 0..BK) = Q[16w.., :] K^T for this warp's rows, raw (unscaled).
template <int HD>
__device__ __forceinline__ void warp_scores(
    const Tile<HD>& t, int warp,
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> (&qa)[HD / 16]) {
  using L = Smem<HD>;
#pragma unroll
  for (int nj = 0; nj < BK / 16; ++nj) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // element (kk', n) of K^T is K[n][kk'] -> column-major view of K
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(b, t.k + (nj * 16) * L::QLD + kk * 16, L::QLD);
      wmma::mma_sync(c, qa[kk], b, c);
    }
    wmma::store_matrix_sync(t.s + (warp * 16) * L::SLD + nj * 16, c, L::SLD,
                            wmma::mem_row_major);
  }
}

// Online-softmax update of this warp's rows.  Two lanes share a row
// (lane>>1), each taking half of the BK columns.  valid(r, c) says
// whether row r (block-local) may see key column c of the tile.
// m_i / l_i are the lane's copies of its row's running max / normaliser.
template <int HD, typename Valid>
__device__ __forceinline__ void warp_softmax(const Tile<HD>& t, int warp,
                                             int lane, float scale,
                                             Valid valid, float& m_i,
                                             float& l_i) {
  using L = Smem<HD>;
  const int r = warp * 16 + (lane >> 1);
  const int c0 = (lane & 1) * (BK / 2);
  float* srow = t.s + r * L::SLD;
  float mx = NEG_INF;
  for (int c = c0; c < c0 + BK / 2; ++c) {
    float sc = valid(r, c) ? srow[c] * scale : NEG_INF;
    srow[c] = sc;
    mx = fmaxf(mx, sc);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m_i, mx);
  const float alpha = expf(m_i - m_new);
  float sum = 0.f;
  __nv_bfloat16* prow = t.p + r * L::PLD;
  for (int c = c0; c < c0 + BK / 2; ++c) {
    // mask the probability, not only the logit: an all-masked row has
    // m_new == NEG_INF and exp(0) == 1 would leak mass into it
    float pr = valid(r, c) ? expf(srow[c] - m_new) : 0.f;
    __nv_bfloat16 pb = __float2bfloat16(pr);
    prow[c] = pb;
    sum += __bfloat162float(pb);   // l sums the P that multiplies V
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l_i = l_i * alpha + sum;
  m_i = m_new;
  float* orow = t.o + r * L::OLD;
  const int d0 = (lane & 1) * (HD / 2);
  for (int d = d0; d < d0 + HD / 2; ++d) orow[d] *= alpha;
}

// O[16w.., :] += P[16w.., :] V for this warp's rows.
template <int HD>
__device__ __forceinline__ void warp_pv(const Tile<HD>& t, int warp) {
  using L = Smem<HD>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      pa[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::load_matrix_sync(pa[kk], t.p + (warp * 16) * L::PLD + kk * 16,
                           L::PLD);
  }
#pragma unroll
  for (int nd = 0; nd < HD / 16; ++nd) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    float* optr = t.o + (warp * 16) * L::OLD + nd * 16;
    wmma::load_matrix_sync(c, optr, L::OLD, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, t.v + (kk * 16) * L::QLD + nd * 16, L::QLD);
      wmma::mma_sync(c, pa[kk], b, c);
    }
    wmma::store_matrix_sync(optr, c, L::OLD, wmma::mem_row_major);
  }
}

// Load this warp's Q fragments (rows 16w.., all of HD) from shared memory.
template <int HD>
__device__ __forceinline__ void load_q_frags(
    const Tile<HD>& t, int warp,
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> (&qa)[HD / 16]) {
  using L = Smem<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], t.q + (warp * 16) * L::QLD + kk * 16,
                           L::QLD);
  }
}

// Normalise and write this warp's rows: out_row(r) gives the global
// bf16 row pointer of block-local row r (null: row not written).
// Returns nothing; l == 0 rows come out as exact zeros.
template <int HD, typename OutRow>
__device__ __forceinline__ void warp_write(const Tile<HD>& t, int warp,
                                           int lane, float l_i,
                                           OutRow out_row) {
  using L = Smem<HD>;
  const int r = warp * 16 + (lane >> 1);
  __nv_bfloat16* dst = out_row(r);
  if (dst == nullptr) return;
  const float inv = 1.f / fmaxf(l_i, 1e-30f);
  const float* orow = t.o + r * L::OLD;
  const int d0 = (lane & 1) * (HD / 2);
  for (int d = d0; d < d0 + HD / 2; d += 8) {
    __align__(16) __nv_bfloat16 buf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) buf[e] = __float2bfloat16(orow[d + e] * inv);
    *reinterpret_cast<uint4*>(dst + d) = *reinterpret_cast<const uint4*>(buf);
  }
}

}  // namespace attn
