// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in and
// bf16 out, fp32 accumulation.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bwd_dkv (_attn_bwd_dkv_kernel) and flash_attention_bwd_dq
// (_attn_bwd_dq_kernel).  Both recompute P = exp(S * scale - lse) from the
// forward's saved per-row logsumexp and use dS = P o (dP - delta) * scale,
// with delta = rowsum(O o dO) computed in fp32 by the wrapper beforehand.
// A pair that is masked (causal, past kv_len, a padding row) gets P exactly
// 0 after the exp -- the masking contract of attn_tile.cuh -- so a row the
// forward saw with no valid key (lse ~ -1e30) contributes 0, never inf.
//
// What bounds them on the H100: at the training shapes (sq = skv = 2048,
// 24/8 heads, d = 128) dK/dV runs four and dQ three 64x64xd products per
// (query tile, key tile) pair against O(S d) bytes, far above the card's
// ~295 FLOP/byte ridge, so the tensor cores bound them.  This first version
// runs every product on the tensor cores through WMMA (bf16 inputs, fp32
// accumulation) and keeps S, P, dP, dS and the fp32 accumulators in shared
// memory; it does not use wgmma or TMA yet.
//
// dK/dV: one block per (64-key tile, kv head, batch); 4 warps, warp w owns
// key rows 16w..16w+15 and holds their K and V fragments in registers.  The
// block walks every query head of the kv head's GQA group and, for each,
// the 64-row query tiles that can see the key tile (tiles wholly above the
// causal diagonal are skipped):
//   S^T = K Q^T, P^T = exp(S^T scale - lse), dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T o (dP^T - delta) scale, dK += dS^T Q.
// The group sum stays inside the block, as in the TPU kernel: no atomics,
// so dK and dV are deterministic.
//
// dQ: one block per (64-query tile, query head, batch); warp w owns query
// rows 16w..16w+15 and holds their Q and dO fragments in registers.  The
// block walks the key tiles up to the causal limit:
//   S = Q K^T, P = exp(S scale - lse), dP = dO V^T,
//   dS = P o (dP - delta) scale, dQ += dS K.
//
// P and dS are rounded to bf16 before their tensor-core products (dS is
// formed from the fp32 P).  Ragged lengths (sq, skv not multiples of 64,
// kv_len < skv) are masked here; rows past sq / skv are loaded as zeros and
// never written.  Tensors are addressed through (batch, head, seq) strides
// with a contiguous head dim, so the model's (b, s, h, d) memory is read
// and the gradients written in that layout without a transpose.  Shared
// memory is far above 48 KB (about 187 KB for dK/dV at d = 128), so the
// launcher raises the kernel's dynamic limit once per instantiation.
#include "attn_tile.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

static_assert(BQ == BK, "the backward tiles rows and columns alike");
constexpr int T = BK;   // rows and columns of every tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragBcol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::col_major>;
using FragBrow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Shared-memory layout for head dim HD and NACC fp32 accumulators of
// T x HD.  Pitches are padded as in attn_tile.cuh (every 16-row fragment
// start stays 32-byte aligned).
template <int HD, int NACC>
struct BwdSmem {
  static constexpr int QLD = HD + 8;   // bf16 pitch of the four tiles
  static constexpr int SLD = T + 4;    // fp32 pitch of S and dP
  static constexpr int PLD = T + 8;    // bf16 pitch of P and dS
  static constexpr int ALD = HD + 4;   // fp32 pitch of the accumulators
  static constexpr int TILE = T * QLD * 2;
  static constexpr int T0 = 0;
  static constexpr int T1 = T0 + TILE;
  static constexpr int T2 = T1 + TILE;
  static constexpr int T3 = T2 + TILE;
  static constexpr int S_OFF = T3 + TILE;
  static constexpr int DP_OFF = S_OFF + T * SLD * 4;
  static constexpr int P_OFF = DP_OFF + T * SLD * 4;
  static constexpr int DS_OFF = P_OFF + T * PLD * 2;
  static constexpr int ACC_OFF = DS_OFF + T * PLD * 2;
  static constexpr int VEC_OFF = ACC_OFF + NACC * T * ALD * 4;
  static constexpr int BYTES = VEC_OFF + 2 * T * 4;
  static_assert(TILE % 128 == 0 && S_OFF % 128 == 0 && DP_OFF % 128 == 0 &&
                    P_OFF % 128 == 0 && DS_OFF % 128 == 0 &&
                    ACC_OFF % 128 == 0 && VEC_OFF % 128 == 0,
                "shared buffers must stay 128-byte aligned");
};

struct Strides {
  long long b, h, s;   // element strides of the batch, head, seq axes
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;     // (b, h, sq) contiguous
  const float* delta;   // (b, h, sq) contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq_, sk, sv, sdo, sdq, sdk, sdv;
  int h, kvh, sq, skv, causal, q_offset, kv_len;
  float scale;
};

// Rows row0.. of a (rows, HD) bf16 matrix -> a T x HD tile in shared
// memory; rows at or past `rows` are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int rows, int tid) {
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int LD = HD + 8;
  for (int i = tid; i < T * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = row0 + r;
    copy8_bf16(dst + r * LD + c, row < rows ? src + row * stride + c
                                            : nullptr);
  }
}

// A T x HD fp32 accumulator -> rows row0.. of a bf16 matrix (rows at or
// past `rows` are not written).
template <int HD>
__device__ __forceinline__ void store_rows(const float* acc, bf16* dst,
                                           long long stride, int row0,
                                           int rows, int tid) {
  constexpr int CH = HD / 8;
  constexpr int ALD = HD + 4;
  for (int i = tid; i < T * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = row0 + r;
    if (row >= rows) continue;
    __align__(16) bf16 buf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      buf[e] = __float2bfloat16(acc[r * ALD + c + e]);
    }
    *reinterpret_cast<uint4*>(dst + row * stride + c) =
        *reinterpret_cast<const uint4*>(buf);
  }
}

// This warp's 16 rows of A (HD/16 fragments in registers) times B^T, where
// B is a T x HD bf16 tile in shared memory: out[16 x T] fp32 (out already
// points at the warp's first row).
template <int HD>
__device__ __forceinline__ void warp_abt(const FragA (&a)[HD / 16],
                                         const bf16* b, float* out) {
  constexpr int LD = HD + 8;
  constexpr int SLD = T + 4;
#pragma unroll
  for (int nj = 0; nj < T / 16; ++nj) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // element (kk', n) of B^T is B[n][kk'] -> column-major view of B
      FragBcol fb;
      wmma::load_matrix_sync(fb, b + (nj * 16) * LD + kk * 16, LD);
      wmma::mma_sync(c, a[kk], fb, c);
    }
    wmma::store_matrix_sync(out + nj * 16, c, SLD, wmma::mem_row_major);
  }
}

// acc[16 x HD] += A[16 x T] B[T x HD]: A is this warp's 16 rows of a bf16
// T-wide buffer in shared memory, B a T x HD bf16 tile, acc the warp's 16
// rows of an fp32 accumulator in shared memory.
template <int HD>
__device__ __forceinline__ void warp_ab_acc(const bf16* a, const bf16* b,
                                            float* acc) {
  constexpr int LD = HD + 8;
  constexpr int PLD = T + 8;
  constexpr int ALD = HD + 4;
  FragA fa[T / 16];
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
    wmma::load_matrix_sync(fa[kk], a + kk * 16, PLD);
  }
#pragma unroll
  for (int nd = 0; nd < HD / 16; ++nd) {
    FragC c;
    wmma::load_matrix_sync(c, acc + nd * 16, ALD, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      FragBrow fb;
      wmma::load_matrix_sync(fb, b + (kk * 16) * LD + nd * 16, LD);
      wmma::mma_sync(c, fa[kk], fb, c);
    }
    wmma::store_matrix_sync(acc + nd * 16, c, ALD, wmma::mem_row_major);
  }
}

template <int HD>
__device__ __forceinline__ void load_frags(const bf16* tile, int warp,
                                           FragA (&f)[HD / 16]) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(f[kk], tile + (warp * 16) * LD + kk * 16, LD);
  }
}

__device__ __forceinline__ bool pair_valid(const BwdArgs& a, int qi, int kj,
                                           int kv_end) {
  return qi < a.sq && kj < kv_end && (!a.causal || kj <= a.q_offset + qi);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const BwdArgs a) {
  using L = BwdSmem<HD, 2>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::T3);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  float* sDP = reinterpret_cast<float*>(smem + L::DP_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::DS_OFF);
  float* accK = reinterpret_cast<float*>(smem + L::ACC_OFF);
  float* accV = accK + T * L::ALD;
  float* vLse = reinterpret_cast<float*>(smem + L::VEC_OFF);
  float* vDelta = vLse + T;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k0 = blockIdx.x * T;
  const int kvhead = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = a.h / a.kvh;
  const int kv_end = min(a.skv, a.kv_len);

  load_tile<HD>(sK, a.k + bi * a.sk.b + kvhead * a.sk.h, a.sk.s, k0, kv_end,
                tid);
  load_tile<HD>(sV, a.v + bi * a.sv.b + kvhead * a.sv.h, a.sv.s, k0, kv_end,
                tid);
  for (int i = tid; i < 2 * T * L::ALD; i += NTHREADS) accK[i] = 0.f;
  __syncthreads();
  FragA ka[HD / 16], va[HD / 16];
  load_frags<HD>(sK, warp, ka);
  load_frags<HD>(sV, warp, va);

  // the first query row that can see key k0 (causal), rounded to its tile
  const int q_start =
      a.causal ? (max(0, k0 - a.q_offset) / T) * T : 0;
  const int r = warp * 16 + (lane >> 1);   // this lane's key row (half)
  const int kj = k0 + r;
  const int c0 = (lane & 1) * (T / 2);
  float* sw = sS + (warp * 16) * L::SLD;
  float* dpw = sDP + (warp * 16) * L::SLD;
  for (int g = 0; k0 < kv_end && g < group; ++g) {
    const int head = kvhead * group + g;
    const bf16* qb = a.q + bi * a.sq_.b + head * a.sq_.h;
    const bf16* dob = a.dout + bi * a.sdo.b + head * a.sdo.h;
    const long long row_off = ((long long)bi * a.h + head) * a.sq;
    for (int q0 = q_start; q0 < a.sq; q0 += T) {
      __syncthreads();   // every warp is done with the previous Q / dO
      load_tile<HD>(sQ, qb, a.sq_.s, q0, a.sq, tid);
      load_tile<HD>(sDO, dob, a.sdo.s, q0, a.sq, tid);
      if (tid < T) {
        const int qi = q0 + tid;
        vLse[tid] = qi < a.sq ? a.lse[row_off + qi] : 0.f;
        vDelta[tid] = qi < a.sq ? a.delta[row_off + qi] : 0.f;
      }
      __syncthreads();
      warp_abt<HD>(ka, sQ, sw);     // S^T, this warp's key rows
      warp_abt<HD>(va, sDO, dpw);   // dP^T
      __syncwarp();
      for (int c = c0; c < c0 + T / 2; ++c) {
        const bool ok = pair_valid(a, q0 + c, kj, kv_end);
        const float p =
            ok ? expf(sS[r * L::SLD + c] * a.scale - vLse[c]) : 0.f;
        sP[r * L::PLD + c] = __float2bfloat16(p);
        sDS[r * L::PLD + c] = __float2bfloat16(
            p * (sDP[r * L::SLD + c] - vDelta[c]) * a.scale);
      }
      __syncwarp();
      warp_ab_acc<HD>(sP + (warp * 16) * L::PLD, sDO,
                      accV + (warp * 16) * L::ALD);   // dV += P^T dO
      warp_ab_acc<HD>(sDS + (warp * 16) * L::PLD, sQ,
                      accK + (warp * 16) * L::ALD);   // dK += dS^T Q
      __syncwarp();
    }
  }
  __syncthreads();
  store_rows<HD>(accK, a.dk + bi * a.sdk.b + kvhead * a.sdk.h, a.sdk.s, k0,
                 a.skv, tid);
  store_rows<HD>(accV, a.dv + bi * a.sdv.b + kvhead * a.sdv.h, a.sdv.s, k0,
                 a.skv, tid);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const BwdArgs a) {
  using L = BwdSmem<HD, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::T3);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  float* sDP = reinterpret_cast<float*>(smem + L::DP_OFF);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::DS_OFF);
  float* accQ = reinterpret_cast<float*>(smem + L::ACC_OFF);
  float* vLse = reinterpret_cast<float*>(smem + L::VEC_OFF);
  float* vDelta = vLse + T;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * T;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvhead = head / (a.h / a.kvh);
  const int kv_end = min(a.skv, a.kv_len);
  const bf16* kb = a.k + bi * a.sk.b + kvhead * a.sk.h;
  const bf16* vb = a.v + bi * a.sv.b + kvhead * a.sv.h;

  load_tile<HD>(sQ, a.q + bi * a.sq_.b + head * a.sq_.h, a.sq_.s, q0, a.sq,
                tid);
  load_tile<HD>(sDO, a.dout + bi * a.sdo.b + head * a.sdo.h, a.sdo.s, q0,
                a.sq, tid);
  if (tid < T) {
    const int qi = q0 + tid;
    const long long off = ((long long)bi * a.h + head) * a.sq + qi;
    vLse[tid] = qi < a.sq ? a.lse[off] : 0.f;
    vDelta[tid] = qi < a.sq ? a.delta[off] : 0.f;
  }
  for (int i = tid; i < T * L::ALD; i += NTHREADS) accQ[i] = 0.f;
  __syncthreads();
  FragA qa[HD / 16], da[HD / 16];
  load_frags<HD>(sQ, warp, qa);
  load_frags<HD>(sDO, warp, da);

  const int r = warp * 16 + (lane >> 1);   // this lane's query row (half)
  const int qi = q0 + r;
  const float lse_r = vLse[r];
  const float delta_r = vDelta[r];
  const int c0 = (lane & 1) * (T / 2);
  float* sw = sS + (warp * 16) * L::SLD;
  float* dpw = sDP + (warp * 16) * L::SLD;

  // keys that exist: [0, kv_end); causal rows also stop at their position
  int k_stop = kv_end;
  if (a.causal) k_stop = min(k_stop, a.q_offset + min(q0 + T, a.sq));
  for (int k0 = 0; k0 < k_stop; k0 += T) {
    __syncthreads();   // every warp is done with the previous K / V
    load_tile<HD>(sK, kb, a.sk.s, k0, kv_end, tid);
    load_tile<HD>(sV, vb, a.sv.s, k0, kv_end, tid);
    __syncthreads();
    warp_abt<HD>(qa, sK, sw);    // S
    warp_abt<HD>(da, sV, dpw);   // dP
    __syncwarp();
    for (int c = c0; c < c0 + T / 2; ++c) {
      const bool ok = pair_valid(a, qi, k0 + c, kv_end);
      const float p = ok ? expf(sS[r * L::SLD + c] * a.scale - lse_r) : 0.f;
      sDS[r * L::PLD + c] = __float2bfloat16(
          p * (sDP[r * L::SLD + c] - delta_r) * a.scale);
    }
    __syncwarp();
    warp_ab_acc<HD>(sDS + (warp * 16) * L::PLD, sK,
                    accQ + (warp * 16) * L::ALD);   // dQ += dS K
    __syncwarp();
  }
  __syncthreads();
  store_rows<HD>(accQ, a.dq + bi * a.sdq.b + head * a.sdq.h, a.sdq.s, q0,
                 a.sq, tid);
}

template <int HD, bool DKV>
cudaError_t launch(const BwdArgs& a, int b, cudaStream_t stream) {
  constexpr int bytes = DKV ? BwdSmem<HD, 2>::BYTES : BwdSmem<HD, 1>::BYTES;
  void (*kernel)(const BwdArgs) =
      DKV ? flash_bwd_dkv_kernel<HD> : flash_bwd_dq_kernel<HD>;
  // once per instantiation, so a launch inside CUDA-graph capture makes
  // no attribute call
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tiles = DKV ? (a.skv + T - 1) / T : (a.sq + T - 1) / T;
  dim3 grid(tiles, DKV ? a.kvh : a.h, b);
  kernel<<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool DKV>
int dispatch(const BwdArgs& a, int b, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.kvh <= 0 || a.h % a.kvh != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 64:
      return static_cast<int>(launch<64, DKV>(a, b, s));
    case 128:
      return static_cast<int>(launch<128, DKV>(a, b, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

// strides: 21 values, the (batch, head, seq) element strides of q, k, v,
// dout, dq, dk, dv in that order.  flash_attention_bwd_dkv writes dk and dv
// (dq may be null); flash_attention_bwd_dq writes dq (dk, dv may be null).
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
    int h, int kvh, int sq, int skv, int d, const long long* strides,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
  BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<bf16*>(dq), static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), at(strides, 0), at(strides, 1),
            at(strides, 2), at(strides, 3), at(strides, 4), at(strides, 5),
            at(strides, 6), h, kvh, sq, skv, causal, q_offset, kv_len, scale};
  return dispatch<true>(a, b, d, stream);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
    int h, int kvh, int sq, int skv, int d, const long long* strides,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
  BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<bf16*>(dq), static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), at(strides, 0), at(strides, 1),
            at(strides, 2), at(strides, 3), at(strides, 4), at(strides, 5),
            at(strides, 6), h, kvh, sq, skv, causal, q_offset, kv_len, scale};
  return dispatch<false>(a, b, d, stream);
}
