// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_fwd (_attn_fwd_kernel): online-softmax GQA attention,
// causal with an absolute q_offset, kv_len masking of padded keys, and an
// optional per-row logsumexp (b, h, sq) fp32.
//
// What bounds it on the H100: at the prefill shapes of the serving path
// (sq = skv = 512..2048, h = 24, d = 128) the work is 4*sq*skv*d/2 FLOPs
// per head against (sq + 2 skv) * d * 2 bytes, far above the card's ~295
// FLOP/byte ridge, so the tensor cores bound it.  This first version runs
// both products on the tensor cores through WMMA (mma.sync underneath),
// keeps S, P and O in shared memory and never writes the score matrix to
// device memory.  It does not use wgmma or TMA; that is later work.
//
// Layout: one block per (64-row q tile, query head, batch); 4 warps, each
// owning 16 rows.  The kv head is head / group (GQA), so grouped K/V are
// read in place, never broadcast.  Tensors are addressed through their
// strides (the head dim must be contiguous), so the (b, s, h, d) layout
// of the model is read without a transpose.
#include "attn_tile.cuh"

namespace {

using namespace attn;

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int h, int kvh, int sq, int skv, long long qsb,
                 long long qsh, long long qss, long long ksb, long long ksh,
                 long long kss, long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss, int causal,
                 int q_offset, int kv_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Tile<HD> t(smem_raw);
  using L = Smem<HD>;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvhead = head / (h / kvh);

  const __nv_bfloat16* qb = q + bi * qsb + head * qsh;
  const __nv_bfloat16* kb = k + bi * ksb + kvhead * ksh;
  const __nv_bfloat16* vb = v + bi * vsb + kvhead * vsh;

  // keys that exist: [0, kv_end); causal rows also stop at their position
  const int kv_end = min(skv, kv_len);
  int k_stop = kv_end;
  if (causal) k_stop = min(k_stop, q_offset + min(q0 + BQ, sq));

  // Q tile -> shared (rows past sq are zeros)
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  for (int i = tid; i < BQ * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int qi = q0 + r;
    copy8_bf16(t.q + r * L::QLD + c, qi < sq ? qb + qi * qss + c : nullptr);
  }
  zero_o_rows<HD>(t.o, warp, lane);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[HD / 16];
  load_q_frags<HD>(t, warp, qa);

  float m_i = NEG_INF, l_i = 0.f;
  // K/V tiles are fetched into registers one tile ahead: every global
  // load of tile k+1 is in flight while the warps compute on tile k
  constexpr int LOADS = BK * CH / NTHREADS;   // 16-byte loads per thread
  uint4 kr[LOADS], vr[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * NTHREADS;
      const int kj = k0 + i / CH, c = (i % CH) * 8;
      kr[j] = load8_bf16(kj < kv_end ? kb + kj * kss + c : nullptr);
      vr[j] = load8_bf16(kj < kv_end ? vb + kj * vss + c : nullptr);
    }
  };
  if (k_stop > 0) fetch(0);
  for (int k0 = 0; k0 < k_stop; k0 += BK) {
    __syncthreads();   // every warp is done with the previous K/V tile
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / CH, c = (i % CH) * 8;
      *reinterpret_cast<uint4*>(t.k + r * L::QLD + c) = kr[j];
      *reinterpret_cast<uint4*>(t.v + r * L::QLD + c) = vr[j];
    }
    __syncthreads();
    if (k0 + BK < k_stop) fetch(k0 + BK);

    warp_scores<HD>(t, warp, qa);
    __syncwarp();
    auto valid = [&](int r, int c) {
      const int kj = k0 + c;
      return kj < kv_end && (!causal || kj <= q_offset + q0 + r);
    };
    warp_softmax<HD>(t, warp, lane, scale, valid, m_i, l_i);
    __syncwarp();
    warp_pv<HD>(t, warp);
    __syncwarp();
  }
  __syncwarp();

  auto out_row = [&](int r) -> __nv_bfloat16* {
    const int qi = q0 + r;
    return qi < sq ? o + bi * osb + head * osh + qi * oss : nullptr;
  };
  warp_write<HD>(t, warp, lane, l_i, out_row);
  if (lse != nullptr && (lane & 1) == 0) {
    const int qi = q0 + warp * 16 + (lane >> 1);
    if (qi < sq) {
      lse[((long long)bi * h + head) * sq + qi] =
          m_i + logf(fmaxf(l_i, 1e-30f));
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int h, int kvh, int sq, int skv,
                   const long long* st, int causal, int q_offset,
                   int kv_len, float scale, cudaStream_t stream) {
  const int bytes = Smem<HD>::BYTES;
  // once per instantiation, so a launch inside CUDA-graph capture makes
  // no attribute call
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<HD><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, h, kvh, sq, skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, q_offset, kv_len, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 values, (batch, head, seq) element strides of q, k, v, o.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int h, int kvh, int sq, int skv, int d,
                                   const long long* strides, int causal,
                                   int q_offset, int kv_len, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (h % kvh != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, l, b, h, kvh, sq, skv,
                                         strides, causal, q_offset, kv_len,
                                         scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, l, b, h, kvh, sq, skv,
                                          strides, causal, q_offset, kv_len,
                                          scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
