// Paged chunk attention for Hopper (sm_90a): T >= 1 query tokens per
// sequence against block-paged K/V pools, bf16 queries and output.
//
// Replaces the TPU kernel src/repro/kernels/paged_chunk_attention/
// kernel.py:paged_chunk_attention_kernel (_chunk_kernel).  A row attends
// key positions <= its own; rows at position < 0 come out as exact zeros;
// bf16, float8_e4m3 and int8 pools are read with one fp32 scale per cached
// token (null scales mean 1).  Logical position p of sequence s lives at
// physical block tables[s, p / bs], offset p % bs.
//
// What bounds it on the H100: a decode tick (T = 1, GQA group 3) does
// 4 * 3 * d FLOPs per cached token against 2 * d * 2 bytes of K/V, about
// 3 FLOP/byte, so device-memory bandwidth bounds it: the only lever is to
// read each needed K/V byte once.  The design folds the GQA group into the
// rows (row r = t * group + g is query head kv * group + g of token t), so
// one block reads each K/V tile once for all heads that share it, and it
// stops at the tile holding the block's largest query position.  Keys are
// walked in 64-position tiles addressed per position through the table,
// never per physical block, so a block size of 16 and the dense-cache view
// (one block of the whole capacity S per sequence) take the same path and
// no block has to fit in shared memory.  Quantized pools are dequantized
// to bf16 on the way into shared memory, so device memory sees only the
// narrow bytes.  Both products run on the tensor cores (WMMA); a decode
// tick fills 3 of each 16-row fragment, which costs nothing at this
// arithmetic intensity.
//
// Layout: one block per (64-row tile of the T * group rows, kv head,
// sequence); 4 warps of 16 rows (attn_tile.cuh).
#include <cuda_fp8.h>

#include "attn_tile.cuh"

namespace {

using namespace attn;

enum KvKind { KV_BF16 = 0, KV_E4M3 = 1, KV_INT8 = 2 };

// 8 pool elements as raw bits: 16 bytes of bf16, or 8 bytes of fp8/int8
// (widened into a uint4 so both kinds share one register layout).
template <int KIND>
__device__ __forceinline__ uint4 load_raw8(const void* pool, long long elem) {
  if (KIND == KV_BF16) {
    return *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(pool) + elem);
  }
  const uint2 r = *reinterpret_cast<const uint2*>(
      static_cast<const unsigned char*>(pool) + elem);
  return make_uint4(r.x, r.y, 0u, 0u);
}

// Dequantize 8 raw elements with their token's scale into shared memory.
template <int KIND>
__device__ __forceinline__ void store_kv8(__nv_bfloat16* dst, uint4 raw,
                                          float sc) {
  if (KIND == KV_BF16) {   // bf16 pools carry unit scales: exact copy
    *reinterpret_cast<uint4*>(dst) = raw;
    return;
  }
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&raw);
  __align__(16) __nv_bfloat16 buf[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float f;
    if (KIND == KV_E4M3) {
      __nv_fp8_e4m3 x;
      x.__x = bytes[e];
      f = static_cast<float>(x);
    } else {
      f = static_cast<float>(static_cast<signed char>(bytes[e]));
    }
    buf[e] = __float2bfloat16(f * sc);
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(buf);
}

template <int HD, int KIND>
__global__ void __launch_bounds__(NTHREADS)
paged_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                   const void* __restrict__ k_pool,
                   const void* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ tables,
                   const int* __restrict__ positions,
                   __nv_bfloat16* __restrict__ o, int T, int h, int kvh,
                   int bs, int nbmax, long long qsb, long long qst,
                   long long qsh, long long osb, long long ost,
                   long long osh, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int qpos_s[BQ];
  __shared__ int maxpos_s;
  Tile<HD> t(smem_raw);
  using L = Smem<HD>;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = h / kvh;
  const int R = T * group;
  const int r0 = blockIdx.x * BQ;
  const int kv = blockIdx.y;
  const int si = blockIdx.z;
  const int* table = tables + (long long)si * nbmax;

  // row -> (token, head); rows past R are padding at position -1
  if (tid < BQ) {
    const int r = r0 + tid;
    qpos_s[tid] = r < R ? positions[(long long)si * T + r / group] : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int mp = -1;
    for (int i = 0; i < BQ; ++i) mp = max(mp, qpos_s[i]);
    maxpos_s = mp;
  }
  constexpr int CH = HD / 8;
  for (int i = tid; i < BQ * CH; i += NTHREADS) {
    const int rl = i / CH, c = (i % CH) * 8;
    const int r = r0 + rl;
    const __nv_bfloat16* src = nullptr;
    if (r < R) {
      const int tok = r / group, head = kv * group + r % group;
      src = q + si * qsb + tok * qst + head * qsh + c;
    }
    copy8_bf16(t.q + rl * L::QLD + c, src);
  }
  zero_o_rows<HD>(t.o, warp, lane);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[HD / 16];
  load_q_frags<HD>(t, warp, qa);

  // keys [0, k_end): up to the tile's largest query position, never past
  // the table's capacity
  const int k_end = min(maxpos_s + 1, nbmax * bs);
  float m_i = NEG_INF, l_i = 0.f;
  // K/V tiles are fetched into registers one tile ahead (raw bits and
  // scales): every global load of tile k+1 is in flight while the warps
  // compute on tile k
  constexpr int LOADS = BK * CH / NTHREADS;
  uint4 kr[LOADS], vr[LOADS];
  float ksc[LOADS], vsc[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * NTHREADS;
      const int kp = k0 + i / CH, c = (i % CH) * 8;
      kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      ksc[j] = vsc[j] = 1.f;
      if (kp < k_end) {
        const long long slot = (long long)table[kp / bs] * bs + kp % bs;
        const long long elem = (slot * kvh + kv) * HD + c;
        kr[j] = load_raw8<KIND>(k_pool, elem);
        vr[j] = load_raw8<KIND>(v_pool, elem);
        if (k_scale != nullptr) ksc[j] = k_scale[slot];
        if (v_scale != nullptr) vsc[j] = v_scale[slot];
      }
    }
  };
  if (k_end > 0) fetch(0);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // every warp is done with the previous K/V tile
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * NTHREADS;
      const int rl = i / CH, c = (i % CH) * 8;
      store_kv8<KIND>(t.k + rl * L::QLD + c, kr[j], ksc[j]);
      store_kv8<KIND>(t.v + rl * L::QLD + c, vr[j], vsc[j]);
    }
    __syncthreads();
    if (k0 + BK < k_end) fetch(k0 + BK);

    warp_scores<HD>(t, warp, qa);
    __syncwarp();
    auto valid = [&](int r, int c) {
      const int kp = k0 + c;
      const int qp = qpos_s[r];
      return qp >= 0 && kp <= qp && kp < k_end;
    };
    warp_softmax<HD>(t, warp, lane, scale, valid, m_i, l_i);
    __syncwarp();
    warp_pv<HD>(t, warp);
    __syncwarp();
  }
  __syncwarp();

  auto out_row = [&](int rl) -> __nv_bfloat16* {
    const int r = r0 + rl;
    if (r >= R) return nullptr;
    const int tok = r / group, head = kv * group + r % group;
    return o + si * osb + tok * ost + head * osh;
  };
  warp_write<HD>(t, warp, lane, l_i, out_row);
}

template <int HD, int KIND>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* tables,
                   const int* pos, void* o, int b, int T, int h, int kvh,
                   int bs, int nbmax, const long long* st, float scale,
                   cudaStream_t stream) {
  const int bytes = Smem<HD>::BYTES;
  // once per instantiation, so a launch inside CUDA-graph capture makes
  // no attribute call
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_chunk_kernel<HD, KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int R = T * (h / kvh);
  dim3 grid((R + BQ - 1) / BQ, kvh, b);
  paged_chunk_kernel<HD, KIND><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kp, vp, ks, vs, tables, pos,
      static_cast<__nv_bfloat16*>(o), T, h, kvh, bs, nbmax, st[0], st[1],
      st[2], st[3], st[4], st[5], scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_kind(int kind, const void* q, const void* kp,
                          const void* vp, const float* ks, const float* vs,
                          const int* tables, const int* pos, void* o, int b,
                          int T, int h, int kvh, int bs, int nbmax,
                          const long long* st, float scale,
                          cudaStream_t stream) {
  switch (kind) {
    case KV_BF16:
      return launch<HD, KV_BF16>(q, kp, vp, ks, vs, tables, pos, o, b, T, h,
                                 kvh, bs, nbmax, st, scale, stream);
    case KV_E4M3:
      return launch<HD, KV_E4M3>(q, kp, vp, ks, vs, tables, pos, o, b, T, h,
                                 kvh, bs, nbmax, st, scale, stream);
    case KV_INT8:
      return launch<HD, KV_INT8>(q, kp, vp, ks, vs, tables, pos, o, b, T, h,
                                 kvh, bs, nbmax, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Pools are contiguous (n_blocks, bs, kvh, d); scales contiguous
// (n_blocks, bs) fp32 or null; tables (b, nbmax) and positions (b, T)
// contiguous int32.  strides: 6 values, (batch, token, head) element
// strides of q then o.  kv_kind: 0 bf16, 1 float8_e4m3, 2 int8.
extern "C" int paged_chunk_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale, const void* tables,
                                     const void* positions, void* o, int b,
                                     int T, int h, int kvh, int d, int bs,
                                     int nbmax, int kv_kind,
                                     const long long* strides, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  if (h % kvh != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64:
      return static_cast<int>(dispatch_kind<64>(kv_kind, q, k_pool, v_pool,
                                                ks, vs, tb, ps, o, b, T, h,
                                                kvh, bs, nbmax, strides,
                                                scale, s));
    case 128:
      return static_cast<int>(dispatch_kind<128>(kv_kind, q, k_pool, v_pool,
                                                 ks, vs, tb, ps, o, b, T, h,
                                                 kvh, bs, nbmax, strides,
                                                 scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
