// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in and
// bf16 out, fp32 accumulation.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bwd_dkv (_attn_bwd_dkv_kernel) and flash_attention_bwd_dq
// (_attn_bwd_dq_kernel).  Both recompute P = exp(S * scale - lse) from the
// forward's saved per-row logsumexp and use dS = P o (dP - delta) * scale,
// with delta = rowsum(O o dO) computed in fp32 by the wrapper beforehand.
// A pair that is masked (causal, past kv_len, a padding row) gets P exactly
// 0 -- the mask is applied before the exp -- so a row the forward saw with
// no valid key (lse ~ -1e30) contributes 0, never inf.
//
// What bounds them on the H100: at the training shapes (sq = skv = 2048,
// 24/8 heads, d = 128) dK/dV runs four and dQ three 64 x 64 x d products
// per (query tile, key tile) pair against O(S d) bytes, far above the
// card's ~295 FLOP/byte ridge, so the tensor cores bound them.  The design
// feeds them as Hopper allows:
//
// - Every product is a warpgroup MMA (wgmma m64nNk16, bf16 -> fp32) with
//   its accumulator in registers.  S and dP come out of shared-memory
//   operands; P and dS are rounded to bf16 and passed from the accumulator
//   registers straight into the register A operand of the next product
//   (hopper::acc_to_a), so S, P, dP and dS never touch shared memory.
// - One block owns 128 rows (keys for dK/dV, queries for dQ): two consumer
//   warpgroups of 64 rows each, whose two tiles (K and V, or Q and dO) TMA
//   loads once.  A producer warp streams the other pair in tiles of 64 rows
//   (Q and dO for dK/dV; K and V for dQ) through a ring of STAGES
//   shared-memory stages with TMA, fenced by mbarriers, so loads run ahead
//   of the products (for dK/dV its lanes also copy each tile's lse and
//   delta).  setmaxnreg moves the producer warpgroup's registers to the
//   consumers (24 / 240).
// - TMA reads the model's (b, s, h, d) memory through 4-D tensor maps over
//   (d, s, h, b) with the strides given -- no transpose -- as 64-column
//   boxes with the 128-byte swizzle that the wgmma descriptors expect
//   (hopper.cuh); rows past the end read as zeros.
// - Masks only where they cut: a tile wholly masked for a warpgroup is
//   skipped, a tile wholly valid takes an unmasked path, and only diagonal
//   and ragged tiles evaluate the mask per pair.  scale * log2(e) is one
//   multiply and the exp is exp2f.
// - dQ launches its heaviest causal query blocks first.
// - Deterministic: dK and dV sum the kv head's whole GQA group inside the
//   block and dQ is its own kernel; no atomics, so two launches on the same
//   inputs give the same bits.
//
// dK/dV: block (kv head, batch, 128-key block).  For every query head of
// the group and every 64-row query tile that can see the keys:
//   S^T = K Q^T, dP^T = V dO^T          (A = K / V, B = Q / dO, K-major)
//   P^T = exp2(S^T scale log2e - lse log2e),
//   dS^T = P^T o (dP^T - delta) scale
//   dV += P^T dO, dK += dS^T Q          (A from registers, B MN-major)
// dQ: block (query head, batch, 128-query block), over the key tiles up to
// the causal limit:
//   S = Q K^T, dP = dO V^T, P, dS as above, dQ += dS K.
//
// Ragged lengths (sq, skv not multiples of the tiles, kv_len < skv) are
// masked here; rows past sq / skv are never written, and keys that no query
// sees get dK = dV = 0.  The launcher raises the kernel's dynamic
// shared-memory limit once per instantiation (so a launch inside CUDA-graph
// capture makes no attribute call) and passes the tensor maps by value as a
// __grid_constant__ parameter.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int NC = 2;               // consumer warpgroups
constexpr int ROWS = 64;            // rows of one consumer warpgroup
constexpr int OWN = NC * ROWS;      // rows a block owns
constexpr int TILE = 64;            // rows of a streamed tile
constexpr int STAGES = 2;           // depth of the ring
constexpr int NTHREADS = (NC + 1) * 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * NC <= 65536,
              "the register split must fit the SM's register file");

struct Strides {
  long long b, h, s;   // element strides of the batch, head, seq axes
};

// Tensor maps first: each is 64-byte aligned, and the struct is passed by
// value (__grid_constant__) so TMA reads the maps from parameter space.
struct Params {
  CUtensorMap own0, own1;   // dK/dV: K, V; dQ: Q, dO  (boxes of OWN rows)
  CUtensorMap st0, st1;     // dK/dV: Q, dO; dQ: K, V  (boxes of TILE rows)
  const float* lse_ptr;     // (b, h, sq) fp32
  const float* delta_ptr;
  bf16* out0;               // dK/dV: dK; dQ: dQ
  bf16* out1;               // dK/dV: dV
  Strides so0, so1;
  int h, kvh, sq, skv, causal, q_offset, kv_len;
  float scale;
};

// Shared memory, offsets from a 1024-byte aligned base: the two owned
// tiles, the ring's stages (two streamed tiles each; dK/dV also lse and
// delta), then the mbarriers (full[STAGES], empty[STAGES], own).
template <int HD, bool DKV>
struct Layout {
  static constexpr int HALVES = HD / 64;
  static constexpr int OWN_HALF = OWN * 128;
  static constexpr int OWN_TILE = HALVES * OWN_HALF;
  static constexpr int ST_HALF = TILE * 128;
  static constexpr int ST_TILE = HALVES * ST_HALF;
  static constexpr int OWN0 = 0;
  static constexpr int OWN1 = OWN_TILE;
  static constexpr int RING = 2 * OWN_TILE;
  static constexpr int VEC = RING + STAGES * 2 * ST_TILE;
  static constexpr int VEC_STAGE = 2 * TILE * 4;   // lse then delta
  static constexpr int BAR = VEC + (DKV ? STAGES * VEC_STAGE : 0);
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;       // room to align the base
  static constexpr uint32_t STAGE_TX = 2 * ST_TILE;   // TMA bytes a stage
};

__device__ __forceinline__ bool pair_valid(const Params& p, int qi, int kj,
                                           int kv_end) {
  return qi < p.sq && kj < kv_end && (!p.causal || kj <= p.q_offset + qi);
}

// 0: no pair of the 64 x 64 tile (queries q0.., keys k0..) is valid;
// 1: every pair is; 2: the mask must be evaluated per pair.
__device__ __forceinline__ int tile_class(const Params& p, int q0, int k0,
                                          int kv_end) {
  if (q0 >= p.sq || k0 >= kv_end ||
      (p.causal && k0 > p.q_offset + q0 + 63)) {
    return 0;
  }
  if (q0 + 64 <= p.sq && k0 + 64 <= kv_end &&
      (!p.causal || k0 + 63 <= p.q_offset + q0)) {
    return 1;
  }
  return 2;
}

template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2],
                                           bf16* base, const Strides& st,
                                           int row0, int rows, int rw,
                                           int cw) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + rw + 8 * i;
    if (row >= rows) continue;
    bf16* dst = base + row * st.s + cw;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16x2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int HD, bool DKV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_kernel(const __grid_constant__ Params p) {
  using L = Layout<HD, DKV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t own_bar = empty + 8 * STAGES;

  const int head = blockIdx.x;   // dK/dV: kv head; dQ: query head
  const int bi = blockIdx.y;
  // dQ walks its query blocks from the end: the heaviest causal ones
  // launch first (dK/dV's heaviest, the first keys, already do)
  const int blk = DKV ? blockIdx.z : gridDim.z - 1 - blockIdx.z;
  const int r0 = blk * OWN;
  const int group = p.h / p.kvh;
  const int kv_end = min(p.skv, p.kv_len);

  // the streamed tiles: dK/dV, `per` query tiles from t_first for each
  // head of the group; dQ, key tiles up to the causal limit
  int t_first = 0, per = 0, n_tiles;
  if constexpr (DKV) {
    t_first = p.causal ? max(0, r0 - p.q_offset) / TILE : 0;
    per = r0 < kv_end ? max(0, (p.sq + TILE - 1) / TILE - t_first) : 0;
    n_tiles = group * per;
  } else {
    int k_stop = kv_end;
    if (p.causal) k_stop = min(k_stop, p.q_offset + min(r0 + OWN, p.sq));
    n_tiles = k_stop > 0 ? (k_stop + TILE - 1) / TILE : 0;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, DKV ? 33 : 1);   // TMA (+ 32 lanes' vectors)
      mbar_init(empty + 8 * s, NC * 4);   // one arrival per consumer warp
    }
    mbar_init(own_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ------------------------------ producer ------------------------------
    // warp 0 of the last warpgroup: lane 0 issues the TMA loads; for dK/dV
    // every lane also copies two of the tile's lse and delta values (TMA
    // needs 16-byte aligned rows, which (b, h, sq) fp32 rows are not when
    // sq is odd) and arrives on the stage's full barrier
    setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x - NC * 128 < 32) {
      if (lane == 0) {
        mbar_expect_tx(own_bar, 2 * L::OWN_TILE);
        for (int hf = 0; hf < L::HALVES; ++hf) {
          tma_load_4d(base + L::OWN0 + hf * L::OWN_HALF, &p.own0, own_bar,
                      hf * 64, r0, head, bi);
          tma_load_4d(base + L::OWN1 + hf * L::OWN_HALF, &p.own1, own_bar,
                      hf * 64, r0, head, bi);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        int sh, row;
        if constexpr (DKV) {
          sh = head * group + i / per;
          row = (t_first + i % per) * TILE;
        } else {
          sh = head / group;
          row = i * TILE;
        }
        if (lane == 0) {
          const uint32_t st = base + L::RING + s * 2 * L::ST_TILE;
          mbar_expect_tx(full + 8 * s, L::STAGE_TX);
          for (int hf = 0; hf < L::HALVES; ++hf) {
            tma_load_4d(st + hf * L::ST_HALF, &p.st0, full + 8 * s, hf * 64,
                        row, sh, bi);
            tma_load_4d(st + L::ST_TILE + hf * L::ST_HALF, &p.st1,
                        full + 8 * s, hf * 64, row, sh, bi);
          }
        }
        if constexpr (DKV) {
          float* vec =
              reinterpret_cast<float*>(sm + L::VEC + s * L::VEC_STAGE);
          const long long off = ((long long)bi * p.h + sh) * p.sq;
#pragma unroll
          for (int e = lane; e < TILE; e += 32) {
            const bool in = row + e < p.sq;
            vec[e] = in ? p.lse_ptr[off + row + e] : 0.f;
            vec[TILE + e] = in ? p.delta_ptr[off + row + e] : 0.f;
          }
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int rw = 16 * warp + lane / 4;   // this thread's rows: rw, rw + 8
    const int cw = 2 * (lane % 4);         // its columns: 8j + cw (+ 1)
    const int my_r0 = r0 + wg * ROWS;      // first row of this warpgroup
    const float sl2 = p.scale * LOG2E;

    // dQ: lse (as log2) and delta of this thread's two query rows
    float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
    if constexpr (!DKV) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = my_r0 + rw + 8 * i;
        if (qi < p.sq) {
          const long long off = ((long long)bi * p.h + head) * p.sq + qi;
          row_lse[i] = p.lse_ptr[off] * LOG2E;
          row_delta[i] = p.delta_ptr[off];
        }
      }
    }

    float acc_a[HD / 2];   // dK/dV: dV = P^T dO
    float acc_b[HD / 2];   // dK/dV: dK = dS^T Q; dQ: dQ = dS K
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) {
      acc_a[e] = 0.f;
      acc_b[e] = 0.f;
    }
    const uint32_t own0 = base + L::OWN0 + wg * ROWS * 128;
    const uint32_t own1 = base + L::OWN1 + wg * ROWS * 128;
    mbar_wait(own_bar, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const int c0 = DKV ? (t_first + i % per) * TILE : i * TILE;
      const int q0 = DKV ? c0 : my_r0;
      const int k0 = DKV ? my_r0 : c0;
      const int cls = tile_class(p, q0, k0, kv_end);
      if (cls != 0) {
        const uint32_t st0 = base + L::RING + s * 2 * L::ST_TILE;
        const uint32_t st1 = st0 + L::ST_TILE;
        float sacc[32], dpacc[32];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < HD / 16; ++k) {
          wgmma_ss_n64<0>(sacc, desc_kmajor(own0, k, L::OWN_HALF),
                          desc_kmajor(st0, k, L::ST_HALF), k > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int k = 0; k < HD / 16; ++k) {
          wgmma_ss_n64<0>(dpacc, desc_kmajor(own1, k, L::OWN_HALF),
                          desc_kmajor(st1, k, L::ST_HALF), k > 0);
        }
        wgmma_commit();

        // per-column lse and delta (dK/dV: the streamed query tile's)
        const float* vlse =
            reinterpret_cast<const float*>(sm + L::VEC + s * L::VEC_STAGE);
        const float* vdelta = vlse + TILE;
        wgmma_wait<1>();   // S is in
        // P = exp2(S scale log2e - lse log2e), masked to exactly 0
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 cl = make_float2(0.f, 0.f);
          if constexpr (DKV) {
            cl = *reinterpret_cast<const float2*>(vlse + 8 * j + cw);
            cl.x *= LOG2E;
            cl.y *= LOG2E;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ii = e / 2, c = e % 2;
            const float l2 = DKV ? (c ? cl.y : cl.x) : row_lse[ii];
            float pv = exp2f(fmaf(sacc[4 * j + e], sl2, -l2));
            if (cls == 2) {
              const int row = my_r0 + rw + 8 * ii;
              const int col = c0 + 8 * j + cw + c;
              const bool ok = DKV ? pair_valid(p, col, row, kv_end)
                                  : pair_valid(p, row, col, kv_end);
              if (!ok) pv = 0.f;
            }
            sacc[4 * j + e] = pv;
          }
        }
        wgmma_wait<0>();   // dP is in
        // dS = P o (dP - delta) scale
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 cd = make_float2(0.f, 0.f);
          if constexpr (DKV) {
            cd = *reinterpret_cast<const float2*>(vdelta + 8 * j + cw);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ii = e / 2, c = e % 2;
            const float dl = DKV ? (c ? cd.y : cd.x) : row_delta[ii];
            dpacc[4 * j + e] =
                sacc[4 * j + e] * (dpacc[4 * j + e] - dl) * p.scale;
          }
        }
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (DKV) acc_to_a(sacc, k, pa[k]);
          acc_to_a(dpacc, k, dsa[k]);
        }
        wgmma_fence();
        if constexpr (DKV) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {   // dV += P^T dO
            mma_rs<HD>(acc_a, pa[k], desc_mnmajor(st1, k, L::ST_HALF));
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {     // dK += dS^T Q; dQ += dS K
          mma_rs<HD>(acc_b, dsa[k], desc_mnmajor(st0, k, L::ST_HALF));
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    const int rows = DKV ? p.skv : p.sq;
    store_rows<HD>(acc_b, p.out0 + bi * p.so0.b + head * p.so0.h, p.so0,
                   my_r0, rows, rw, cw);
    if constexpr (DKV) {
      store_rows<HD>(acc_a, p.out1 + bi * p.so1.b + head * p.so1.h, p.so1,
                     my_r0, rows, rw, cw);
    }
  }
}

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
  int b, h, kvh, sq, skv, causal, q_offset, kv_len;
  float scale;
};

cudaError_t map_of(CUtensorMap* m, const bf16* t, const Strides& st, int d,
                   int rows, int heads, int b, int box_rows) {
  return map_rows_bf16(m, t, d, rows, heads, b, st.s, st.h, st.b, box_rows);
}

template <int HD, bool DKV>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  using L = Layout<HD, DKV>;
  void (*kernel)(const Params) = flash_bwd_kernel<HD, DKV>;
  // once per instantiation, so a launch inside CUDA-graph capture makes
  // no attribute call
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  Params p;
  cudaError_t err;
  if constexpr (DKV) {
    if ((err = map_of(&p.own0, a.k, a.sk, HD, a.skv, a.kvh, a.b, OWN)) ||
        (err = map_of(&p.own1, a.v, a.sv, HD, a.skv, a.kvh, a.b, OWN)) ||
        (err = map_of(&p.st0, a.q, a.sq_, HD, a.sq, a.h, a.b, TILE)) ||
        (err = map_of(&p.st1, a.dout, a.sdo, HD, a.sq, a.h, a.b, TILE))) {
      return err;
    }
    p.out0 = a.dk;
    p.out1 = a.dv;
    p.so0 = a.sdk;
    p.so1 = a.sdv;
  } else {
    if ((err = map_of(&p.own0, a.q, a.sq_, HD, a.sq, a.h, a.b, OWN)) ||
        (err = map_of(&p.own1, a.dout, a.sdo, HD, a.sq, a.h, a.b, OWN)) ||
        (err = map_of(&p.st0, a.k, a.sk, HD, a.skv, a.kvh, a.b, TILE)) ||
        (err = map_of(&p.st1, a.v, a.sv, HD, a.skv, a.kvh, a.b, TILE))) {
      return err;
    }
    p.out0 = a.dq;
    p.out1 = nullptr;
    p.so0 = a.sdq;
    p.so1 = a.sdq;
  }
  p.lse_ptr = a.lse;
  p.delta_ptr = a.delta;
  p.h = a.h;
  p.kvh = a.kvh;
  p.sq = a.sq;
  p.skv = a.skv;
  p.causal = a.causal;
  p.q_offset = a.q_offset;
  p.kv_len = a.kv_len;
  p.scale = a.scale;
  const int rows = DKV ? a.skv : a.sq;
  dim3 grid(DKV ? a.kvh : a.h, a.b, (rows + OWN - 1) / OWN);
  kernel<<<grid, NTHREADS, L::ALLOC, stream>>>(p);
  return cudaGetLastError();
}

template <bool DKV>
int dispatch(const BwdArgs& a, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.kvh <= 0 || a.h % a.kvh != 0 || a.b <= 0 || a.sq <= 0 ||
      a.skv <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 64:
      return static_cast<int>(launch<64, DKV>(a, s));
    case 128:
      return static_cast<int>(launch<128, DKV>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

BwdArgs args(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, void* dk,
             void* dv, int b, int h, int kvh, int sq, int skv,
             const long long* strides, int causal, int q_offset, int kv_len,
             float scale) {
  return BwdArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                 static_cast<const float*>(lse),
                 static_cast<const float*>(delta), static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 at(strides, 0), at(strides, 1), at(strides, 2),
                 at(strides, 3), at(strides, 4), at(strides, 5),
                 at(strides, 6), b, h, kvh, sq, skv, causal, q_offset,
                 kv_len, scale};
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
  return dispatch<true>(args(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh,
                             sq, skv, strides, causal, q_offset, kv_len,
                             scale),
                        d, stream);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
    int h, int kvh, int sq, int skv, int d, const long long* strides,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
  return dispatch<false>(args(q, k, v, dout, lse, delta, dq, dk, dv, b, h,
                              kvh, sq, skv, strides, causal, q_offset, kv_len,
                              scale),
                         d, stream);
}
