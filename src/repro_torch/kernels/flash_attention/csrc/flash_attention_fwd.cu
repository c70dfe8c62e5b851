// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out, fp32
// accumulation.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_fwd (_attn_fwd_kernel): online-softmax GQA attention
// (the kv head is head / group, read in place, never broadcast), causal
// with an absolute q_offset, kv_len masking of padded keys, and an
// optional per-row logsumexp lse = m + log l, (b, h, sq) fp32, which the
// backward kernels read.
//
// What bounds it on the H100: at the training and prefill shapes
// (sq = skv = 512..2048, d = 64 or 128) the work is 4 d per (query, key)
// pair against (sq + 2 skv) d 2 bytes per head, far above the card's
// ~295 FLOP/byte ridge, so the tensor cores bound it.  The design feeds
// them as Hopper allows (the backward's, flash_attention_bwd.cu):
//
// - Both products are warpgroup MMAs (wgmma, bf16 -> fp32) with their
//   accumulators in registers: S = Q K^T (m64n64k16, Q and K K-major in
//   shared memory), then O += P V (m64n{64,128}k16) with P rounded to
//   bf16 and passed from S's accumulator registers straight into the
//   register A operand (V MN-major).  S, P and O never touch shared
//   memory.
// - The online softmax runs on the accumulator registers.  A row's four
//   lanes (a quad) reduce its max and, at the end, its sum with two
//   shuffles; the running max is kept in raw-score units, scale * log2(e)
//   is one multiply folded into an FMA and the exp is one ex2.approx.  O
//   is rescaled by exp2(m_old - m_new) only in a warp where some row's
//   max moved, and l sums the bf16-rounded P that multiplies V.
// - Within a warpgroup the softmax of key tile j overlaps the product
//   O += P V of tile j - 1: S of tile j is issued before that product, so
//   the tensor cores run one while the warpgroup's threads do the other.
//   P of tile j is packed into the A operand only once that product is
//   done, and every wgmma input is made and fenced before its
//   wgmma_fence: otherwise ptxas serializes every wgmma of the kernel.
// - A work item is 64 * NC query rows of one (query head, batch).  The
//   blocks are persistent, as many as the card holds at once, each
//   walking its share of the items: heaviest (last) causal query blocks
//   first, dealt in waves that alternate direction, so the blocks' loads
//   even out, and the next item's Q load runs under the last item's
//   epilogue.  A block has NC consumer warpgroups of 64 rows and one
//   producer warp, which TMA-loads an item's Q tile once both
//   warpgroups' last S of the previous item is done, then streams K and
//   V in 64-key tiles through a ring of STAGES shared-memory stages
//   fenced by full and empty mbarriers.  setmaxnreg moves the producer
//   warpgroup's registers to the consumers.  NC is 2 (128 rows, K/V
//   shared by two warpgroups) unless 128-row items would not fill the
//   card's SMs once -- a short prefill -- when it is 1 (64-row items, two
//   blocks an SM), which doubles the items.  With NC = 2 the two
//   warpgroups take turns to issue their products (ping-pong on two
//   named barriers), so one's softmax runs under the other's products.
// - TMA reads the caller's memory through 4-D tensor maps over
//   (d, s, h, b) with the strides given, so the model's (b, s, h, d)
//   layout and a contiguous (b, h, s, d) one both need no copy, in
//   64-column boxes with the 128-byte swizzle that the wgmma descriptors
//   expect (hopper.cuh).  Rows past sq or skv read as zeros.
// - Masks only where they cut: key tiles wholly past kv_len are never
//   loaded, a warpgroup skips the key tiles wholly past its causal limit,
//   a wholly valid tile takes an unmasked path, and only diagonal and
//   ragged tiles evaluate the mask per pair.
// - Deterministic: no atomics and no split of the key axis, so two
//   launches on the same inputs give the same bits.
//
// Masking contract (as before): a masked score gets probability exactly
// 0, so a row that sees no valid key keeps l == 0, writes a zero row and
// gets lse = -1e30 + log(1e-30) (== -1e30 in fp32), from which the
// backward forms P = 0.  Rows past sq are never written; o and lse are
// written with plain stores (a TMA box of the (b, h, sq) fp32 lse would
// start only 4-byte aligned when sq is odd).  The launcher raises the
// kernel's dynamic shared-memory limit once per instantiation (so a
// launch inside CUDA-graph capture makes no attribute call) and passes
// the tensor maps by value as a __grid_constant__ parameter.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int ROWS = 64;            // query rows of one consumer warpgroup
constexpr int TILE = 64;            // keys of a streamed K / V tile
constexpr int PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;

// Threads, occupancy, register split and ring depth for NC consumer
// warpgroups.  NC = 1 runs two blocks an SM, so its ring is shallower to
// fit both in shared memory.
template <int NC>
struct Shape {
  static constexpr int OWN = NC * ROWS;             // query rows a block owns
  static constexpr int NTHREADS = (NC + 1) * 128;
  static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : 240;
  static constexpr int STAGES = NC == 1 ? 2 : 3;
  // registers a thread gets at launch under __launch_bounds__
  static constexpr int LAUNCH_REGS =
      (65536 / (NTHREADS * MIN_BLOCKS)) / 8 * 8;
  static_assert((PRODUCER_REGS + NC * CONSUMER_REGS) * 128 <=
                    LAUNCH_REGS * NTHREADS,
                "the register split must fit the block's registers");
};

// Tensor maps first: each is 64-byte aligned, and the struct is passed by
// value (__grid_constant__) so TMA reads the maps from parameter space.
struct Params {
  CUtensorMap q, k, v;      // boxes of OWN rows (q) and TILE rows (k, v)
  bf16* o;                  // (b, sq, h, d) or any strides, head dim unit
  float* lse;               // (b, h, sq) contiguous, or null
  long long o_b, o_h, o_s;  // element strides of o
  int b, h, kvh, sq, skv, causal, q_offset, kv_len;
  float scale;
};

// Shared memory, offsets from a 1024-byte aligned base: the Q tile (one
// box of OWN rows per 64-column half), the ring's stages (a K tile then a
// V tile each), then the mbarriers (full[STAGES], empty[STAGES], q).
template <int HD, int NC>
struct Layout {
  static constexpr int STAGES = Shape<NC>::STAGES;
  static constexpr int HALVES = HD / 64;
  static constexpr int Q_HALF = Shape<NC>::OWN * 128;
  static constexpr int Q_TILE = HALVES * Q_HALF;
  static constexpr int KV_HALF = TILE * 128;
  static constexpr int KV_TILE = HALVES * KV_HALF;
  static constexpr int RING = Q_TILE;
  static constexpr int BAR = RING + STAGES * 2 * KV_TILE;
  static constexpr int BYTES = BAR + (2 * STAGES + 2) * 8;
  static constexpr int ALLOC = BYTES + 1024;       // room to align the base
  static constexpr uint32_t STAGE_TX = 2 * KV_TILE;   // TMA bytes a stage
};

__device__ __forceinline__ bool pair_valid(const Params& p, int qi, int kj,
                                           int kv_end) {
  return qi < p.sq && kj < kv_end && (!p.causal || kj <= p.q_offset + qi);
}

// Whether every pair of the 64 x 64 tile (queries q0.., keys k0..) is
// valid; a tile that is not is masked per pair.
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int k0,
                                          int kv_end) {
  return q0 + ROWS <= p.sq && k0 + TILE <= kv_end &&
         (!p.causal || k0 + TILE - 1 <= p.q_offset + q0);
}

// The online softmax of one key tile's raw scores s (this thread's rows
// rw, rw + 8 of the warpgroup, columns 8j + cw (+ 1)): masks them if the
// tile is not wholly valid, moves the running max m, returns each row's
// rescale factor alpha = exp2((m_old - m_new) scale log2e), leaves
// p = exp2((s - m_new) scale log2e) rounded to bf16 in s (in place: the
// registers of the register A operand of O += P V are packed from it
// only once the previous product is done), and adds the rounded p to
// this thread's share of l (after scaling it by alpha).
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const Params& p, bool full, int qi0, int kj0, int kv_end, float sl2) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!pair_valid(p, qi0 + 8 * (e / 2), kj0 + 8 * j + (e % 2),
                        kv_end)) {
          s[4 * j + e] = -INFINITY;
        }
      }
    }
  }
  float msl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with no valid key so far keeps m == NEG_INF (finite), so a
    // masked score (-inf) gives exp2(-inf) == 0, never exp2(0)
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = exp2_ftz((m[i] - m_new) * sl2);
    m[i] = m_new;
    msl[i] = m_new * sl2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = 4 * j + 2 * i;
      const uint32_t packed =
          pack_bf16x2(exp2_ftz(fmaf(s[e], sl2, -msl[i])),
                      exp2_ftz(fmaf(s[e + 1], sl2, -msl[i])));
      s[e] = __uint_as_float(packed << 16);
      s[e + 1] = __uint_as_float(packed & 0xffff0000u);
      sum[i] += s[e] + s[e + 1];
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

template <int HD, int NC>
__global__ void __launch_bounds__(Shape<NC>::NTHREADS, Shape<NC>::MIN_BLOCKS)
flash_fwd_kernel(const __grid_constant__ Params p) {
  using S = Shape<NC>;
  using L = Layout<HD, NC>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t q_full = empty + 8 * STAGES;
  const uint32_t q_empty = q_full + 8;

  const int kv_end = min(p.skv, p.kv_len);
  // work items (query block, head, batch), heaviest (last) query blocks
  // first; this block's t-th item is its share of wave t, the waves
  // dealt in alternating directions so every block gets heavy and light
  const int nblk = (p.sq + S::OWN - 1) / S::OWN;
  const int hb = p.h * p.b;
  const int items = nblk * hb;
  auto item_of = [&](int t) {
    const int g = gridDim.x, bx = blockIdx.x;
    return t * g + ((t & 1) ? g - 1 - bx : bx);
  };
  struct Item { int r0, head, bi, n_tiles; };
  auto decode = [&](int w) {
    Item it;
    it.r0 = (nblk - 1 - w / hb) * S::OWN;
    it.head = (w % hb) % p.h;
    it.bi = (w % hb) / p.h;
    // key tiles any row of the block may see
    int k_stop = kv_end;
    if (p.causal) {
      k_stop = min(k_stop, p.q_offset + min(it.r0 + S::OWN, p.sq));
    }
    it.n_tiles = k_stop > 0 ? (k_stop + TILE - 1) / TILE : 0;
    return it;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);         // the producer's expect_tx
      mbar_init(empty + 8 * s, NC * 4);   // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC * 4);
    fence_barrier_init();
  }
  __syncthreads();

  // warp-uniform as the compiler sees it (a shuffle from lane 0): wgmma
  // under a branch it takes for divergent is serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NC) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NC * 128) {
      int tile = 0;   // tiles streamed so far, over every item
      for (int t = 0; item_of(t) < items; ++t) {
        const Item it = decode(item_of(t));
        const int kvhead = it.head / (p.h / p.kvh);
        // the Q tile is free once both warpgroups' last S is done
        if (t > 0) mbar_wait(q_empty, (t - 1) & 1);
        mbar_expect_tx(q_full, L::Q_TILE);
        for (int hf = 0; hf < L::HALVES; ++hf) {
          tma_load_4d(base + hf * L::Q_HALF, &p.q, q_full, hf * 64, it.r0,
                      it.head, it.bi);
        }
        for (int i = 0; i < it.n_tiles; ++i, ++tile) {
          const int s = tile % STAGES;
          if (tile >= STAGES) {
            mbar_wait(empty + 8 * s, ((tile / STAGES) - 1) & 1);
          }
          const uint32_t st = base + L::RING + s * 2 * L::KV_TILE;
          mbar_expect_tx(full + 8 * s, L::STAGE_TX);
          for (int hf = 0; hf < L::HALVES; ++hf) {
            tma_load_4d(st + hf * L::KV_HALF, &p.k, full + 8 * s, hf * 64,
                        i * TILE, kvhead, it.bi);
            tma_load_4d(st + L::KV_TILE + hf * L::KV_HALF, &p.v,
                        full + 8 * s, hf * 64, i * TILE, kvhead, it.bi);
          }
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<S::CONSUMER_REGS>();
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int rw = 16 * warp + lane / 4;   // this thread's rows: rw, rw + 8
    const int cw = 2 * (lane % 4);         // its columns: 8j + cw (+ 1)
    const float sl2 = p.scale * LOG2E;
    const uint32_t qt = base + wg * ROWS * 128;

    float o[HD / 2];
    float m[2], l[2], alpha[2] = {1.f, 1.f};
    float sacc[32];
    uint32_t pa[4][4];
    int tile0 = 0;   // the ring position of the item's first key tile
    auto k_tile = [&](int i) {
      return base + L::RING + ((tile0 + i) % STAGES) * 2 * L::KV_TILE;
    };
    auto wait_full = [&](int i) {
      mbar_wait(full + 8 * ((tile0 + i) % STAGES),
                ((tile0 + i) / STAGES) & 1);
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((tile0 + i) % STAGES));
    };
    auto release_q = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    };
    // wgmma descriptors, all computed before the wgmma_fence of the
    // product that reads them: Q's (the same for every key tile), a K
    // tile's and a V tile's
    uint64_t dq[HD / 16], dk[HD / 16], dv[4];
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) dq[k] = desc_kmajor(qt, k, L::Q_HALF);
    auto k_descs = [&](int i) {
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        dk[k] = desc_kmajor(k_tile(i), k, L::KV_HALF);
      }
    };
    auto v_descs = [&](int i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dv[k] = desc_mnmajor(k_tile(i) + L::KV_TILE, k, L::KV_HALF);
      }
    };
    // S = Q K^T of the key tile in dk (async)
    auto issue_scores = [&]() {
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        wgmma_ss_n64<0>(sacc, dq[k], dk[k], k > 0);
      }
      wgmma_commit();
    };
    // O += P V of the key tile in dv, P from pa (async)
    auto issue_pv = [&]() {
#pragma unroll
      for (int k = 0; k < 4; ++k) mma_rs<HD>(o, pa[k], dv[k]);
      wgmma_commit();
    };
    // each product is issued under its own wgmma_fence, with every
    // register it reads made before: ptxas ends a wgmma's pipeline stage
    // at the fence of the next product, so the softmax may then rewrite
    // S's registers while O += P V is still in flight
    auto issue_s = [&](int i) {
      k_descs(i);
      fence_regs(sacc);
      wgmma_fence();
      issue_scores();
    };
    // P of the last softmax (exact in bf16) as the A operand
    auto pack_p = [&]() {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_to_a(sacc, k, pa[k]);
    };
    // O rescaled to the running max of the tile whose P is in pa, then
    // O += P V of that tile (issued)
    auto issue_o = [&](int i) {
      v_descs(i);
      // only where a row's max moved (alpha == 1 exactly otherwise)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j + 0] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
      }
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv();
    };
    // Ping-pong (NC = 2): the two warpgroups take turns to issue their
    // products (named barriers 1 and 2), so one's softmax runs while the
    // other's products hold the tensor cores, rather than both at once.
    // Each takes n_tiles + 1 turns an item (a turn with nothing to issue
    // for a tile past its causal limit); warpgroup 0 goes first.
    auto turn_begin = [&]() {
      if constexpr (NC == 2) named_sync(1 + wg, 256);
    };
    auto turn_end = [&]() {
      if constexpr (NC == 2) named_arrive(2 - wg, 256);
    };
    if constexpr (NC == 2) {
      if (wg == 1) named_arrive(1, 256);
    }

    for (int t = 0; item_of(t) < items; ++t) {
      const Item it = decode(item_of(t));
      const int q0 = it.r0 + wg * ROWS;    // first row of this warpgroup
      // this warpgroup's key tiles, a prefix of the item's: the rest are
      // wholly masked for its rows (it still waits for and releases them)
      int my_stop = 0;
      if (q0 < p.sq) {
        my_stop = kv_end;
        if (p.causal) {
          my_stop = min(my_stop, p.q_offset + min(q0 + ROWS, p.sq));
        }
      }
      const int n_my = my_stop > 0 ? (my_stop + TILE - 1) / TILE : 0;
      auto softmax = [&](int i) {
        const int k0 = i * TILE;
        softmax_tile(sacc, m, l, alpha, p, tile_full(p, q0, k0, kv_end),
                     q0 + rw, k0 + cw, kv_end, sl2);
      };
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
      m[0] = m[1] = NEG_INF;   // running max of the raw scores
      l[0] = l[1] = 0.f;       // this thread's share of l
      mbar_wait(q_full, t & 1);

      if (n_my > 0) {
        wait_full(0);
        turn_begin();
        issue_s(0);
        turn_end();
        wgmma_wait<0>();
        fence_regs(sacc);
        if (n_my == 1) release_q();
        softmax(0);
        pack_p();
        for (int i = 1; i < n_my; ++i) {
          wait_full(i);
          // S of tile i, then O += P V of tile i - 1: the tensor cores run
          // that product while this warpgroup does tile i's softmax
          turn_begin();
          issue_s(i);
          issue_o(i - 1);
          turn_end();
          wgmma_wait<1>();   // S is in
          fence_regs(sacc);
          if (i == n_my - 1) release_q();
          softmax(i);
          wgmma_wait<0>();   // O += P V of tile i - 1 is done
          fence_regs(o);
          fence_regs(pa);
          release(i - 1);
          pack_p();
        }
        turn_begin();
        issue_o(n_my - 1);
        turn_end();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(n_my - 1);
      } else {
        release_q();
      }
      // the item's tiles past this warpgroup's causal limit
      for (int i = n_my; i < it.n_tiles; ++i) {
        wait_full(i);
        release(i);
        turn_begin();
        turn_end();
      }
      // a warpgroup with no tile of its own still owes the item's last turn
      if (it.n_tiles > 0 && n_my == 0) {
        turn_begin();
        turn_end();
      }
      tile0 += it.n_tiles;

      // epilogue: O / l as bf16, lse = m scale + log l
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
      bf16* ob = p.o + it.bi * p.o_b + it.head * p.o_h;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + rw + 8 * i;
        if (qi >= p.sq) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        bf16* dst = ob + qi * p.o_s + cw;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16x2(
              o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
        }
        if (p.lse != nullptr && lane % 4 == 0) {
          p.lse[((long long)it.bi * p.h + it.head) * p.sq + qi] =
              l[i] > 0.f ? m[i] * p.scale + logf(l[i])
                         : NEG_INF + logf(1e-30f);
        }
      }
    }
    // warpgroup 1's last arrival on warpgroup 0's barrier (one more than
    // warpgroup 0's turns) is taken here, so none is left pending
    if constexpr (NC == 2) {
      if (wg == 0) named_sync(1, 256);
    }
  }
}

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const long long* st;   // (batch, head, seq) strides of q, k, v, o
  int b, h, kvh, sq, skv, causal, q_offset, kv_len;
  float scale;
};

template <int HD, int NC>
cudaError_t launch(const FwdArgs& a, int sms, cudaStream_t stream) {
  using S = Shape<NC>;
  using L = Layout<HD, NC>;
  void (*kernel)(const Params) = flash_fwd_kernel<HD, NC>;
  // once per instantiation, so a launch inside CUDA-graph capture makes
  // no attribute call
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long* st = a.st;
  Params p;
  cudaError_t err;
  if ((err = map_rows_bf16(&p.q, a.q, HD, a.sq, a.h, a.b, st[2], st[1],
                           st[0], S::OWN)) ||
      (err = map_rows_bf16(&p.k, a.k, HD, a.skv, a.kvh, a.b, st[5], st[4],
                           st[3], TILE)) ||
      (err = map_rows_bf16(&p.v, a.v, HD, a.skv, a.kvh, a.b, st[8], st[7],
                           st[6], TILE))) {
    return err;
  }
  p.o = static_cast<bf16*>(a.o);
  p.lse = a.lse;
  p.o_b = st[9];
  p.o_h = st[10];
  p.o_s = st[11];
  p.b = a.b;
  p.h = a.h;
  p.kvh = a.kvh;
  p.sq = a.sq;
  p.skv = a.skv;
  p.causal = a.causal;
  p.q_offset = a.q_offset;
  p.kv_len = a.kv_len;
  p.scale = a.scale;
  // persistent blocks: as many as the card holds at once, at most one an
  // item
  const long long items =
      (long long)((a.sq + S::OWN - 1) / S::OWN) * a.h * a.b;
  const long long fit = (long long)sms * S::MIN_BLOCKS;
  kernel<<<(int)(items < fit ? items : fit), S::NTHREADS, L::ALLOC,
           stream>>>(p);
  return cudaGetLastError();
}

// 128-row items (two consumer warpgroups sharing each K/V tile) unless
// there would be fewer of them than SMs -- a short prefill -- then 64-row
// items, twice as many, on blocks that run two an SM.
template <int HD>
cudaError_t dispatch_rows(const FwdArgs& a, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
  }
  const long long blocks =
      (long long)((a.sq + 2 * ROWS - 1) / (2 * ROWS)) * a.h * a.b;
  return blocks < sms ? launch<HD, 1>(a, sms, stream)
                      : launch<HD, 2>(a, sms, stream);
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
  if (kvh <= 0 || h % kvh != 0 || b <= 0 || sq <= 0 || skv <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse), strides, b, h, kvh,
                  sq, skv, causal, q_offset, kv_len, scale};
  switch (d) {
    case 64:
      return static_cast<int>(dispatch_rows<64>(a, s));
    case 128:
      return static_cast<int>(dispatch_rows<128>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
