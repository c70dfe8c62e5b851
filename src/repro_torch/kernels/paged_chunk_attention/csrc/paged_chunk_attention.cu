// Paged chunk attention for Hopper (sm_90a): T >= 1 query tokens per
// sequence against block-paged K/V pools, bf16 queries and output.
//
// Replaces the TPU kernel src/repro/kernels/paged_chunk_attention/
// kernel.py:paged_chunk_attention_kernel (_chunk_kernel).  A row attends
// key positions <= its own; rows at position < 0 come out as exact zeros;
// bf16, float8_e4m3 and int8 pools are read with one fp32 scale per cached
// token (null scales mean 1).  Logical position p of sequence s lives at
// physical block tables[s, p / bs], offset p % bs.  Keys past a sequence's
// largest query position are never read.
//
// What bounds it on the H100: a decode tick (T = 1, GQA group 3) does
// 4 * 3 * d FLOPs per cached token against 2 * d * 2 bytes of K/V, about
// 3 FLOP/byte, so device-memory bandwidth bounds it, and the design goal
// is many K/V bytes in flight on every SM:
//
// - The GQA group is folded into the rows (row r = t * group + g is query
//   head kv * group + g of token t), so a block reads each K/V tile once
//   for every head that shares it.  A work item is (row tile, kv head,
//   sequence); a row tile is one warpgroup's 64 rows, or two warpgroups'
//   128 when the rows exceed 64 (a prefill chunk: the two share every K/V
//   tile they load, halving the tile traffic).
// - The key axis is split: each item is cut into n_split ranges of
//   split_keys keys (a multiple of 64), one block each.  The wrapper
//   (kernel.py:split_plan) picks the split from shapes alone -- capacity,
//   block size, batch, kv heads, rows and the SM count -- never from the
//   positions, so a launch needs no device-to-host read and can be
//   captured in a CUDA graph.  A split that starts past its item's largest
//   query position exits at once.  Blocks are dispatched split by split,
//   so every item's first splits, the ones that hold keys, start first.
// - Combine in a fixed order: each split writes its rows' unnormalised O
//   (fp32) and running max m and normaliser l to a workspace; a second
//   small kernel merges, row by row, the splits that hold keys at or
//   before the row's position, in split order: O = sum_s w_s O_s /
//   sum_s w_s l_s with w_s = exp(m_s - max m).  No float atomics and no
//   counters: the output repeats bitwise and no state outlives a call.
//   The combine is launched as a programmatic dependent of the split
//   kernel, so its blocks start and read their positions while the last
//   splits run, and wait in the kernel for the split grid.  The other
//   way, the last split to arrive merging its item through a per-item
//   counter, measured slower on the H100 (every block then pays a
//   device-wide fence and an atomic round trip before it retires).  One
//   split (n_split = 1) writes O / l itself and launches no combine.
// - A row that sees no valid key keeps m = -1e30, l = 0 and O = 0 in its
//   split (masked probabilities are exactly 0, never exp(0)); the combine
//   weighs every split by its l and guards the divide, and a row at
//   position < 0 reads no split: exact zeros, never NaN.
// - Loads: every thread copies its share of a 64-key tile with cp.async
//   (16 bytes a copy), K and V rows addressed through the block's page
//   table, which is read into shared memory once per split (one entry per
//   page, not per element).  A ring of STAGES tiles (3 to 6) keeps
//   STAGES - 1 tiles in flight while one is computed, with one barrier a
//   tile; keys past the split's end are zero-filled, not read.  bf16 tiles
//   land directly in the 128-byte-swizzled layout the wgmma descriptors
//   read (hopper.cuh); fp8 / int8 codes land raw (narrow bytes from device
//   memory) and each thread dequantizes its own rows (code * scale, fp32,
//   rounded to bf16) into one swizzled bf16 K / V pair.
// - Compute: S = Q K^T (wgmma m64n64k16, Q the register A operand, loaded
//   once per block in the accumulator layout) and O += P V
//   (m64n{64,128}k16, P passed from S's registers) with fp32 accumulators
//   and the online softmax in registers, as in flash_attention_fwd.cu.
//   Decode rows (R = T * group <= 16: 3 at a phi4 decode tick, 1 at
//   zamba2's or qwen2-moe's) are padded to the 64-row tile, which costs
//   tensor-core time the memory system hides at ~3 FLOP/byte; but the
//   softmax, issue-bound on 32 scores a thread, is not wasted on them:
//   every warp holds the same 16 rows and takes its own 16 keys of each
//   tile (8 scores a thread), and the four warps' (m, l, O) are merged at
//   the end.  Chunks of up to 64 rows take one warpgroup as they are.
// - Block size 16 and the dense-cache view (one block of the whole
//   capacity per sequence) take the same path: keys are addressed per row
//   through the page table, never per physical block.
#include <cuda_fp8.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int ROWS = 64;          // query rows of one warpgroup
constexpr int TILE = 64;          // keys of a streamed K / V tile
constexpr int MAX_PAGES = 512;    // page-table entries a split may span
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;

enum KvKind { KV_BF16 = 0, KV_E4M3 = 1, KV_INT8 = 2 };

// A block: NC warpgroups of 64 rows each sharing every K / V tile it
// loads (NC = 2 when the rows exceed one warpgroup, halving the tile
// traffic of a prefill chunk), two blocks an SM with NC = 1, one with
// NC = 2 (whose ring is then deeper).
template <int NC>
struct Shape {
  static constexpr int NTHREADS = NC * 128;
  static constexpr int OWN = NC * ROWS;            // query rows of a block
  static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;
  static constexpr int TPR = NTHREADS / TILE;      // threads a key row
};

// Shared memory, offsets from a 1024-byte aligned base: the ring's stages
// (a K tile, a V tile and, for codes, a K and a V scale slot per thread),
// the dequantized bf16 K / V pair (codes only), the split's page table,
// the rows' positions and the warps' largest positions.
template <int HD, int KIND, int NC>
struct Layout {
  static constexpr bool QUANT = KIND != KV_BF16;
  static constexpr int STAGES = NC == 2 ? 6 : (QUANT || HD == 64) ? 4 : 3;
  static constexpr int HALF = TILE * 128;         // 64 rows x 64 bf16
  static constexpr int BF_TILE = (HD / 64) * HALF;
  static constexpr int RAW_TILE = QUANT ? TILE * HD : BF_TILE;
  static constexpr int SCALES = QUANT ? 2 * Shape<NC>::NTHREADS * 4 : 0;
  static constexpr int STAGE = 2 * RAW_TILE + SCALES;
  static constexpr int BF = STAGES * STAGE;
  static constexpr int PAGES = BF + (QUANT ? 2 * BF_TILE : 0);
  static constexpr int POS = PAGES + MAX_PAGES * 4;
  static constexpr int BYTES = POS + (Shape<NC>::OWN + 4 * NC) * 4;
  static constexpr int ALLOC = BYTES + 1024;       // room to align the base
  static_assert(STAGE % 1024 == 0 && BF % 1024 == 0,
                "swizzled tiles must stay 1024-byte aligned");
};

struct Params {
  const bf16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;       // (n_blocks, bs) or null (unit scales)
  const float* v_scale;
  const int* tables;          // (b, nbmax)
  const int* positions;       // (b, T)
  bf16* o;
  float* part;                // split partials (n_split > 1) or null
  long long qsb, qst, qsh, osb, ost, osh;   // element strides of q, o
  int b, T, h, kvh, bs, nbmax, n_split, split_keys;
  float scale;
};

// ------------------------------ cp.async ------------------------------------

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's shared-memory writes (stores, cp.async) made visible to
// the async proxy that wgmma reads its shared operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte bf16 chunk j (columns 8j..8j+7) of row `row` in
// a 128-byte-swizzled tile of 64-column halves.
__device__ __forceinline__ uint32_t swizzled(int row, int j) {
  return (j / 8) * (TILE * 128) + row * 128 + ((j % 8) ^ (row % 8)) * 16;
}

// 16 codes with their token's scale, as 16 bf16 (two 16-byte chunks).
template <int KIND>
__device__ __forceinline__ void dequant16(uint4 raw, float sc, uint4 (&out)[2]) {
  const unsigned char* c = reinterpret_cast<const unsigned char*>(&raw);
  uint32_t* w = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int e = 0; e < 16; e += 2) {
    float f[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (KIND == KV_E4M3) {
        __nv_fp8_e4m3 x;
        x.__x = c[e + i];
        f[i] = static_cast<float>(x);
      } else {
        f[i] = static_cast<float>(static_cast<signed char>(c[e + i]));
      }
    }
    w[e / 2] = pack_bf16x2(f[0] * sc, f[1] * sc);
  }
}

// The online softmax of one key tile's raw scores s over this thread's
// accumulator columns 8j + cw (+ 1), j in [JLO, JHI), of its rows rw, rw +
// 8 (positions pr): a pair is valid when its key (kc + 8j (+ 1)) lies at
// or before the row's position and before the split's end k_hi (a row at
// position < 0 has none), and a masked score gives probability exactly 0.
// Moves the running max m (raw-score units), returns each row's rescale
// factor alpha = exp2((m_old - m_new) sl2), leaves p = exp2((s - m_new)
// sl2) rounded to bf16 in s and adds the rounded p to this thread's share
// of l (after scaling it by alpha).
template <int JLO, int JHI>
__device__ __forceinline__ void softmax_cols(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int kc, const int (&pr)[2],
                                             int k_hi, float sl2) {
#pragma unroll
  for (int j = JLO; j < JHI; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = kc + 8 * j + (e % 2);
      if (!(kp <= pr[e / 2] && kp < k_hi)) s[4 * j + e] = -INFINITY;
    }
  }
  float msl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = JLO; j < JHI; ++j) {
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
  for (int j = JLO; j < JHI; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = 4 * j + 2 * i;
      const uint32_t packed = pack_bf16x2(exp2_ftz(fmaf(s[e], sl2, -msl[i])),
                                          exp2_ftz(fmaf(s[e + 1], sl2, -msl[i])));
      s[e] = __uint_as_float(packed << 16);
      s[e + 1] = __uint_as_float(packed & 0xffff0000u);
      sum[i] += s[e] + s[e + 1];   // l sums the P that multiplies V
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// ------------------------------- the split -----------------------------------

// DEC (decode rows, R <= 16; one warpgroup): every warp holds the same
// 16 rows and takes its own quarter of each key tile, so its softmax
// works on 8 scores a thread, not 32; the warps' (m, l, O) are merged at
// the end.
template <int HD, int KIND, int NC, bool DEC>
__global__ void __launch_bounds__(Shape<NC>::NTHREADS, Shape<NC>::MIN_BLOCKS)
paged_split_kernel(const __grid_constant__ Params p) {
  static_assert(!DEC || NC == 1, "decode rows take one warpgroup");
  using L = Layout<HD, KIND, NC>;
  using SH = Shape<NC>;
  constexpr int STAGES = L::STAGES;
  constexpr int NTHREADS = SH::NTHREADS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);   // the same, generic
  int* page_s = reinterpret_cast<int*>(sbase + L::PAGES);
  int* pos_s = reinterpret_cast<int*>(sbase + L::POS);
  int* wmax_s = pos_s + SH::OWN;

  // the combine may start its prologue now (it waits for this grid to
  // finish before it reads any partial)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  // warp-uniform as the compiler sees it (a shuffle from lane 0): wgmma
  // under a branch it takes for divergent is serialized
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int wg = warp / 4;
  const int split = blockIdx.z;
  const int rb = blockIdx.y * SH::OWN;      // the block's first row
  const int kv = blockIdx.x % p.kvh;
  const int si = blockIdx.x / p.kvh;
  const int group = p.h / p.kvh;
  const int R = p.T * group;
  const int cap = p.nbmax * p.bs;
  const int k_lo = split * p.split_keys;
  const int k_top = min(k_lo + p.split_keys, cap);

  // independent loads first: the rows' positions (rows past R are padding
  // at -1), the split's page-table entries and Q
  int my_pos = -1;
  if (tid < SH::OWN && rb + tid < R) {
    my_pos = p.positions[(long long)si * p.T + (rb + tid) / group];
  }
  if (tid < SH::OWN) pos_s[tid] = my_pos;
  const int p_first = k_lo / p.bs;
  const int n_pages = k_top > k_lo ? (k_top - 1) / p.bs - p_first + 1 : 0;
  const int* table = p.tables + (long long)si * p.nbmax + p_first;
  for (int i = tid; i < n_pages; i += NTHREADS) page_s[i] = table[i];

  // Q as the register A operand of S = Q K^T, in the accumulator layout:
  // this thread's rows rw, rw + 8, columns 16k + cw (+ 1) and + 8
  const int r0 = rb + wg * ROWS;           // this warpgroup's first row
  // this thread's rows rw, rw + 8 of its warpgroup (decode: of the 16)
  const int rw = (DEC ? 0 : 16 * (warp % 4)) + lane / 4;
  const int cw = 2 * (lane % 4);
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rw + 8 * i;
    const bf16* qrow = nullptr;
    if (r < R) {
      qrow = p.q + si * p.qsb + (r / group) * p.qst +
             (kv * group + r % group) * p.qsh;
    }
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      qa[k][i] = qrow != nullptr
                     ? *reinterpret_cast<const uint32_t*>(qrow + 16 * k + cw)
                     : 0u;
      qa[k][2 + i] =
          qrow != nullptr
              ? *reinterpret_cast<const uint32_t*>(qrow + 16 * k + 8 + cw)
              : 0u;
    }
  }
  const int wmax = __reduce_max_sync(0xffffffffu, my_pos);
  if (lane == 0) wmax_s[warp] = wmax;
  __syncthreads();

  // keys [k_lo, k_hi): the split's, up to the item's largest query
  // position, never past the capacity
  int block_max = -1;
#pragma unroll
  for (int w = 0; w < 4 * NC; ++w) block_max = max(block_max, wmax_s[w]);
  const int maxpos = __shfl_sync(0xffffffffu, block_max, 0);
  const int k_end = min(maxpos + 1, cap);
  const int k_hi = min(k_top, k_end);
  // nothing of this split is needed: the combine reads no partial of it
  if (p.n_split > 1 && k_lo >= k_end) return;
  const int n_t = k_hi > k_lo ? (k_hi - k_lo + TILE - 1) / TILE : 0;
  const int pr[2] = {pos_s[wg * ROWS + rw], pos_s[wg * ROWS + rw + 8]};

  // tile t of the split into its ring stage: this thread copies its share
  // (1 / TPR) of key row tid / TPR of K and of V (and, for codes, that
  // row's scales into its own slots)
  const bool has_ks = p.k_scale != nullptr, has_vs = p.v_scale != nullptr;
  auto issue = [&](int t) {
    const uint32_t st = base + (t % STAGES) * L::STAGE;
    const int row = tid / SH::TPR, part = tid % SH::TPR;
    const int kp = k_lo + t * TILE + row;
    const bool ok = kp < k_hi;
    long long slot = 0;
    if (ok) {
      slot = (long long)page_s[kp / p.bs - p_first] * p.bs + kp % p.bs;
    }
    const long long elem = (slot * p.kvh + kv) * HD;
    const int nbytes = ok ? 16 : 0;
    if constexpr (!L::QUANT) {
      const bf16* ks = static_cast<const bf16*>(p.k_pool) + (ok ? elem : 0);
      const bf16* vs = static_cast<const bf16*>(p.v_pool) + (ok ? elem : 0);
      constexpr int CPT = HD / 8 / SH::TPR;   // 16-byte chunks a thread
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = part * CPT + c;
        const uint32_t off = swizzled(row, j);
        cp_async16(st + off, ks + 8 * j, nbytes);
        cp_async16(st + L::RAW_TILE + off, vs + 8 * j, nbytes);
      }
    } else {
      const unsigned char* ks =
          static_cast<const unsigned char*>(p.k_pool) + (ok ? elem : 0);
      const unsigned char* vs =
          static_cast<const unsigned char*>(p.v_pool) + (ok ? elem : 0);
      constexpr int CPT = HD / 16 / SH::TPR;  // 16-byte chunks a thread
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = part * CPT + c;
        cp_async16(st + row * HD + 16 * j, ks + 16 * j, nbytes);
        cp_async16(st + L::RAW_TILE + row * HD + 16 * j, vs + 16 * j, nbytes);
      }
      const uint32_t sc = st + 2 * L::RAW_TILE + tid * 4;
      if (has_ks) cp_async4(sc, p.k_scale + (ok ? slot : 0), ok ? 4 : 0);
      if (has_vs) {
        cp_async4(sc + NTHREADS * 4, p.v_scale + (ok ? slot : 0), ok ? 4 : 0);
      }
    }
  };
  // codes of tile t (this thread's own copies) -> the bf16 K / V pair
  auto dequantize = [&](int t) {
    const unsigned char* st = sbase + (t % STAGES) * L::STAGE;
    const float* sc = reinterpret_cast<const float*>(st + 2 * L::RAW_TILE);
    const float scl[2] = {has_ks ? sc[tid] : 1.f,
                          has_vs ? sc[NTHREADS + tid] : 1.f};
    const int row = tid / SH::TPR, part = tid % SH::TPR;
    constexpr int CPT = HD / 16 / SH::TPR;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = part * CPT + c;
        const uint4 codes = *reinterpret_cast<const uint4*>(
            st + x * L::RAW_TILE + row * HD + 16 * j);
        uint4 bf[2];
        dequant16<KIND>(codes, scl[x], bf);
        unsigned char* dst = sbase + L::BF + x * L::BF_TILE;
        *reinterpret_cast<uint4*>(dst + swizzled(row, 2 * j)) = bf[0];
        *reinterpret_cast<uint4*>(dst + swizzled(row, 2 * j + 1)) = bf[1];
      }
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_t) issue(t);
    cp_async_commit();
  }

  const float sl2 = p.scale * LOG2E;
  float o[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // running max of the raw scores
  float l[2] = {0.f, 0.f};           // this thread's share of l
  float sacc[32];
  uint32_t pa[4][4];
  uint64_t dk[HD / 16], dv[4];
  fence_regs(qa);

  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<STAGES - 2>();     // this thread's copies of tile t
    uint32_t kt = base + (t % STAGES) * L::STAGE;
    if constexpr (L::QUANT) {
      __syncthreads();               // every warp's products of t - 1 done
      dequantize(t);
      kt = base + L::BF;
    }
    const uint32_t vt = kt + (L::QUANT ? L::BF_TILE : L::RAW_TILE);
    fence_proxy_async();
    __syncthreads();                 // tile t in; the stage of t - 1 free
    if (t + STAGES - 1 < n_t) issue(t + STAGES - 1);
    cp_async_commit();

    // S = Q K^T
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) dk[k] = desc_kmajor(kt, k, L::HALF);
#pragma unroll
    for (int k = 0; k < 4; ++k) dv[k] = desc_mnmajor(vt, k, L::HALF);
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) wgmma_rs_n64<0>(sacc, qa[k], dk[k], k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // the online softmax (decode: each warp over its own 16 keys)
    const int kc = k_lo + t * TILE + cw;
    float alpha[2];
    if constexpr (DEC) {
      switch (warp) {
        case 0: softmax_cols<0, 2>(sacc, m, l, alpha, kc, pr, k_hi, sl2); break;
        case 1: softmax_cols<2, 4>(sacc, m, l, alpha, kc, pr, k_hi, sl2); break;
        case 2: softmax_cols<4, 6>(sacc, m, l, alpha, kc, pr, k_hi, sl2); break;
        default: softmax_cols<6, 8>(sacc, m, l, alpha, kc, pr, k_hi, sl2);
      }
    } else {
      softmax_cols<0, 8>(sacc, m, l, alpha, kc, pr, k_hi, sl2);
    }
    // O rescaled only where a row's max moved (alpha == 1 exactly else)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    if constexpr (DEC) {   // P is zero outside the warp's own 16 keys
#pragma unroll
      for (int k = 0; k < 4; ++k) pa[k][0] = pa[k][1] = pa[k][2] = pa[k][3] = 0u;
      switch (warp) {
        case 0: acc_to_a(sacc, 0, pa[0]); break;
        case 1: acc_to_a(sacc, 1, pa[1]); break;
        case 2: acc_to_a(sacc, 2, pa[2]); break;
        default: acc_to_a(sacc, 3, pa[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_to_a(sacc, k, pa[k]);
    }

    // O += P V
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) mma_rs<HD>(o, pa[k], dv[k]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  }
  cp_async_wait<0>();
  if constexpr (DEC) {
    // warp 0 merges warps 1-3's (m, l, O) of the same rows, in warp order
    // (the ring is free: every copy and product is done)
    constexpr int X = HD / 2 + 4;
    float* xs = reinterpret_cast<float*>(sbase);
    __syncthreads();
    if (warp > 0) {
      float* mine = xs + ((warp - 1) * 32 + lane) * X;
      mine[0] = m[0], mine[1] = m[1], mine[2] = l[0], mine[3] = l[1];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) mine[4 + e] = o[e];
    }
    __syncthreads();
    if (warp > 0) return;
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const float* x = xs + (w * 32 + lane) * X;
      mt[0] = fmaxf(mt[0], x[0]);
      mt[1] = fmaxf(mt[1], x[1]);
    }
    float a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i] = exp2_ftz((m[i] - mt[i]) * sl2);
      l[i] *= a[i];
      m[i] = mt[i];
    }
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= a[(e % 4) / 2];
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const float* x = xs + (w * 32 + lane) * X;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = exp2_ftz((x[i] - mt[i]) * sl2);
        l[i] += a[i] * x[2 + i];
      }
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] += a[(e % 4) / 2] * x[4 + e];
    }
  }

  // epilogue: this thread's rows rw, rw + 8 (quad-summed l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const long long rows_total = (long long)p.b * p.kvh * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rw + 8 * i;
    if (r >= R) continue;
    if (p.n_split == 1) {
      // O / l; a row with no valid key has O == 0 and l == 0: exact zeros
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      bf16* dst = p.o + si * p.osb + (r / group) * p.ost +
                  (kv * group + r % group) * p.osh + cw;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16x2(
            o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    } else {
      const long long g =
          (long long)split * rows_total + ((long long)si * p.kvh + kv) * R + r;
      float* po = p.part + g * HD + cw;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(po + 8 * j) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      }
      if (lane % 4 == 0) {
        float2* ml = reinterpret_cast<float2*>(
            p.part + (long long)p.n_split * rows_total * HD);
        ml[g] = make_float2(m[i], l[i]);
      }
    }
  }
}

// ------------------------------ the combine ----------------------------------

// One warp a row (sequence, kv head, row r): the splits whose keys start
// at or before the row's position (each holds at least one of its valid
// keys), merged in split order; HD / 32 columns a lane.  Two round trips
// to memory: the row's position with every split's (m, l) (lane s holds
// split s, s + 32, ...), then the splits' O, BATCH splits at a time.
template <int HD>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const __grid_constant__ Params p) {
  constexpr int E = HD / 32;
  constexpr int MAXW = 8;              // (m, l) pairs a lane holds
  constexpr int BATCH = 8;
  const int group = p.h / p.kvh;
  const int R = p.T * group;
  const long long rows_total = (long long)p.b * p.kvh * R;
  const long long g = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  if (g >= rows_total) return;
  const int lane = threadIdx.x % 32;
  const int r = static_cast<int>(g % R);
  const int kv = static_cast<int>((g / R) % p.kvh);
  const long long si = g / R / p.kvh;
  const int tok = r / group;
  const float2* ml = reinterpret_cast<const float2*>(
      p.part + (long long)p.n_split * rows_total * HD);
  // speculative: a split past the row's last one holds no partial of it,
  // and its pair is dropped below
  const int pos = p.positions[si * p.T + tok];
  // launched early (programmatic dependent launch): the split grid's
  // partials are complete and visible past this wait
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float2 mine[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    const int s = lane + 32 * i;
    mine[i] = s < p.n_split ? ml[s * rows_total + g]
                            : make_float2(NEG_INF, 0.f);
  }
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  if (pos >= 0) {
    const int cap = p.nbmax * p.bs;
    const int nv = min(min(pos, cap - 1) / p.split_keys + 1, p.n_split);
    const float sl2 = p.scale * LOG2E;
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (lane + 32 * i < nv) mx = fmaxf(mx, mine[i].x);
    }
    for (int s = 32 * MAXW + lane; s < nv; s += 32) {
      mx = fmaxf(mx, ml[s * rows_total + g].x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    // each split weighed by w_s = exp(m_s - max m) and by its l: a split
    // in which the row saw no key adds nothing
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (lane + 32 * i < nv) {
        den += exp2f((mine[i].x - mx) * sl2) * mine[i].y;
      }
    }
    for (int s = 32 * MAXW + lane; s < nv; s += 32) {
      const float2 v = ml[s * rows_total + g];
      den += exp2f((v.x - mx) * sl2) * v.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      den += __shfl_xor_sync(0xffffffffu, den, o);
    }
    // O in split order (each w_s again from its (m, l), now in L1)
    for (int s0 = 0; s0 < nv; s0 += BATCH) {
      float w[BATCH], x[BATCH][E];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int s = s0 + u;
        w[u] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x[u][e] = 0.f;
        if (s < nv) {
          w[u] = exp2f((ml[s * rows_total + g].x - mx) * sl2);
          const float* po = p.part + (s * rows_total + g) * HD + lane * E;
          if constexpr (E == 4) {
            const float4 f = *reinterpret_cast<const float4*>(po);
            x[u][0] = f.x, x[u][1] = f.y, x[u][2] = f.z, x[u][3] = f.w;
          } else {
            const float2 f = *reinterpret_cast<const float2*>(po);
            x[u][0] = f.x, x[u][1] = f.y;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += w[u] * x[u][e];
      }
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= inv;
  }
  bf16* dst = p.o + si * p.osb + tok * p.ost + (kv * group + r % group) * p.osh +
              lane * E;
  uint32_t w[E / 2];
#pragma unroll
  for (int e = 0; e < E; e += 2) w[e / 2] = pack_bf16x2(acc[e], acc[e + 1]);
  if constexpr (E == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

template <int HD, int KIND, int NC, bool DEC>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  using L = Layout<HD, KIND, NC>;
  using SH = Shape<NC>;
  // once per instantiation, so a launch inside CUDA-graph capture makes
  // no attribute call
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<HD, KIND, NC, DEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int R = p.T * (p.h / p.kvh);
  // splits slowest: blocks start in grid order, so every item's first
  // splits (the ones that hold keys) take the card before the later ones,
  // which may exit at once
  dim3 grid(p.kvh * p.b, (R + SH::OWN - 1) / SH::OWN, p.n_split);
  paged_split_kernel<HD, KIND, NC, DEC>
      <<<grid, SH::NTHREADS, L::ALLOC, stream>>>(p);
  return cudaGetLastError();
}

// One warpgroup a block for decode rows (R <= 16, keys shared out among
// its warps) and short chunks (R <= 64), two sharing each K / V tile
// above; then the combine if the keys are split.
template <int HD, int KIND>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int R = p.T * (p.h / p.kvh);
  cudaError_t err =
      R <= 16     ? launch_split<HD, KIND, 1, true>(p, stream)
      : R <= ROWS ? launch_split<HD, KIND, 1, false>(p, stream)
                  : launch_split<HD, KIND, 2, false>(p, stream);
  if (err != cudaSuccess || p.n_split == 1) return err;
  const long long rows_total = (long long)p.b * p.kvh * R;
  // programmatic dependent launch: the combine's blocks start once every
  // split block has started, and wait in the kernel for the split grid
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows_total + 3) / 4));
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_combine_kernel<HD>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_kind(int kind, const Params& p, cudaStream_t stream) {
  switch (kind) {
    case KV_BF16:
      return launch<HD, KV_BF16>(p, stream);
    case KV_E4M3:
      return launch<HD, KV_E4M3>(p, stream);
    case KV_INT8:
      return launch<HD, KV_INT8>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Pools are contiguous (n_blocks, bs, kvh, d); scales contiguous
// (n_blocks, bs) fp32 or null; tables (b, nbmax) and positions (b, T)
// contiguous int32.  strides: 6 values, (batch, token, head) element
// strides of q then o.  kv_kind: 0 bf16, 1 float8_e4m3, 2 int8.  The key
// axis [0, nbmax * bs) is cut into n_split ranges of split_keys keys (a
// multiple of 64); with n_split > 1, workspace holds n_split * b * kvh *
// T * (h / kvh) * (d + 2) floats (the splits' O, then their (m, l)).
extern "C" int paged_chunk_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, void* o, void* workspace, int b, int T, int h,
    int kvh, int d, int bs, int nbmax, int kv_kind, int n_split,
    int split_keys, const long long* strides, float scale, void* stream) {
  const long long cap = (long long)nbmax * bs;
  if (b <= 0 || T <= 0 || kvh <= 0 || h % kvh != 0 || bs <= 0 ||
      nbmax <= 0 || cap > 0x7fffffff || n_split <= 0 || n_split > 65535 || split_keys <= 0 || split_keys % TILE != 0 ||
      (long long)n_split * split_keys < cap ||
      (long long)(n_split - 1) * split_keys >= cap ||
      (split_keys + bs - 1) / bs + 1 > MAX_PAGES ||
      (n_split > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.positions = static_cast<const int*>(positions);
  p.o = static_cast<bf16*>(o);
  p.part = static_cast<float*>(workspace);
  p.qsb = strides[0];
  p.qst = strides[1];
  p.qsh = strides[2];
  p.osb = strides[3];
  p.ost = strides[4];
  p.osh = strides[5];
  p.b = b;
  p.T = T;
  p.h = h;
  p.kvh = kvh;
  p.bs = bs;
  p.nbmax = nbmax;
  p.n_split = n_split;
  p.split_keys = split_keys;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return static_cast<int>(dispatch_kind<64>(kv_kind, p, s));
    case 128:
      return static_cast<int>(dispatch_kind<128>(kv_kind, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
