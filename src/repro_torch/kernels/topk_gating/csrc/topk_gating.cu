// MoE router top-k gating for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels src/repro/kernels/topk_gating/kernel.py:
// topk_gating_fwd (_gating_kernel) and topk_gating_bwd (_gating_bwd_kernel).
//
// Forward, per token row of logits (T, E): p = softmax(x) in fp32 (row max,
// accurate expf, a divide by the row sum), then k rounds that each take the
// largest remaining p (the lower expert index wins a tie) and set it to
// -1e30; the k picks are renormalised by max(sum, 1e-9) when asked.
// Outputs weights (T, k) fp32 and experts (T, k) int32.
//
// Backward, per row, from the saved logits and experts and the weights'
// cotangent dw (T, k) fp32: p recomputed the same way, wr = p[experts],
// S = max(sum wr, 1e-9), wn = wr / S, dwr = (dw - sum(dw * wn)) / S
// (dwr = dw without renorm), c = sum(dwr * wr) and
// dlogits[e] = p[e] * (dp[e] - c) with dp[e] = sum_j dwr[j] [experts[j] = e],
// written in the dtype of the logits.  An expert index outside [0, E)
// contributes nothing.
//
// What bounds it on the H100: a row reads E * 4 bytes and writes k * 8
// (forward) or E * 4 (backward) and does O(k * E) comparisons, far below
// the card's compute, so device memory bounds it; at the MoE path's shapes
// (T <= 4096 rows of E = 60) that is well under a microsecond, and the
// launch and the chain of dependent steps within a row set the time.
//
// Both kernels share one layout: a group of L lanes a row, lane j of the
// group holding experts j, j + L, j + 2L, ... in SLOTS registers (2 or 4
// at L 32, 4 or 8 at L 16; slots past E hold -inf in the forward, 0 in the
// backward).  The row max and the sum are straight-line code over the
// lane's slots, then log2(L) xor-shuffle steps across the group, after
// which every lane of the group holds the same bits.  Sums are taken in a
// fixed order (each lane its slots in order, then the butterfly), so the
// outputs are the same from run to run.  256-thread blocks of 256 / L
// rows.  L comes from kernel.py:gating_plan.  The forward: 32 lanes at few
// rows, 16 at T 4096 (measured against 4 and 8 lanes a row too, whose
// longer in-lane chains of expf, divides and compares were slower; each of
// its k argmax rounds takes log2(L) shuffle steps).  The backward: 32
// lanes at every T (it has no rounds, and fewer slots a lane shorten its
// chain; chip_smoke.py times it under the forward's layout beside its
// own).
//
// The forward's argmax reduces (value, index) pairs under one total order
// (larger value first, then lower index), so ties resolve exactly as the
// TPU kernel's argmax does.  The k rounds are a loop, not unrolled: the
// kernel's time is latency (a launch and a chain of dependent steps a
// row), and a short kernel also loads its code sooner.
//
// The backward keeps its chain short:
// - One round trip to memory.  The row's logits, and in lane j < k pick
//   j's expert and dw (one coalesced load each across the k lanes), are
//   all issued before anything waits on them.
// - wr of pick j lives in lane j: one shuffle per slot from the lane that
//   holds the pick's expert, the slot chosen on arrival.
// - The row's sums S, sum(dw * wn) and c as the formula writes them, each
//   a butterfly over the group (lanes >= k add 0), log2(L) steps.  Their
//   products are rounded on their own (__fmul_rn), so no lane fuses its
//   term into a multiply-add and every lane keeps the same bits.  (One
//   paired butterfly with c by the identity c = (sum(dw wr) - dot sum(wr))
//   / S, or sums straight-line over k in every lane, measured no faster
//   on the H100, and rounded further from the plain backward.)
// - dp from k broadcasts of (expert, dwr), four at a time, each matched
//   against the lane's slots; lanes >= k hold no expert (-1), so the
//   padding of the last four matches nothing.
// Nothing is staged in shared memory; rows need no padding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // a block: 256 / L rows
constexpr int kMaxE = 128;
constexpr int kMaxK = 16;            // <= L: pick j lives in lane j
constexpr float kNegInf = -1e30f;    // a taken entry, as NEG_INF on the TPU
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int L>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return L == 32 ? kFull : ((1u << (L & 31)) - 1u) << (lane & ~(L - 1));
}

template <int L>
__device__ __forceinline__ float group_max(float v, unsigned mask) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, off, L));
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off, L);
  return v;
}

// p = softmax of the row x over the lane's slots (lane j: experts j,
// j + L, ...); slots past E get `pad`.
template <int L, int SLOTS>
__device__ __forceinline__ void row_softmax(float (&p)[SLOTS], int j, int E,
                                            unsigned mask, float pad) {
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) m = fmaxf(m, p[s]);
  m = group_max<L>(m, mask);
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    p[s] = j + L * s < E ? expf(p[s] - m) : 0.f;
    sum += p[s];
  }
  sum = group_sum<L>(sum, mask);
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) p[s] = j + L * s < E ? p[s] / sum : pad;
}

template <typename T, int L, int SLOTS>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         float (&p)[SLOTS], int j, int E) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int e = j + L * s;
    p[s] = e < E ? load_f(x + e) : -INFINITY;
  }
}

template <typename T, int L, int SLOTS>
__global__ void __launch_bounds__(kThreads)
topk_gating_fwd_kernel(const T* __restrict__ logits, float* __restrict__ w,
                       int* __restrict__ experts, int rows, int E, int k,
                       int renorm) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (L - 1);
  const int row = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  if (row >= rows) return;             // whole groups leave together
  const unsigned mask = group_mask<L>(lane);
  float p[SLOTS];
  load_row<T, L, SLOTS>(logits + static_cast<long long>(row) * E, p, j, E);
  row_softmax<L, SLOTS>(p, j, E, mask, -INFINITY);
  // round r's pick stays in lane r % L, as its (r / L)-th
  constexpr int KP = (kMaxK + L - 1) / L;
  float kw[KP], wsum = 0.f;
  int ke[KP];
#pragma unroll 1
  for (int r = 0; r < k; ++r) {
    // the lane's best slot (slots rise in index, so > keeps the lower)
    float bv = p[0];
    int bi = j;
#pragma unroll
    for (int s = 1; s < SLOTS; ++s) {
      if (p[s] > bv) {
        bv = p[s];
        bi = j + L * s;
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(mask, bv, off, L);
      const int oi = __shfl_xor_sync(mask, bi, off, L);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((r & (L - 1)) == j) {
#pragma unroll
      for (int q = 0; q < KP; ++q) {
        if (q == r / L) {
          kw[q] = bv;
          ke[q] = bi;
        }
      }
    }
    wsum += bv;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (j + L * s == bi) p[s] = kNegInf;
  }
  const float norm = fmaxf(wsum, 1e-9f);
  const long long o = static_cast<long long>(row) * k;
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    const int r = q * L + j;
    if (r < k) {
      w[o + r] = renorm ? kw[q] / norm : kw[q];
      experts[o + r] = ke[q];
    }
  }
}

template <typename T, int L, int SLOTS>
__global__ void __launch_bounds__(kThreads)
topk_gating_bwd_kernel(const T* __restrict__ logits,
                       const int* __restrict__ experts,
                       const float* __restrict__ dw, T* __restrict__ dlogits,
                       int rows, int E, int k, int renorm) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (L - 1);
  const int row = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  if (row >= rows) return;             // whole groups leave together
  const unsigned mask = group_mask<L>(lane);
  // one round trip: the row's logits, and in lane j < k pick j
  float p[SLOTS];
  load_row<T, L, SLOTS>(logits + static_cast<long long>(row) * E, p, j, E);
  int pick = -1;
  float g = 0.f;
  if (j < k) {
    const long long o = static_cast<long long>(row) * k + j;
    pick = experts[o];
    g = dw[o];
  }
  if (static_cast<unsigned>(pick) >= static_cast<unsigned>(E)) pick = -1;
  row_softmax<L, SLOTS>(p, j, E, mask, 0.f);
  // wr = p[pick], held by lane pick % L in slot pick / L (none for -1)
  const int slot = pick < 0 ? -1 : pick / L;
  float wr = 0.f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const float v = __shfl_sync(mask, p[s], pick & (L - 1), L);
    if (s == slot) wr = v;
  }
  // the row's three sums over the picks (lanes >= k add 0), each a
  // butterfly, so that every lane holds the same bits
  const float sw = group_sum<L>(wr, mask);
  float dwr = g, c;
  if (renorm) {
    const float S = fmaxf(sw, 1e-9f);
    const float dot = group_sum<L>(__fmul_rn(g, wr / S), mask);
    dwr = (g - dot) / S;
    c = group_sum<L>(__fmul_rn(dwr, wr), mask);
  } else {
    c = group_sum<L>(__fmul_rn(g, wr), mask);
  }
  // dp[e] = sum of dwr over the picks of expert e, in pick order
  float dp[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) dp[s] = 0.f;
#pragma unroll 1
  for (int r0 = 0; r0 < k; r0 += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = __shfl_sync(mask, pick, r0 + q, L);
      const float d = __shfl_sync(mask, dwr, r0 + q, L);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (e == j + L * s) dp[s] += d;
    }
  }
  T* out = dlogits + static_cast<long long>(row) * E;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int e = j + L * s;
    if (e < E) store_f(out + e, p[s] * (dp[s] - c));
  }
}

template <int L_, int SLOTS_>
struct Layout {
  static constexpr int L = L_, SLOTS = SLOTS_;
};

// launch(Layout<L, SLOTS>{}) for the instantiated pairs of kernel.py:
// FWD_SLOTS; cudaErrorInvalidValue for any other pair
template <typename F>
cudaError_t by_layout(int lanes, int slots, F&& launch) {
  switch (lanes * 100 + slots) {
    case 1604:
      return launch(Layout<16, 4>{});
    case 1608:
      return launch(Layout<16, 8>{});
    case 3202:
      return launch(Layout<32, 2>{});
    case 3204:
      return launch(Layout<32, 4>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// A launch's shape and grid, built once for each shape by the wrapper
// (kernel.py:_fwd_config, _bwd_config) and passed by address: a ctypes
// call costs the host about a quarter of a microsecond an argument.
// lanes (a row's group), slots (logits a lane) and blocks as
// kernel.py:gating_plan gives them:
// (32, 2), (32, 4), (16, 4) or (16, 8) with lanes * slots >= E,
// blocks * 256 / lanes >= rows.  dtype: 0 = fp32 logits, 1 = bf16 logits.
struct Config {
  int rows, E, k, renorm, dtype, lanes, slots, blocks;
};

namespace {

bool bad_config(const Config* c) {
  return c->rows <= 0 || c->E < 1 || c->E > kMaxE || c->k < 1 ||
         c->k > c->E || c->k > kMaxK || (c->dtype != 0 && c->dtype != 1) ||
         c->lanes < kMaxK || c->lanes * c->slots < c->E ||
         static_cast<long long>(c->blocks) * (kThreads / c->lanes) < c->rows;
}

template <typename T>
cudaError_t launch_fwd(const T* logits, float* w, int* experts,
                       const Config* c, cudaStream_t s) {
  return by_layout(c->lanes, c->slots, [&](auto layout) {
    using Lay = decltype(layout);
    topk_gating_fwd_kernel<T, Lay::L, Lay::SLOTS>
        <<<c->blocks, kThreads, 0, s>>>(logits, w, experts, c->rows, c->E,
                                        c->k, c->renorm);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_bwd(const T* logits, const int* experts, const float* dw,
                       T* dlogits, const Config* c, cudaStream_t s) {
  return by_layout(c->lanes, c->slots, [&](auto layout) {
    using Lay = decltype(layout);
    topk_gating_bwd_kernel<T, Lay::L, Lay::SLOTS>
        <<<c->blocks, kThreads, 0, s>>>(logits, experts, dw, dlogits, c->rows,
                                        c->E, c->k, c->renorm);
    return cudaGetLastError();
  });
}

}  // namespace

// Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for a shape or layout the kernels do not take).
extern "C" int topk_gating_fwd(const void* logits, void* w, void* experts,
                               const Config* c, void* stream) {
  if (bad_config(c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wo = static_cast<float*>(w);
  int* eo = static_cast<int*>(experts);
  const cudaError_t err =
      c->dtype == 0
          ? launch_fwd(static_cast<const float*>(logits), wo, eo, c, s)
          : launch_fwd(static_cast<const __nv_bfloat16*>(logits), wo, eo, c,
                       s);
  return static_cast<int>(err);
}

extern "C" int topk_gating_bwd(const void* logits, const void* experts,
                               const void* dw, void* dlogits, const Config* c,
                               void* stream) {
  if (bad_config(c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ex = static_cast<const int*>(experts);
  const float* g = static_cast<const float*>(dw);
  const cudaError_t err =
      c->dtype == 0
          ? launch_bwd(static_cast<const float*>(logits), ex, g,
                       static_cast<float*>(dlogits), c, s)
          : launch_bwd(static_cast<const __nv_bfloat16*>(logits), ex, g,
                       static_cast<__nv_bfloat16*>(dlogits), c, s);
  return static_cast<int>(err);
}
