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
// written in the dtype of the logits.
//
// What bounds it on the H100: a row reads E * 4 bytes and writes k * 8
// (forward) or E * 4 (backward) and does O(k * E) comparisons, far below
// the card's compute, so device memory bounds it; at the MoE path's shapes
// (T <= 4096 rows of E = 60) that is well under a microsecond, and the
// launch and the chain of dependent steps within a row set the time.
//
// The forward: a group of L lanes a row (L = 32 or 16, from T and the SM
// count: kernel.py:gating_plan), lane j of the group holding experts j,
// j + L, j + 2L, ... in SLOTS registers (2 or 4 at L 32, 4 or 8 at L 16;
// slots past E hold -inf and never win).  The row max, the sum and each
// round's argmax are straight-line code over the lane's slots, then
// log2(L) xor-shuffle steps across the group, after which every lane of
// the group holds the same bits.  The sum is taken in a fixed order (each
// lane its slots in order, then the butterfly), so the outputs are the
// same from run to run.  The argmax reduces (value, index) pairs under one
// total order (larger value first, then lower index), so ties resolve
// exactly as the TPU kernel's argmax does.  The k rounds are a loop, not
// unrolled: the kernel's time is latency (a launch and a chain of
// dependent steps a row), and a short kernel also loads its code sooner.
// 256-thread blocks of 256 / L rows.  Measured against 4 and 8 lanes a
// row (more logits a lane, longer in-lane chains of expf, divides and
// compares): 32 lanes are the fastest at few rows, 16 at T 4096.
//
// The backward: one warp per row, each lane holding the experts lane,
// lane + 32, lane + 64 and lane + 96 (E <= 128), the max and the sum
// reduced across the warp with shuffles.
// Nothing is staged in shared memory; rows need no padding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;            // rows per block
constexpr int kSlots = 4;            // logits per lane: E <= 32 * kSlots
constexpr int kMaxK = 16;
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The backward's row softmax: p = softmax of the row's logits in the
// lane's slots; slots past E get `pad`.
template <typename T>
__device__ __forceinline__ void row_softmax(const T* __restrict__ x, int E,
                                            int lane, float pad,
                                            float (&p)[kSlots]) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? load_f(x + e) : -INFINITY;
    m = fmaxf(m, p[j]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? expf(p[j] - m) : 0.f;
    s += p[j];
  }
  s = warp_sum(s);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? p[j] / s : pad;
  }
}

// The forward's lane groups: L lanes a row, SLOTS logits a lane, in
// blocks of kFwdThreads threads.
constexpr int kFwdThreads = 256;

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

template <typename T, int L, int SLOTS>
__global__ void __launch_bounds__(kFwdThreads)
topk_gating_fwd_kernel(const T* __restrict__ logits, float* __restrict__ w,
                       int* __restrict__ experts, int rows, int E, int k,
                       int renorm) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (L - 1);
  const int row = blockIdx.x * (kFwdThreads / L) + threadIdx.x / L;
  if (row >= rows) return;             // whole groups leave together
  const unsigned mask =
      L == 32 ? kFull : ((1u << (L & 31)) - 1u) << (lane & ~(L - 1));
  const T* x = logits + static_cast<long long>(row) * E;
  float p[SLOTS];
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int e = j + L * s;
    p[s] = e < E ? load_f(x + e) : -INFINITY;
    m = fmaxf(m, p[s]);
  }
  m = group_max<L>(m, mask);
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    p[s] = j + L * s < E ? expf(p[s] - m) : 0.f;
    sum += p[s];
  }
  sum = group_sum<L>(sum, mask);
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    p[s] = j + L * s < E ? p[s] / sum : -INFINITY;
  }
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

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
topk_gating_bwd_kernel(const T* __restrict__ logits,
                       const int* __restrict__ experts,
                       const float* __restrict__ dw, T* __restrict__ dlogits,
                       int rows, int E, int k, int renorm) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float p[kSlots];
  row_softmax(logits + static_cast<long long>(row) * E, E, lane, 0.f, p);
  const int* ex = experts + static_cast<long long>(row) * k;
  const float* g = dw + static_cast<long long>(row) * k;
  int e_r[kMaxK];
  float wr[kMaxK], dwr[kMaxK];
  float S = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r < k) {
      // every lane reads the same k entries (one broadcast load each);
      // p[e] lives in lane e % 32, slot e / 32
      const int e = ex[r];
      const bool valid = e >= 0 && e < E;
      const int slot = valid ? e >> 5 : 0;
      float mine = p[0];
#pragma unroll
      for (int j = 1; j < kSlots; ++j)
        if (slot == j) mine = p[j];
      const float v = __shfl_sync(kFull, mine, valid ? e & 31 : 0);
      e_r[r] = e;
      wr[r] = valid ? v : 0.f;
      dwr[r] = g[r];
      S += wr[r];
    }
  }
  if (renorm) {
    S = fmaxf(S, 1e-9f);
    float dot = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r)
      if (r < k) dot += dwr[r] * (wr[r] / S);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r)
      if (r < k) dwr[r] = (dwr[r] - dot) / S;
  }
  float c = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r)
    if (r < k) c += dwr[r] * wr[r];
  T* out = dlogits + static_cast<long long>(row) * E;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = lane + 32 * j;
    if (e < E) {
      float dp = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxK; ++r)
        if (r < k && e_r[r] == e) dp += dwr[r];
      store_f(out + e, p[j] * (dp - c));
    }
  }
}

bool bad_shape(int rows, int E, int k) {
  return rows <= 0 || E < 1 || E > 32 * kSlots || k < 1 || k > E ||
         k > kMaxK;
}

dim3 grid_for(int rows) { return dim3((rows + kWarps - 1) / kWarps); }

template <typename T, int L, int SLOTS>
cudaError_t launch_group(const T* logits, float* w, int* experts, int rows,
                         int E, int k, int renorm, int blocks,
                         cudaStream_t s) {
  topk_gating_fwd_kernel<T, L, SLOTS><<<blocks, kFwdThreads, 0, s>>>(
      logits, w, experts, rows, E, k, renorm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const T* logits, float* w, int* experts, int rows,
                       int E, int k, int renorm, int lanes, int slots,
                       int blocks, cudaStream_t s) {
  switch (lanes * 100 + slots) {
    case 1604:
      return launch_group<T, 16, 4>(logits, w, experts, rows, E, k, renorm,
                                    blocks, s);
    case 1608:
      return launch_group<T, 16, 8>(logits, w, experts, rows, E, k, renorm,
                                    blocks, s);
    case 3202:
      return launch_group<T, 32, 2>(logits, w, experts, rows, E, k, renorm,
                                    blocks, s);
    case 3204:
      return launch_group<T, 32, 4>(logits, w, experts, rows, E, k, renorm,
                                    blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The forward's shape and grid, built once for each shape by the wrapper
// (kernel.py:_fwd_config) and passed by address: a ctypes call costs the
// host about a quarter of a microsecond an argument.  lanes (a row's
// group), slots (logits a lane) and blocks as kernel.py:gating_plan gives
// them: (32, 2), (32, 4), (16, 4) or (16, 8) with lanes * slots >= E,
// blocks * 256 / lanes >= rows.
struct FwdConfig {
  int rows, E, k, renorm, dtype, lanes, slots, blocks;
};

// dtype: 0 = fp32 logits, 1 = bf16 logits.  Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int topk_gating_fwd(const void* logits, void* w, void* experts,
                               const FwdConfig* c, void* stream) {
  const int rows = c->rows, lanes = c->lanes;
  if (bad_shape(rows, c->E, c->k) || (c->dtype != 0 && c->dtype != 1) ||
      lanes < 1 || lanes * c->slots < c->E ||
      static_cast<long long>(c->blocks) * (kFwdThreads / lanes) < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wo = static_cast<float*>(w);
  int* eo = static_cast<int*>(experts);
  const cudaError_t err =
      c->dtype == 0
          ? launch_fwd(static_cast<const float*>(logits), wo, eo, rows, c->E,
                       c->k, c->renorm, lanes, c->slots, c->blocks, s)
          : launch_fwd(static_cast<const __nv_bfloat16*>(logits), wo, eo,
                       rows, c->E, c->k, c->renorm, lanes, c->slots,
                       c->blocks, s);
  return static_cast<int>(err);
}

extern "C" int topk_gating_bwd(const void* logits, const void* experts,
                               const void* dw, void* dlogits, int rows, int E,
                               int k, int renorm, int dtype, void* stream) {
  if (bad_shape(rows, E, k) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ex = static_cast<const int*>(experts);
  const float* g = static_cast<const float*>(dw);
  if (dtype == 0) {
    topk_gating_bwd_kernel<float><<<grid_for(rows), 32 * kWarps, 0, s>>>(
        static_cast<const float*>(logits), ex, g,
        static_cast<float*>(dlogits), rows, E, k, renorm);
  } else {
    topk_gating_bwd_kernel<__nv_bfloat16>
        <<<grid_for(rows), 32 * kWarps, 0, s>>>(
            static_cast<const __nv_bfloat16*>(logits), ex, g,
            static_cast<__nv_bfloat16*>(dlogits), rows, E, k, renorm);
  }
  return static_cast<int>(cudaGetLastError());
}
