// RMSNorm forward for Hopper (sm_90a): a block a row at a time, the row in
// registers, persistent blocks that load the next row before they reduce
// the current one.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py:36
// rmsnorm_fwd (_rmsnorm_kernel / _rmsnorm_res_kernel).  Per row of x (n, d):
//
//   y = x rsqrt(mean(x^2) + eps) w    in fp32, cast to x's dtype
//
// and, when asked, the row's rstd (n,) fp32, the residual the backward reads.
//
// What bounds it on the H100: bytes.  The function reads x once and writes y
// once, 2 n d sizeof(x) bytes plus d sizeof(w) and 4 n of rstd, against
// about 4 fp32 operations an element: at 4096 x 3072 bf16, 50.3 MB over
// 3.35 TB/s = 15.0 us against 0.75 us of fp32 work.  At a decode tick
// (8 x 3072) the bytes take 0.03 us: the launch and one round trip to
// memory set the time there.
//
// - A block of W warps a row, thread t holding the row's 16-byte slices
//   t, t + 32 W, ... (S of them) as packed x values in registers, and the
//   same slices of w in fp32, loaded once a block.  W and S come from d
//   alone (kernel.py:fwd_plan): W = 8 for rows of more than 1024 elements
//   (4 below), S = next_pow2(d) / (32 W) slices; d 3072 bf16: 8 warps, 2
//   slices.  A slice is one 16-byte load where x's pointer, its row stride
//   and d * sizeof(x) are multiples of 16; where they are not, 8, 4 or
//   2-byte loads (the plan's width, chosen on the host from the tensor).
//   y is stored in 16-byte slices where its rows are 16-byte aligned (y is
//   contiguous: wherever d * sizeof(x) is a multiple of 16), else at x's
//   width: an odd row stride of x does not cost y 2-byte stores.
// - The arithmetic of the port's first rmsnorm forward (a Triton kernel),
//   kept bit for bit for 16-bit x (compared bitwise on the card at d 1000
//   to 8192 while this kernel was built): each thread's sum of squares in
//   its slices' element order (fused multiply-adds), a butterfly of xor
//   shuffles across the warp (offsets 16 .. 1), then one across the W warp
//   sums (W / 2 .. 1), read from shared memory after the row's one
//   __syncthreads (two rows' sums alternate between two slots, so the
//   next row's writes never meet this row's reads); rstd =
//   1 / sqrt(sum * (1 / d) + eps) with the approximate reciprocal, square
//   root and division that kernel compiled to (rcp.approx, sqrt.approx,
//   div.full) and its fused multiply-add; y = (x rstd) w.  So numbers
//   downstream do not move: zamba2's 1-ulp SSD-only serving gate reads
//   the rounding of every op upstream of it, and another summation order
//   put it at 1.7-2.0 ulps (PERF.md §6).  The layout depends on d
//   only, so a row gives the same bits in any batch, and y and rstd are
//   the same from run to run.
// - Persistent blocks.  The grid is G blocks, 4 an SM (2 at 4 slices a
//   thread or 2-byte loads, 1 at 8 slices), from (n, d), the width and
//   the SM count alone; block b walks
//   its own contiguous rows, n / G of them (the first n % G blocks one
//   more).  At up to 2 slices a thread the next row's loads are issued
//   before the current row is reduced.  Where n is small (a decode tick)
//   every row has its own block.  (Rows dealt to the blocks in turn, b,
//   b + G, ..., and 6 or 8 blocks an SM measured no faster.)
// - No TMA and no shared-memory ring.  A row (6 KB at d 3072 bf16) is read
//   once, spread over a block's threads, straight into the registers that
//   reduce it.  A ring of four rows a block filled by cp.async measured no
//   faster at the training shapes and slower at a decode tick (PERF.md
//   §6): the card's bandwidth for this even mix of reads and writes,
//   not the bytes in flight, is the limit (chip_smoke.py times a device
//   copy of the same bytes beside each case).
//
// Tried first: one warp a row (12 slices a lane at d 3072 bf16), 8 warps
// an SM.  Each lane then ran a chain of ~700 dependent instructions a row
// and the kernel was bound by its own latency: 26.4 us at 4096 x 3072,
// 5.3 us at the decode tick (PERF.md §6).
//
// d may be at most 8 warps x 32 threads x 8 slices x 16 bytes (16384 bf16,
// 8192 fp32); the wrapper raises above it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

enum Kind { K_BF16 = 0, K_F16 = 1, K_F32 = 2 };

struct Params {
  const void* x;
  const void* w;
  void* y;            // (n, d) contiguous, of x's kind
  float* rstd;        // (n,) fp32, or null
  long long sx;       // x's row stride, in elements
  int n, d, w_kind;
  int y16;            // y's rows 16-byte aligned: 16-byte stores
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

template <typename T>
struct KindOf;
template <>
struct KindOf<__nv_bfloat16> {
  static constexpr int value = K_BF16;
};
template <>
struct KindOf<__half> {
  static constexpr int value = K_F16;
};
template <>
struct KindOf<float> {
  static constexpr int value = K_F32;
};

__device__ __forceinline__ float load_w1(const void* w, int kind, int c) {
  switch (kind) {
    case K_BF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[c]);
    case K_F16:
      return __half2float(static_cast<const __half*>(w)[c]);
    default:
      return static_cast<const float*>(w)[c];
  }
}

__device__ __forceinline__ float rcp_approx(float a) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float sqrt_approx(float a) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float div_full(float a, float b) {
  float r;
  asm("div.full.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the raw type of one load or store of B bytes
template <int B>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = uint32_t;
};
template <>
struct Raw<2> {
  using type = uint16_t;
};

// One 16-byte slice of a row, elements c0.., from src into dst with loads
// of LW bytes; units at or past d read 0.  d * sizeof(T) is a multiple of
// LW, so a unit never straddles d.
template <typename T, int LW>
__device__ __forceinline__ void load_slice(T* dst, const T* src, int c0,
                                           int d) {
  using R = typename Raw<LW>::type;
  constexpr int U = LW / sizeof(T);
#pragma unroll
  for (int u = 0; u < 16 / LW; ++u) {
    const int c = c0 + u * U;
    R r = R();
    if (c < d) r = *reinterpret_cast<const R*>(src + c);
    *reinterpret_cast<R*>(dst + u * U) = r;
  }
}

template <typename T, int LW>
__device__ __forceinline__ void store_slice(T* dst, const T* src, int c0,
                                            int d) {
  using R = typename Raw<LW>::type;
  constexpr int U = LW / sizeof(T);
#pragma unroll
  for (int u = 0; u < 16 / LW; ++u) {
    const int c = c0 + u * U;
    if (c < d) {
      *reinterpret_cast<R*>(dst + c) =
          *reinterpret_cast<const R*>(src + u * U);
    }
  }
}

// blocks an SM (the register budget; kernel.py:fwd_plan's grid): 4, 2 at
// 4 slices a thread or at 2-byte loads, 1 at 8 slices
constexpr int blocks_per_sm(int S, int LW) {
  return S == 8 ? 1 : (S == 4 || LW == 2) ? 2 : 4;
}

template <typename T, int LW, int S>
__global__ void __launch_bounds__(32 * MAX_WARPS, blocks_per_sm(S, LW))
    rmsnorm_fwd_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);   // elements a slice
  // the next row loaded before this one is reduced, and w held in
  // registers, where they fit without spilling
  constexpr bool AHEAD = S <= 2;
  constexpr bool W_HELD = S <= 4;
  __shared__ float s_sum[2][MAX_WARPS];
  const int t = threadIdx.x, nthr = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nthr >> 5;
  const int q = p.n / gridDim.x, rem = p.n % gridDim.x;
  const int b = blockIdx.x;
  const long long row0 = (long long)b * q + min(b, rem);
  const int count = q + (b < rem ? 1 : 0);
  const int d = p.d;
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);

  alignas(16) T xa[S][VEC];
  auto load = [&](T (&buf)[S][VEC], long long row) {
    const T* xr = x + row * p.sx;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      load_slice<T, LW>(buf[s], xr, (t + nthr * s) * VEC, d);
    }
  };
  load(xa, row0);
  // w's slices in fp32: 16-byte loads where w is of x's type and 16-byte
  // aligned, else element by element; past d, 0
  const bool w_vec = p.w_kind == KindOf<T>::value &&
                     reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  auto load_w = [&](float (&wv)[VEC], int c0) {
    if (w_vec && c0 + VEC <= d) {
      alignas(16) T raw[VEC];
      *reinterpret_cast<uint4*>(raw) = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.w) + c0));
#pragma unroll
      for (int k = 0; k < VEC; ++k) wv[k] = to_f(raw[k]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        wv[k] = c0 + k < d ? load_w1(p.w, p.w_kind, c0 + k) : 0.f;
      }
    }
  };
  float wf[W_HELD ? S : 1][VEC];
  if constexpr (W_HELD) {
#pragma unroll
    for (int s = 0; s < S; ++s) load_w(wf[s], (t + nthr * s) * VEC);
  }
  const float inv_d = rcp_approx(static_cast<float>(d));

  // the block's row i, `row`, from buf: the sum of squares, rstd, y
  auto finish = [&](T (&buf)[S][VEC], long long row, int i) {
    float ss = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = to_f(buf[s][k]);
        ss = __fmaf_rn(f, f, ss);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss = __fadd_rn(ss, __shfl_xor_sync(FULL, ss, o));
    }
    if (lane == 0) s_sum[i & 1][warp] = ss;
    __syncthreads();
    float tot = lane < nwarps ? s_sum[i & 1][lane] : 0.f;
    for (int o = nwarps / 2; o > 0; o >>= 1) {
      tot = __fadd_rn(tot, __shfl_xor_sync(FULL, tot, o));
    }
    tot = __shfl_sync(FULL, tot, 0);
    const float r = div_full(1.f, sqrt_approx(__fmaf_rn(tot, inv_d, p.eps)));
    T* yr = y + row * d;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c0 = (t + nthr * s) * VEC;
      if (c0 >= d) continue;
      float wv[VEC];
      if constexpr (W_HELD) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) wv[k] = wf[s][k];
      } else {
        load_w(wv, c0);
      }
      alignas(16) T out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        out[k] = from_f<T>(__fmul_rn(__fmul_rn(to_f(buf[s][k]), r), wv[k]));
      }
      if (p.y16) {
        *reinterpret_cast<uint4*>(yr + c0) =
            *reinterpret_cast<const uint4*>(out);
      } else {
        store_slice<T, LW>(yr, out, c0, d);
      }
    }
    if (p.rstd != nullptr && t == 0) p.rstd[row] = r;
  };

  if constexpr (AHEAD) {
    // row i from xa with row i + 1's loads into xb issued first, then
    // row i + 1 from xb with row i + 2's loads into xa issued first
    alignas(16) T xb[S][VEC];
    for (int i = 0; i < count; i += 2) {
      if (i + 1 < count) load(xb, row0 + i + 1);
      finish(xa, row0 + i, i);
      if (i + 1 < count) {
        if (i + 2 < count) load(xa, row0 + i + 2);
        finish(xb, row0 + i + 1, i + 1);
      }
    }
  } else {
    for (int i = 0; i < count; ++i) {
      if (i > 0) load(xa, row0 + i);
      finish(xa, row0 + i, i);
    }
  }
}

template <typename T, int LW>
cudaError_t launch_slices(const Params& p, int slices, int blocks,
                          int threads, cudaStream_t stream) {
  switch (slices) {
    case 1:
      rmsnorm_fwd_kernel<T, LW, 1><<<blocks, threads, 0, stream>>>(p);
      break;
    case 2:
      rmsnorm_fwd_kernel<T, LW, 2><<<blocks, threads, 0, stream>>>(p);
      break;
    case 4:
      rmsnorm_fwd_kernel<T, LW, 4><<<blocks, threads, 0, stream>>>(p);
      break;
    case 8:
      rmsnorm_fwd_kernel<T, LW, 8><<<blocks, threads, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const Params& p, int width, int slices, int blocks,
                         int threads, cudaStream_t stream) {
  switch (width) {
    case 16:
      return launch_slices<T, 16>(p, slices, blocks, threads, stream);
    case 8:
      return launch_slices<T, 8>(p, slices, blocks, threads, stream);
    case 4:
      return launch_slices<T, 4>(p, slices, blocks, threads, stream);
    case 2:
      if constexpr (sizeof(T) == 2) {
        return launch_slices<T, 2>(p, slices, blocks, threads, stream);
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch's shape and grid, built once for each shape by the wrapper
// (kernel.py:_fwd_config) and passed by address: a ctypes call costs the
// host about a quarter of a microsecond an argument.  x_kind and w_kind:
// 0 bf16, 1 fp16, 2 fp32; width (bytes a load or store), slices (16 bytes
// of a row a thread), blocks and warps (a block's) as kernel.py:fwd_plan
// gives them.
struct FwdConfig {
  int n, d, x_kind, w_kind, width, slices, blocks, warps;
  float eps;
};

// x (n, d) with unit column stride and row stride sx (elements), of x_kind;
// w (d,) contiguous of w_kind; y (n, d) contiguous of x_kind; rstd (n,) fp32
// or null.  width divides 16, x's address, sx * sizeof(x) and
// d * sizeof(x); warps is a power of two; 32 * warps * slices * 16 >=
// d * sizeof(x); 1 <= blocks <= n.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, void* rstd,
                           long long sx, const FwdConfig* c, void* stream) {
  const int esz = c->x_kind == K_F32 ? 4 : 2;
  const int n = c->n, d = c->d, width = c->width, warps = c->warps;
  if (n <= 0 || d <= 0 || c->x_kind < 0 || c->x_kind > 2 || c->w_kind < 0 ||
      c->w_kind > 2 || width < esz || 16 % width != 0 || warps < 1 ||
      warps > MAX_WARPS || (warps & (warps - 1)) != 0 ||
      (long long)warps * 32 * c->slices * 16 < (long long)d * esz ||
      c->blocks < 1 || c->blocks > n ||
      reinterpret_cast<uintptr_t>(x) % width != 0 ||
      (sx * esz) % width != 0 || ((long long)d * esz) % width != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.w = w;
  p.y = y;
  p.rstd = static_cast<float*>(rstd);
  p.sx = sx;
  p.n = n;
  p.d = d;
  p.w_kind = c->w_kind;
  p.y16 = ((long long)d * esz) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  p.eps = c->eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 32 * warps;
  switch (c->x_kind) {
    case K_BF16:
      return static_cast<int>(launch_width<__nv_bfloat16>(
          p, width, c->slices, c->blocks, threads, s));
    case K_F16:
      return static_cast<int>(launch_width<__half>(p, width, c->slices,
                                                   c->blocks, threads, s));
    default:
      return static_cast<int>(launch_width<float>(p, width, c->slices,
                                                  c->blocks, threads, s));
  }
}
