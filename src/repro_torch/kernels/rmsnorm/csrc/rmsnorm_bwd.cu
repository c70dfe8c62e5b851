// RMSNorm backward for Hopper (sm_90a): dx and dw in one pass over x and
// dy, then a fixed-order sum of the blocks' dw partials.
//
// Replaces two TPU kernels of src/repro/kernels/rmsnorm/kernel.py:
// rmsnorm_bwd_dx (:76, _rmsnorm_bwd_dx_kernel) and rmsnorm_bwd_dw (:103,
// _rmsnorm_bwd_dw_kernel, whose per-row-block partials one jnp sum adds).
// From x, dy (n, d), w (d,) and the forward's per-row rstd r (n,) fp32:
//
//   g = dy w,   dx = r g - x r^3 sum(g x) / d   (in x's dtype)
//   dw = sum over rows of dy x r                (fp32)
//
// What bounds it on the H100: bytes.  The function reads x and dy once
// and writes dx once, 3 n d sizeof(x) bytes, plus n * 4 of rstd and a
// few d-vectors, against ~11 fp32 operations an element: at 4096 x 3072
// bf16, 75.5 MB over 3.35 TB/s = 22.5 us, against 2 us of fp32 work.
// The two TPU kernels each read x and dy.  Here every one of those bytes
// moves once:
//
// - Persistent blocks.  A grid of G blocks, G fixed by (n, d) and the SM
//   count alone (kernel.py:bwd_plan: two blocks an SM where they fit,
//   never more than n); block b walks its own contiguous rows, n / G of
//   them (the first n % G blocks one more).  Each thread owns S fixed
//   16-byte column slices of every row (8 bf16 or 4 fp32 each; slice s
//   is vector t + s * blockDim), so its dw sums stay in fp32 registers
//   across all the block's rows.  A row's dot sum(g x) is a warp shuffle
//   reduction and one cross-warp step through shared memory: the one
//   __syncthreads of a row.
// - Rows in flight.  (x row, dy row) pairs stream into a ring of 2-4
//   shared-memory stages by 1-D bulk copies (cp.async.bulk): thread 0
//   starts them, each stage completes on its own mbarrier, and no other
//   thread spends a register or an instruction on the copy.  At d 3072
//   bf16 a stage is 12 KB; the plan keeps about 48 KB of ring an SM (two
//   blocks of two stages there), above the ~25 KB that covers HBM's
//   latency at its rate (deeper rings measured no faster: the card is at
//   its bandwidth).  A stage is refilled right after the row's
//   __syncthreads, by which every thread has read it.  dx leaves by
//   16-byte stores from registers.  rstd is read in chunks of blockDim
//   rows into shared memory, one chunk ahead of its use.
// - dw in a fixed order, no floating-point atomics.  Block b writes its
//   fp32 partial (its rows added in row order) as row b of a (G, d)
//   scratch.  A second kernel, launched as a programmatic dependent,
//   adds the G partials column by column in a fixed order: warp k of 32
//   adds partials k, k + 32, k + 64, ... in block order, then one warp
//   adds the 32 sums in warp order.  dx and dw are bitwise the same from
//   run to run.
//
// The ring needs 16-byte aligned rows: x's and dy's base addresses and
// row strides in bytes, and d * sizeof(x), multiples of 16.  Where one is
// not, the same kernel takes its direct path: each thread loads its
// columns element by element from global memory, the rest unchanged.
// d may be at most 4 * 512 * (16 / sizeof(x)) (16384 bf16, 8192 fp32);
// the wrapper raises above it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_STAGES = 4;
constexpr int COMBINE_WARPS = 32;
constexpr size_t MAX_SMEM = 232448;   // 227 KB, a block's most

enum Kind { K_BF16 = 0, K_F16 = 1, K_F32 = 2 };

struct Params {
  const void* x;
  const void* w;
  const void* dy;
  const float* rstd;
  void* dx;
  float* part;        // (G, d) fp32, one partial a block
  float* dw;          // (d,) fp32
  long long sx, sdy;  // row strides of x and dy, in elements
  int n, d, w_kind, stages;
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

__device__ __forceinline__ float load_w(const void* w, int kind, int c) {
  switch (kind) {
    case K_BF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[c]);
    case K_F16:
      return __half2float(static_cast<const __half*>(w)[c]);
    default:
      return static_cast<const float*>(w)[c];
  }
}

// Shared memory: the stages' mbarriers, the rows' warp dots (two rows'
// worth), two chunks of rstd, then (ring path) the stages.
__host__ __device__ inline size_t ring_offset(int threads) {
  const size_t head = 64 + (2 * MAX_WARPS + 2 * (size_t)threads) * 4;
  return (head + 127) / 128 * 128;
}

template <typename T, int S, bool RING>
__global__ void __launch_bounds__(MAX_THREADS, S == 1 ? 2 : 1)
    rmsnorm_bwd_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  // the combine's blocks may start now; they wait for this grid in
  // griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int d = p.d, vecs = (d + VEC - 1) / VEC;
  const int q = p.n / gridDim.x, rem = p.n % gridDim.x;
  const int b = blockIdx.x;
  const long long row0 = (long long)b * q + min(b, rem);
  const int count = q + (b < rem ? 1 : 0);
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  T* dx = static_cast<T*>(p.dx);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_dot = reinterpret_cast<float*>(smem + 64);
  float* s_r = s_dot + 2 * MAX_WARPS;
  unsigned char* ring = smem + ring_offset(nthr);
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);
  const uint32_t stage_bytes = 2 * row_bytes;
  const int stages = p.stages;

  auto load_row = [&](int j) {     // local row j into stage j % stages
    const int s = j % stages;
    const uint32_t bar = hopper::smem_u32(&bars[s]);
    const uint32_t dst = hopper::smem_u32(ring + (size_t)s * stage_bytes);
    hopper::mbar_expect_tx(bar, stage_bytes);
    hopper::bulk_load_1d(dst, x + (row0 + j) * p.sx, row_bytes, bar);
    hopper::bulk_load_1d(dst + row_bytes, dy + (row0 + j) * p.sdy,
                         row_bytes, bar);
  };
  if (RING && tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(hopper::smem_u32(&bars[s]), 1);
    }
    hopper::fence_barrier_init();
    for (int j = 0; j < min(stages, count); ++j) load_row(j);
  }
  // rstd chunks 0 and 1 (local rows [0, 2 nthr)), w, dw sums
  for (int k = 0; k < 2; ++k) {
    const int j = k * nthr + tid;
    s_r[k * nthr + tid] = j < count ? p.rstd[row0 + j] : 0.f;
  }
  float wv[S][VEC], acc[S][VEC];
#pragma unroll
  for (int sl = 0; sl < S; ++sl) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = (tid + sl * nthr) * VEC + k;
      wv[sl][k] = c < d ? load_w(p.w, p.w_kind, c) : 0.f;
      acc[sl][k] = 0.f;
    }
  }
  __syncthreads();

  float rpre = 0.f;
  for (int i = 0; i < count; ++i) {
    const int chunk = i / nthr, ci = i - chunk * nthr;
    const bool fetch = ci == 0 && chunk >= 1;
    if (fetch) {          // chunk + 1, stored at the end of this row
      const int j = (chunk + 1) * nthr + tid;
      rpre = j < count ? p.rstd[row0 + j] : 0.f;
    }
    const float r = s_r[(chunk & 1) * nthr + ci];
    // the row's x and dy slices, kept packed until dx is written
    alignas(16) T xs[S][VEC];
    alignas(16) T ds[S][VEC];
    if (RING) {
      const int s = i % stages;
      hopper::mbar_wait(hopper::smem_u32(&bars[s]), (i / stages) & 1);
      const unsigned char* st = ring + (size_t)s * stage_bytes;
#pragma unroll
      for (int sl = 0; sl < S; ++sl) {
        const int v = tid + sl * nthr;
        const uint4 zero = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(xs[sl]) =
            v < vecs ? *reinterpret_cast<const uint4*>(st + (size_t)v * 16)
                     : zero;
        *reinterpret_cast<uint4*>(ds[sl]) =
            v < vecs ? *reinterpret_cast<const uint4*>(st + row_bytes +
                                                       (size_t)v * 16)
                     : zero;
      }
    } else {
      const T* xr = x + (row0 + i) * p.sx;
      const T* dr = dy + (row0 + i) * p.sdy;
#pragma unroll
      for (int sl = 0; sl < S; ++sl) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const int c = (tid + sl * nthr) * VEC + k;
          xs[sl][k] = c < d ? xr[c] : from_f<T>(0.f);
          ds[sl][k] = c < d ? dr[c] : from_f<T>(0.f);
        }
      }
    }
    // columns past d read x = dy = w = 0; their dw sums are not stored
    float dot = 0.f;
#pragma unroll
    for (int sl = 0; sl < S; ++sl) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xf = to_f(xs[sl][k]), df = to_f(ds[sl][k]);
        dot += df * wv[sl][k] * xf;
        acc[sl][k] += df * xf * r;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (lane == 0) s_dot[(i & 1) * MAX_WARPS + warp] = dot;
    __syncthreads();      // every thread has read stage i % stages
    if (RING && tid == 0 && i + stages < count) load_row(i + stages);
    float tot = 0.f;
    for (int k = 0; k < nwarps; ++k) tot += s_dot[(i & 1) * MAX_WARPS + k];
    const float c3 = r * r * r * (tot / d);
    T* dxr = dx + (row0 + i) * d;
#pragma unroll
    for (int sl = 0; sl < S; ++sl) {
      const int v = tid + sl * nthr;
      if (v >= vecs) continue;
      alignas(16) T out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float g = to_f(ds[sl][k]) * wv[sl][k];
        out[k] = from_f<T>(r * g - to_f(xs[sl][k]) * c3);
      }
      if (RING) {
        *reinterpret_cast<uint4*>(dxr + (size_t)v * VEC) =
            *reinterpret_cast<const uint4*>(out);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (v * VEC + k < d) dxr[v * VEC + k] = out[k];
        }
      }
    }
    // chunk + 1 goes where chunk - 1 was: its last reader was row i - 1,
    // before that row's __syncthreads; its first is row i + nthr
    if (fetch) s_r[((chunk + 1) & 1) * nthr + tid] = rpre;
  }

  float* pr = p.part + (size_t)b * d;
#pragma unroll
  for (int sl = 0; sl < S; ++sl) {
    const int v = tid + sl * nthr;
    if (v >= vecs) continue;
    if (RING) {       // d a multiple of VEC (>= 4): float4 stores
#pragma unroll
      for (int k = 0; k < VEC; k += 4) {
        *reinterpret_cast<float4*>(pr + (size_t)v * VEC + k) =
            make_float4(acc[sl][k], acc[sl][k + 1], acc[sl][k + 2],
                        acc[sl][k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (v * VEC + k < d) pr[v * VEC + k] = acc[sl][k];
      }
    }
  }
}

// dw[c] = the G partials of column c added in a fixed order: warp k adds
// partials k, k + 32, ... in block order (8 loads in flight a thread:
// one round trip to L2 at G <= 256), then warp 0 the 32 sums in warp
// order.  32 columns a block.
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
    rmsnorm_dw_combine_kernel(const float* part, float* dw, int G, int d) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float sums[COMBINE_WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = warp; b < G; b += COMBINE_WARPS) {
      acc += part[(size_t)b * d + c];
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < COMBINE_WARPS; ++k) t += sums[k][lane];
    dw[c] = t;
  }
}

template <typename T, int S, bool RING>
cudaError_t launch_rows(const Params& p, int blocks, int threads, size_t smem,
                        cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T, S, RING>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  rmsnorm_bwd_kernel<T, S, RING><<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_path(const Params& p, int blocks, int threads,
                        cudaStream_t stream) {
  constexpr size_t E = sizeof(T);
  const size_t head = ring_offset(threads);
  const size_t ring = (size_t)p.stages * 2 * p.d * E;
  const bool aligned =
      reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p.dy) % 16 == 0 && (p.sx * E) % 16 == 0 &&
      (p.sdy * E) % 16 == 0 && (p.d * E) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p.dx) % 16 == 0 && head + ring <= MAX_SMEM;
  return aligned ? launch_rows<T, S, true>(p, blocks, threads, head + ring,
                                           stream)
                 : launch_rows<T, S, false>(p, blocks, threads, head, stream);
}

template <typename T>
cudaError_t launch_slices(const Params& p, int blocks, int threads,
                          int slices, cudaStream_t stream) {
  switch (slices) {
    case 1:
      return launch_path<T, 1>(p, blocks, threads, stream);
    case 2:
      return launch_path<T, 2>(p, blocks, threads, stream);
    case 4:
      return launch_path<T, 4>(p, blocks, threads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy (n, d) with unit column stride and row strides sx, sdy (elements),
// x_kind = dy's kind: 0 bf16, 1 fp16, 2 fp32; w (d,) contiguous of
// w_kind; rstd (n,) fp32; dx (n, d) contiguous of x's kind; part (blocks,
// d) fp32 scratch; dw (d,) fp32.  blocks, threads, stages and slices as
// kernel.py:bwd_plan gives them: 1 <= blocks <= n, threads a multiple of
// 32 up to 512, threads * slices vectors of 16 bytes covering a row.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           const void* rstd, void* dx, void* part, void* dw,
                           int n, int d, long long sx, long long sdy,
                           int x_kind, int w_kind, int blocks, int threads,
                           int stages, int slices, void* stream) {
  const int esz = x_kind == K_F32 ? 4 : 2;
  const long long vecs = ((long long)d * esz + 15) / 16;
  if (n <= 0 || d <= 0 || blocks <= 0 || blocks > n || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || stages < 2 ||
      stages > MAX_STAGES || x_kind < 0 || x_kind > 2 || w_kind < 0 ||
      w_kind > 2 || (long long)threads * slices < vecs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.w = w;
  p.dy = dy;
  p.rstd = static_cast<const float*>(rstd);
  p.dx = dx;
  p.part = static_cast<float*>(part);
  p.dw = static_cast<float*>(dw);
  p.sx = sx;
  p.sdy = sdy;
  p.n = n;
  p.d = d;
  p.w_kind = w_kind;
  p.stages = stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_kind) {
    case K_BF16:
      err = launch_slices<__nv_bfloat16>(p, blocks, threads, slices, s);
      break;
    case K_F16:
      err = launch_slices<__half>(p, blocks, threads, slices, s);
      break;
    default:
      err = launch_slices<float>(p, blocks, threads, slices, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // programmatic dependent launch: the combine's blocks start once every
  // row block has started, and wait in the kernel for the row grid
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((d + 31) / 32));
  cfg.blockDim = dim3(COMBINE_WARPS * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rmsnorm_dw_combine_kernel,
                           static_cast<const float*>(part),
                           static_cast<float*>(dw), blocks, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
