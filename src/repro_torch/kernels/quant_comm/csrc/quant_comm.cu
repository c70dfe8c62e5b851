// Blockwise absmax int8 quantize / dequantize for Hopper (sm_90a): the
// int8 wire format of HFReduce's cross-pod phase (core/compression.py:
// int8_psum).
//
// Replaces the TPU kernels src/repro/kernels/quant_comm/kernel.py:
// quantize_fwd (_quant_kernel) and dequantize_fwd (_dequant_kernel).
//
// Quantize, per block of 256 elements of x (n,) fp32 or bf16 (read as
// fp32, as the TPU kernel's astype does):
//   absmax = max |x|,  scale = absmax * fl(1/127)
//   q = clip(round_half_even(x / max(scale, 1e-12)), -127, 127) as int8
// Outputs q (n,) int8 and the scales (n/256,) fp32.  The arithmetic is
// that of the jitted quantize_blockwise, which XLA compiles with
// absmax / 127 folded into a multiply by fl(1/127) and a true division
// for the codes; the TPU kernel multiplies by fl(1/scale) instead, which
// can round a value on a k + 0.5 boundary one code apart.  Every step is
// written with an explicit rounding (__fmul_rn, __fdiv_rn, rintf under
// the default round-to-nearest-even), and the source must not be
// compiled with fast math.
//
// Dequantize: out = q * scale[block] (__fmul_rn), written as fp32 or as
// bf16 (round to nearest even from the fp32 product).
//
// What bounds it on the H100: both kernels read and write each element
// once (quantize 4 or 2 + 1 + 4/256 bytes per element, dequantize
// 1 + 4/256 + 4 or 2) and do a few operations per byte, so device memory
// bounds them.  The design is the simple one that is exact: quantize
// runs one warp per 256-element block, each lane loading 8 contiguous
// elements with 16-byte loads, the absmax reduced with warp shuffles, the
// 8 codes stored as one 8-byte word and the scale by lane 0; dequantize
// runs one thread per 4 codes (a 4-byte load; 4 codes never straddle a
// block).  The wrapper passes 16-byte aligned buffers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;                 // elements per scale
constexpr int kPerLane = kBlock / 32;       // 8
constexpr int kWarps = 8;                   // quant blocks per CTA
constexpr int kThreads = 256;               // dequantize: threads per CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 1.0f / 127.0f;    // fl(1/127)
constexpr float kMinScale = 1e-12f;

__device__ __forceinline__ void load8(const float* p, float (&v)[kPerLane]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kPerLane]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long nblocks) {
  const int lane = threadIdx.x & 31;
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= nblocks) return;                 // the whole warp leaves
  const long long base = blk * kBlock + lane * kPerLane;
  float v[kPerLane];
  load8(x + base, v);
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) m = fmaxf(m, fabsf(v[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const float scale = __fmul_rn(m, kInv127);
  const float den = fmaxf(scale, kMinScale);
  union {
    int8_t b[kPerLane];
    uint2 w;
  } out;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float r = rintf(__fdiv_rn(v[j], den));
    out.b[j] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  *reinterpret_cast<uint2*>(q + base) = out.w;
  if (lane == 0) s[blk] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  T* __restrict__ out, long long n4) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n4) return;
  const char4 c = reinterpret_cast<const char4*>(q)[t];
  const float sc = s[(t * 4) / kBlock];
  const float v[4] = {__fmul_rn(static_cast<float>(c.x), sc),
                      __fmul_rn(static_cast<float>(c.y), sc),
                      __fmul_rn(static_cast<float>(c.z), sc),
                      __fmul_rn(static_cast<float>(c.w), sc)};
  store4(out + 4 * t, v);
}

}  // namespace

// x (nblocks * 256,) -> q (nblocks * 256,) int8, s (nblocks,) fp32.
// dtype: 0 fp32, 1 bf16.
extern "C" int quantize_blockwise(const void* x, void* q, void* s,
                                  long long nblocks, int dtype,
                                  void* stream) {
  if (nblocks <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((nblocks + kWarps - 1) / kWarps);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(s);
  if (dtype == 0) {
    quantize_kernel<float><<<grid, 32 * kWarps, 0, st>>>(
        static_cast<const float*>(x), qo, so, nblocks);
  } else {
    quantize_kernel<__nv_bfloat16><<<grid, 32 * kWarps, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qo, so, nblocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (n,) int8, s (n / 256,) fp32 -> out (n,); n % 256 == 0.
// out_dtype: 0 fp32, 1 bf16.
extern "C" int dequantize_blockwise(const void* q, const void* s, void* out,
                                    long long n, int out_dtype,
                                    void* stream) {
  if (n <= 0 || n % kBlock != 0 || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n4 = n / 4;
  const unsigned grid = static_cast<unsigned>((n4 + kThreads - 1) / kThreads);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* si = static_cast<const float*>(s);
  if (out_dtype == 0) {
    dequantize_kernel<float><<<grid, kThreads, 0, st>>>(
        qi, si, static_cast<float*>(out), n4);
  } else {
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        qi, si, static_cast<__nv_bfloat16*>(out), n4);
  }
  return static_cast<int>(cudaGetLastError());
}
