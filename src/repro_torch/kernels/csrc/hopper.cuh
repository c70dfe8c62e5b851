// Hopper (sm_90a) building blocks of the attention kernels (the flash
// forward and backward, paged chunk attention), the rmsnorm backward and
// the SSD chunk scan:
// TMA tensor maps and loads, 1-D bulk copies, mbarriers, named barriers,
// register reallocation between warpgroups, and warpgroup matrix
// multiplies (wgmma) with shared-memory descriptors and register A
// operands.
//
// Shared-memory tiles are kept in the layout that a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 64 bf16 (128 bytes), 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), each tile 1024-byte
// aligned.  A matrix wider than 64 columns is loaded as 64-column
// "halves", one TMA box each, stored one after the other.  Two views of
// such a tile feed wgmma:
//
// - K-major (desc_kmajor): the tile's columns are the product's K axis
//   and its rows are M or N.  Rows repeat in groups of 8 every 1024 bytes
//   (the stride byte offset); the k-th group of 16 columns starts
//   (k % 4) * 32 bytes into half k / 4.
// - MN-major (desc_mnmajor, trans-b = 1): the tile's rows are K and its
//   columns are N.  K repeats in groups of 8 rows every 1024 bytes (the
//   stride byte offset), N in 64-column halves every `half_bytes` (the
//   leading byte offset); the k-th group of 16 rows starts k * 2048 bytes
//   in.
//
// Accumulators follow wgmma's register layout: in a 64 x N fp32 result,
// warp w of the warpgroup holds rows 16w..16w+15, and lane l holds, for
// each 8-column group j, rows 16w + l/4 (+ 8) and columns 8j + 2(l%4)
// (+ 1) as d[4j + 2i + c] (row + 8i, column + c).  acc_to_a repacks such
// a result, rounded to bf16, as the register A operand of a following
// product whose K axis is the result's columns -- so S and P of the
// attention forward, and S, P, dP and dS of its backward, never touch
// shared memory; acc_to_a_parts passes an fp32 result as two or three
// such operands (hi, lo or hi, mid, lo).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------ host side ----------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess &&
        p != nullptr) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A 4-D map over bf16 (batch, seq, head, d) rows addressed through element
// strides (any order; d contiguous), read in boxes of `box_rows` rows x 64
// columns of one head, 128-byte swizzled.  Rows past `rows` read as zeros.
// Each row must start 16-byte aligned (the strides a multiple of 8 bf16):
// a box that starts 4- but not 16-byte aligned, as in a (b, h, s) fp32
// vector with odd s, raised an illegal instruction on the H100, and the
// driver refused a rank-1 map.
inline cudaError_t map_rows_bf16(CUtensorMap* map, const void* base, int d,
                                 int rows, int heads, int batch,
                                 long long stride_s, long long stride_h,
                                 long long stride_b, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)stride_s * 2,
                                 (cuuint64_t)stride_h * 2,
                                 (cuuint64_t)stride_b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ----------------------------- device side ---------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and expect `bytes` of TMA traffic before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one box of a 4-D map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// 1-D bulk copy of `bytes` contiguous bytes from global memory into
// shared memory, completing on `bar` (no tensor map).  `bytes`, `dst`
// and `src` must be multiples of 16.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) of `count` threads:
// wait for it, or arrive on it without waiting.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Registers: a producer warpgroup gives its registers back, consumers take
// them (all four warps of a warpgroup execute these together).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand starting
// at shared address `addr` (byte offsets as in the header comment).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// The k-th 16-column slice of a K-major tile of 64-column halves, each
// `half_bytes` long.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int k,
                                                uint32_t half_bytes) {
  return desc_sw128(tile + (k / 4) * half_bytes + (k % 4) * 32, 16, 1024);
}

// The k-th 16-row slice of an MN-major tile of 64-column halves, each
// `half_bytes` long.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int k,
                                                 uint32_t half_bytes) {
  return desc_sw128(tile + k * 2048, half_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep registers that a wgmma in flight reads (a register A operand) or
// writes (its accumulator) where they are, up to this point: the compiler
// may neither move nor reuse them in between, nor move their other uses
// across a wait.  ptxas serializes every wgmma of a kernel in which an
// instruction other than a wgmma defines a wgmma's input between
// wgmma_fence and the wait that retires it, so a product's descriptors
// and register operands are made before its wgmma_fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// 2^x on the special-function unit, denormal results flushed to 0 (exp2f
// adds a range reduction for them): one instruction
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns 16k..16k+15 of a 64 x N fp32 accumulator, rounded to bf16, as
// the register A operand (rows x 16 of K) of a following wgmma.
template <int M>
__device__ __forceinline__ void acc_to_a(const float (&d)[M], int k,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16x2(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16x2(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16x2(d[8 * k + 6], d[8 * k + 7]);
}

// acc_to_a for an fp32 operand that bf16 alone would round too coarsely:
// each value v as PARTS bf16 terms, hi = bf16(v), then bf16 of what is
// left, ..., as PARTS register A operands whose products added in one
// fp32 accumulator carry v to about 2^-8 PARTS of itself (2: ~2^-17, 3:
// fp32's own rounding).
template <int PARTS, int M>
__device__ __forceinline__ void acc_to_a_parts(const float (&d)[M], int k,
                                               uint32_t (&a)[PARTS][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v0 = d[8 * k + 2 * q], v1 = d[8 * k + 2 * q + 1];
#pragma unroll
    for (int j = 0; j < PARTS; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      const float2 hf = __bfloat1622float2(h);
      a[j][q] = *reinterpret_cast<const uint32_t*>(&h);
      v0 -= hf.x;
      v1 -= hf.y;
    }
  }
}

// D[64 x 64] (+)= A B, A and B from shared memory (descriptors).  TRANS_A
// = 1 reads A M-major: its tile's rows are the K axis and its columns M,
// described as an MN-major operand (desc_mnmajor).
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B), "n"(TRANS_A));
}

// D[64 x 64] (+)= A B, A from registers (four bf16x2 a thread in the
// accumulator's layout, see acc_to_a), B from shared memory (descriptor)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TRANS_B));
}

// D[64 x 128] (+)= A B, A from registers (four bf16x2 a thread in the
// accumulator's layout, see acc_to_a), B from shared memory (descriptor)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TRANS_B));
}

// acc (64 x HD) += A (64 x 16, registers) B (16 x HD, MN-major): the
// second product of attention (O += P V, dQ += dS K, ...), HD 64 or 128.
template <int HD>
__device__ __forceinline__ void mma_rs(float (&acc)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 128) {
    wgmma_rs_n128<1>(acc, a, db, 1);
  } else {
    wgmma_rs_n64<1>(acc, a, db, 1);
  }
}

}  // namespace hopper
