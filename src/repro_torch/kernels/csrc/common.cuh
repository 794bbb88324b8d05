// Shared device helpers of the port's attention kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dsa {

// Masked-score sentinel of the Pallas bodies: exp(NEG - m) underflows to
// exactly 0 against any live score.
constexpr float NEG = -1e30f;

// dtype codes of the C interfaces
enum Dtype : int { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

// Narrow cache storage (int8, fp8 e4m3): every (row, head) carries one f32
// scale, and a row is dequantized as it is loaded.
template <typename T> struct Narrow { static constexpr bool value = false; };
template <> struct Narrow<int8_t> { static constexpr bool value = true; };
template <> struct Narrow<__nv_fp8_e4m3> { static constexpr bool value = true; };

__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float o[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// Four narrow values times their row's scale, from one 4-byte load.
// __fmul_rn rounds each product to f32 on its own (nvcc may not contract
// it into the FMA that consumes it), so a kernel reading narrow rows
// computes exactly what it computes on the f32 rows dequant(q, scale).
__device__ __forceinline__ void load4(const int8_t* p, float s, float o[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = __fmul_rn(static_cast<float>(v.x), s);
  o[1] = __fmul_rn(static_cast<float>(v.y), s);
  o[2] = __fmul_rn(static_cast<float>(v.z), s);
  o[3] = __fmul_rn(static_cast<float>(v.w), s);
}

__device__ __forceinline__ void load4(const __nv_fp8_e4m3* p, float s,
                                      float o[4]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8_e4m3 e;
    e.__x = static_cast<__nv_fp8_storage_t>((u >> (8 * i)) & 0xffu);
    o[i] = __fmul_rn(static_cast<float>(e), s);
  }
}

// Full-width rows carry no scale.
template <typename T>
__device__ __forceinline__ void load4(const T* p, float, float o[4]) {
  load4(p, o);
}

// Element offset of the first row of a selected cache block: row blk0 of
// the dense cache of a batch row whose first element is `base` (K1, K3),
// or the first row of physical page pidx[j] of a pool (K4, K5).  `ss` is
// the row stride, so the same function places the rows' scales.
template <bool PAGED>
__device__ __forceinline__ int64_t block_rows(const int32_t* pidx, int64_t j,
                                              int blk0, int block_k,
                                              int64_t base, int64_t ss) {
  if (PAGED) return (int64_t)pidx[j] * block_k * ss;
  return base + (int64_t)blk0 * ss;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Two adjacent values (8 or 4 bytes aligned).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float x[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// cp.async: a raw copy from device to shared memory that the issuing
// thread does not wait for; 16 bytes through L2 only (.cg), or 4 (.ca).
// commit_group closes the copies issued so far into one group and
// wait_group<N> waits until at most N groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of `nch` 16-byte chunks from device memory (row stride
// `gs` elements of T) to shared memory (row stride `srs` bytes) with
// cp.async, the block's THREADS threads on neighbouring chunks.  Where
// THREADS is a multiple of nch (every hd a power of two) a thread keeps
// one column of chunks and strides over rows; otherwise each chunk is
// placed by a division.
template <int THREADS, typename T>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int srs,
                                          const T* src, int64_t gs, int rows,
                                          int nch, int tid) {
  constexpr int E = 16 / sizeof(T);
  if (THREADS % nch == 0) {
    const int c = tid % nch;
    for (int r = tid / nch; r < rows; r += THREADS / nch)
      cp_async16(dst + r * srs + c * 16, src + r * gs + c * E);
  } else {
    for (int ci = tid; ci < rows * nch; ci += THREADS) {
      const int r = ci / nch, c = ci - r * nch;
      cp_async16(dst + r * srs + c * 16, src + r * gs + c * E);
    }
  }
}

// Let `kern` take `bytes` of dynamic shared memory (above 48 KB a kernel
// must opt in).  The attribute persists, so it is set once per device.
template <typename Kern>
inline cudaError_t allow_smem(Kern kern, int bytes, int (&granted)[32]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 32) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (granted[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) granted[dev] = bytes;
  return e;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace dsa
