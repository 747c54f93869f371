// Shared helpers for the hand-written attention kernels (sm_90a).
//
// Every kernel computes in fp32 and takes bf16 or fp32 tensors.  Masked
// keys are picked out with a select and never multiplied by zero: a paged
// pool's unused slots may hold anything, Inf and NaN included.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#define NEG_INF_F (-1e30f)

enum DType { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load E consecutive elements (E*sizeof(T) bytes, aligned to that size by
// the callers' layouts) into fp32 registers.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         float (&dst)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = to_f(src[e]);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* __restrict__ src, float (&dst)[4]) {
  uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
}

template <>
__device__ __forceinline__ void load_vec<float, 4>(
    const float* __restrict__ src, float (&dst)[4]) {
  float4 raw = *reinterpret_cast<const float4*>(src);
  dst[0] = raw.x; dst[1] = raw.y; dst[2] = raw.z; dst[3] = raw.w;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
