// Shared helpers of the attention kernels: float32 / bfloat16 conversions
// and the finite "minus infinity" of the online softmax.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

// The Pallas kernels' finite NEG_INF: a fully masked score costs nothing
// (exp(NEG_INF - m) == 0 once m is real) and never makes a NaN.
constexpr float NEG_INF = -1e30f;

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
  return __float2bfloat16_rn(x);
}

// A value of type S read as type T, then widened to float32: the
// reference's ``x.astype(T).astype(float32)``, in registers.
template <typename T, typename S>
__device__ __forceinline__ float as_f(S x) {
  return to_f(from_f<T>(to_f(x)));
}

// Eight consecutive elements (16-byte aligned for bf16, 32 for f32) as
// float32, each first rounded to T.
template <typename T>
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = as_f<T>(v[e]);
}

template <typename T>
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      float out[8]) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = as_f<T>(v[e]);
}

}  // namespace attn
