// Shared device helpers for the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Masked logit: large-negative instead of -inf keeps the online
// softmax NaN-free (the same constant as ops/attention.py NEG_INF).
#define TS_NEG_INF (-1e30f)
// Window span standing in for "global" (window <= 0).
#define TS_GLOBAL_SPAN (1 << 30)

// Element type codes of the C entry points (ops/flash_attention.py
// _DTYPE_CODE and _I8): q and output are f32 or bf16; paged pools hold
// the q type or int8 (with f32 scale pages).
enum TsDtype { TS_F32 = 0, TS_BF16 = 1, TS_I8 = 2 };

__device__ __forceinline__ float ts_to_f(float x) { return x; }
__device__ __forceinline__ float ts_to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T ts_from_f(float x);
template <> __device__ __forceinline__ float ts_from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 ts_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load 8 consecutive elements (16-byte aligned source) as f32.
__device__ __forceinline__ void ts_load8(const __nv_bfloat16* src,
                                         float out[8]) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void ts_load8(const float* src, float out[8]) {
  float4 a = *reinterpret_cast<const float4*>(src);
  float4 b = *reinterpret_cast<const float4*>(src + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Load 8 consecutive int8 values (8-byte aligned source) as f32; the
// caller multiplies by the row's scale.
__device__ __forceinline__ void ts_load8(const int8_t* src, float out[8]) {
  uint2 raw = *reinterpret_cast<const uint2*>(src);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(v[i]);
}

// Python-style floor division (the live-range rounding in
// ops/flash_attention.py rounds negative numerators down).
__device__ __forceinline__ long long ts_floordiv(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float ts_softcap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}
