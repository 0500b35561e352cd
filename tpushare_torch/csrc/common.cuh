// Shared device helpers for the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
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

// Rows [s0, s0+ROWS) of head hx of a contiguous [B, S, Hx, D] tensor
// into a [ROWS][D+1] f32 shared tile (the +1 pad keeps column walks free
// of bank conflicts), times mul; rows past S are zero. NTH threads share
// the copy, 8 elements (one 16-byte bf16 load) each.
template <typename T, int D, int ROWS, int NTH>
__device__ __forceinline__ void ts_load_tile(float* dst, const T* src, int b,
                                             int s0, int S, int Hx, int hx,
                                             float mul) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTH) {
    const int r = i / CH, c = (i % CH) * 8, s = s0 + r;
    float v[8];
    if (s < S) {
      ts_load8(src + (((size_t)b * S + s) * Hx + hx) * D + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * (D + 1) + c + e] = v[e] * mul;
  }
}

// First key (relative to the chunk, rounded down to a tile of BLK) and
// end (exclusive) that a run of queries at absolute positions
// [first, last] may attend in a KV chunk of Sk keys starting at absolute
// position k_offset: causal up to last, window floor from first. The one
// copy of the live-range rule the prefill, partial and gradient kernels
// share; an empty range (a chunk wholly in the future) has end <= begin.
template <int BLK>
__device__ __forceinline__ void ts_key_range(long long first, long long last,
                                             int k_offset, int Sk,
                                             long long w_eff, int& begin,
                                             int& end) {
  end = (int)max(0LL, min((long long)Sk, last + 1 - k_offset));
  const long long lo = first - w_eff + 1 - k_offset;
  begin = lo > 0 ? (int)min((long long)Sk, (lo / BLK) * BLK) : 0;
}

// The converse, for the gradient's dk/dv pass: the query rows (relative
// to q; begin rounded down to a tile of BLK) that can see a key at an
// absolute position in [kfirst, klast] — causal from the first key,
// inside the window of the last; end <= begin when none can.
template <int BLK>
__device__ __forceinline__ void ts_query_range(long long kfirst,
                                               long long klast, int q_offset,
                                               int Sq, long long w_eff,
                                               int& begin, int& end) {
  const long long r_lo = max(0LL, kfirst - q_offset);
  begin = (int)min((long long)Sq, (r_lo / BLK) * BLK);
  end = (int)max(0LL, min((long long)Sq, klast + w_eff - q_offset));
}

// The causal/window mask relative to the row: key kc (relative to the
// chunk) is live for query row r (relative to q) iff kc < Sk and d_lo <
// kc - r <= d_hi, d_hi = q_offset - k_offset (causal edge), d_lo = d_hi -
// w_eff (window floor), each clamped to int so the test is 32-bit.
__device__ __forceinline__ void ts_rel_limits(int q_offset, int k_offset,
                                              long long w_eff, int& d_lo,
                                              int& d_hi) {
  const long long hi = (long long)q_offset - k_offset;
  d_hi = (int)max((long long)INT_MIN, min((long long)INT_MAX, hi));
  d_lo = (int)max((long long)INT_MIN, min((long long)INT_MAX, hi - w_eff));
}
