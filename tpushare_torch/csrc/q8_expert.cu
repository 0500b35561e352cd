// Kernel 4 of the port: the batched MoE expert FFN straight off int8
// weights, on Hopper.
//
// Replaces tpushare/ops/q8_expert.py _q8_ffn_kernel behind
// q8_expert_ffn():
//   y[e] = (act((x . Wg[e]) * sg[e]) * ((x . Wu[e]) * su[e])) . Wd[e] * sd[e]
// x [C,Dm] (one token block every expert runs: dense dispatch) or
// [E,C,Dm] (per-expert token queues: capacity dispatch), f32 or bf16;
// wg/wu int8 [E,Dm,F] with f32 scales [E,1,F]; wd int8 [E,F,Dm] with
// f32 scales [E,1,Dm]; act silu or tanh-gelu; y [E,C,Dm] in x's type.
// Each per-output-channel scale multiplies the products after the dot,
// every sum is f32, as in the Pallas body and q8_expert_ffn_reference.
//
// Bound: at decode (C = the slots, 8) bytes: every int8 weight byte
// crosses HBM once per call (Mixtral-8x7B: 1.41 GB a layer); at prefill
// (C in the thousands under dense dispatch) operations. Design:
// - Weights never widen in device memory: each 32 x 128 int8 tile is
//   read with 16-byte loads, widened to f32 in shared memory, and the
//   next tile's loads are in flight while this one is used.
// - Two passes, no float atomics, so every sum has one fixed order:
//   pass 1 writes ff = act(g * sg) * (u * su) in f32 [E,C,F] over an
//   (F tile, C tile, expert) grid; pass 2 reduces ff . Wd over F for
//   each (Dm tile, C tile, expert) and applies sd. Both grids span the
//   output columns, so a decode call still fills the card (Mixtral:
//   112 x 8 blocks in pass 1, 32 x 8 in pass 2) rather than one block
//   per expert.
// - C is tiled too (8 rows a tile for C <= 16, else 32), so prefill
//   blocks of any length run; rows past C read zeros and store nothing.
// - f32 FMAs on register tiles (each thread 2 or 8 rows x 2 columns,
//   the row values broadcast across a warp); tensor cores are the
//   follow-up.

#include "common.cuh"

namespace {

constexpr int NT = 256;         // threads per block
constexpr int TX = 64;          // threads across the output columns
constexpr int TY = NT / TX;     // threads across the rows
constexpr int MC = 2;           // output columns per thread
constexpr int BN = TX * MC;     // output columns per block
constexpr int BK = 32;          // contraction depth per tile
constexpr int WCH = BN / 16;    // 16-byte weight chunks per tile row

enum TsAct { ACT_SILU = 0, ACT_GELU = 1 };

__device__ __forceinline__ float apply_act(int act, float x) {
  if (act == ACT_SILU) return x / (1.f + expf(-x));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ void widen16(uint4 raw, float* dst) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// One pass of the FFN as a tiled product with int8 B operands.
// DUAL (pass 1): a = x, w1/w2 = wg/wu, out = ff (f32).
// !DUAL (pass 2): a = ff, w1 = wd, out = y (x's type).
// a [*, C, K] with expert stride a_es (0 = shared rows); w [E, K, N].
template <typename TA, typename TO, int MR, bool DUAL>
__global__ void __launch_bounds__(NT)
q8_pass(const TA* __restrict__ a, long long a_es,
        const int8_t* __restrict__ w1, const int8_t* __restrict__ w2,
        const float* __restrict__ s1, const float* __restrict__ s2,
        TO* __restrict__ out, int C, int K, int N, int act) {
  constexpr int BM = TY * MR;
  __shared__ float As[BK][BM + 1];
  __shared__ __align__(16) float W1s[BK][BN];
  __shared__ __align__(16) float W2s[DUAL ? BK : 1][DUAL ? BN : 4];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const TA* ae = a + e * a_es;
  const size_t wbase = (size_t)e * K * N;
  const int wk = tid / WCH, wc = (tid % WCH) * 16;  // this thread's chunk
  float acc1[MR][MC] = {}, acc2[MR][MC] = {};

  auto wload = [&](const int8_t* w, int k0) {
    return *reinterpret_cast<const uint4*>(w + wbase +
                                           (size_t)(k0 + wk) * N + n0 + wc);
  };
  uint4 r1 = wload(w1, 0), r2 = DUAL ? wload(w2, 0) : uint4{};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      As[kk][r] = m0 + r < C
                      ? ts_to_f(ae[(size_t)(m0 + r) * K + k0 + kk])
                      : 0.f;
    }
    widen16(r1, &W1s[wk][wc]);
    if constexpr (DUAL) widen16(r2, &W2s[wk][wc]);
    __syncthreads();
    if (k0 + BK < K) {          // next tile's loads fly during this one
      r1 = wload(w1, k0 + BK);
      if constexpr (DUAL) r2 = wload(w2, k0 + BK);
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) av[i] = As[kk][ty * MR + i];
      const float2 b1 = *reinterpret_cast<const float2*>(&W1s[kk][tx * MC]);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        acc1[i][0] = fmaf(av[i], b1.x, acc1[i][0]);
        acc1[i][1] = fmaf(av[i], b1.y, acc1[i][1]);
      }
      if constexpr (DUAL) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(&W2s[kk][tx * MC]);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          acc2[i][0] = fmaf(av[i], b2.x, acc2[i][0]);
          acc2[i][1] = fmaf(av[i], b2.y, acc2[i][1]);
        }
      }
    }
    __syncthreads();
  }
  const int n = n0 + tx * MC;
  const float* s1e = s1 + (size_t)e * N;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int m = m0 + ty * MR + i;
    if (m >= C) continue;
    TO* dst = out + ((size_t)e * C + m) * N + n;
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if constexpr (DUAL) {
        const float g = acc1[i][j] * s1e[n + j];
        const float u = acc2[i][j] * s2[(size_t)e * N + n + j];
        dst[j] = apply_act(act, g) * u;
      } else {
        dst[j] = ts_from_f<TO>(acc1[i][j] * s1e[n + j]);
      }
    }
  }
}

template <typename T, int MR>
cudaError_t run(const void* x, bool shared, const int8_t* wgq,
                const float* wgs, const int8_t* wuq, const float* wus,
                const int8_t* wdq, const float* wds, float* ff, void* y,
                int E, int C, int Dm, int F, int act, cudaStream_t s) {
  constexpr int BM = TY * MR;
  const dim3 g1(F / BN, (C + BM - 1) / BM, E), g2(Dm / BN, g1.y, E);
  q8_pass<T, float, MR, true><<<g1, NT, 0, s>>>(
      static_cast<const T*>(x), shared ? 0LL : (long long)C * Dm, wgq, wuq,
      wgs, wus, ff, C, Dm, F, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q8_pass<float, T, MR, false><<<g2, NT, 0, s>>>(
      ff, (long long)C * F, wdq, nullptr, wds, nullptr, static_cast<T*>(y),
      C, F, Dm, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* x, bool shared, const int8_t* wgq,
                          const float* wgs, const int8_t* wuq,
                          const float* wus, const int8_t* wdq,
                          const float* wds, float* ff, void* y, int E, int C,
                          int Dm, int F, int act, cudaStream_t s) {
  if (C <= 16)    // decode ticks: 8-row tiles waste no FMAs on padding
    return run<T, 2>(x, shared, wgq, wgs, wuq, wus, wdq, wds, ff, y, E, C,
                     Dm, F, act, s);
  return run<T, 8>(x, shared, wgq, wgs, wuq, wus, wdq, wds, ff, y, E, C, Dm,
                   F, act, s);
}

}  // namespace

// C entry point (loaded with ctypes by ops/q8_expert.py). x: [C,Dm] when
// shared != 0, else [E,C,Dm]; dtype: x and y type, 0 = f32, 1 = bf16;
// act: 0 = silu, 1 = tanh-gelu; ff: f32 scratch [E,C,F] the caller
// allocates. Dm and F must be multiples of 128. Returns the cudaError_t
// of the launches.
extern "C" int ts_q8_expert_ffn(const void* x, const void* wgq,
                                const void* wgs, const void* wuq,
                                const void* wus, const void* wdq,
                                const void* wds, void* ff, void* y, int E,
                                int C, int Dm, int F, int shared, int dtype,
                                int act, void* stream) {
  if (E <= 0 || C <= 0 || Dm <= 0 || F <= 0 || Dm % BN || F % BN ||
      (act != ACT_SILU && act != ACT_GELU))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* gq = static_cast<const int8_t*>(wgq);
  auto* uq = static_cast<const int8_t*>(wuq);
  auto* dq = static_cast<const int8_t*>(wdq);
  auto* gs = static_cast<const float*>(wgs);
  auto* us = static_cast<const float*>(wus);
  auto* ds = static_cast<const float*>(wds);
  float* f = static_cast<float*>(ff);
  if (dtype == TS_F32)
    return (int)dispatch_rows<float>(x, shared != 0, gq, gs, uq, us, dq, ds,
                                     f, y, E, C, Dm, F, act, s);
  if (dtype == TS_BF16)
    return (int)dispatch_rows<__nv_bfloat16>(x, shared != 0, gq, gs, uq, us,
                                             dq, ds, f, y, E, C, Dm, F, act,
                                             s);
  return (int)cudaErrorInvalidValue;
}
