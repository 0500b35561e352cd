// Kernel 9 of the port: the attention gradient on Hopper (FA2 form).
//
// The JAX package has no counterpart: it never wrote a backward kernel
// (no custom_vjp under tpushare/), and jax 0.9.0's pallas_call registers
// a JVP rule and no transpose, so its training steps differentiate the
// plain reference paths. This kernel is the derivative of _fa_kernel
// (tpushare/ops/flash_attention.py:105, normal and partial=True) that the
// port's training path needs: flash_attention_bwd() in
// ops/flash_attention.py, called by the autograd Functions around
// flash_attention (single device) and ring attention (one call per hop).
//
// Contract: q, dout [B,Sq,H,D]; k, v [B,Sk,Hkv,D]; f32 or bf16, one
// type, contiguous, D in {128,256}; lse and dsum f32 [B,H,Sq]: the FINAL
// per-row log-sum-exp m + log(l) of the whole softmax (over every ring
// hop) and rowsum(dout * out). q_offset / k_offset / window / softcap /
// scale as in flash_prefill.cu. With s = softcap(scale*q.k) masked as
// there, p = exp(s - lse) where the mask keeps (masked p is 0 by the
// mask, never by magnitude), dp = dout.v, ds = p (dp - dsum) times the
// softcap factor 1 - tanh^2(scale*q.k/cap):
//   dv[j] = sum_i p[i,j] dout[i]       dk[j] = scale sum_i ds[i,j] q[i]
//   dq[i] = scale sum_j ds[i,j] k[j]
// dk and dv sum over the query heads of each GQA group. Outputs are f32
// (dq [B,Sq,H,D], dk/dv [B,Sk,Hkv,D]) so a ring can accumulate hops and
// round once at the owner.
//
// Two passes, no float atomics, so the result is deterministic:
//   dkdv: one block per (32-key tile, b * Hkv + kv head). K and V stay in
//         shared memory; the block walks the q tiles that can see its
//         keys (causal from the first key, window up to the last) for
//         each head of the group, recomputes p and ds, and accumulates
//         dk and dv in registers.
//   dq:   one block per (64-row q tile, head, batch). Q and dout stay in
//         shared memory; the block walks the key tiles in the q tile's
//         live range (the forward kernel's) and accumulates dq.
// Bound: operations at training lengths, like the forward. This first
// version does all products with f32 FMAs out of shared memory (the
// score and dp products are computed in both passes, 14 D FMA-pairs per
// live (query, key) pair against the 10 D an atomics-based single pass
// needs); tensor cores are later work. Tiles are f32 with a padded row
// stride (D+1); at D = 256 a pass takes ~210 KB of shared memory, one
// block per SM.

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 32;        // key rows per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 lanes
constexpr int RQ = BQ / 16;   // query rows per thread (score tile, dq)
constexpr int CK = BK / 16;   // key columns per thread (score tile)
constexpr int RK = BK / 16;   // key rows per thread (dk, dv)

template <int D>
constexpr size_t smem_dkdv() {
  return sizeof(float) *
         (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1) +
                  2 * BQ);
}

template <int D>
constexpr size_t smem_dq() {
  return sizeof(float) *
         (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) +
                  2 * BQ);
}

struct Geo {
  int Sq, Sk, H, Hkv, q_offset, k_offset, window;
  float scale, softcap;
};

// lse and dsum of rows [q0, q0+BQ) of head h into shared memory (0 past
// Sq: those rows are masked anyway).
__device__ __forceinline__ void load_rows(float* Ls, float* Ds,
                                          const float* lse,
                                          const float* dsum, int b, int h,
                                          int q0, const Geo& g) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int s = q0 + r;
    const size_t at = ((size_t)b * g.H + h) * g.Sq + s;
    Ls[r] = s < g.Sq ? lse[at] : 0.f;
    Ds[r] = s < g.Sq ? dsum[at] : 0.f;
  }
}

// One (BQ x BK) tile of p and ds for thread (ty, tx): rows ty*RQ + i,
// key columns tx + 16 j. Qs holds scale * q, so the scores match the
// forward kernel's.
template <int D>
__device__ __forceinline__ void tile_p_ds(const float* Qs, const float* Os,
                                          const float* Ks, const float* Vs,
                                          const float* Ls, const float* Ds,
                                          int q0, int k0, const Geo& g,
                                          float p[RQ][CK],
                                          float ds[RQ][CK]) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = Qs[(ty * RQ + i) * DP + d];
      ov[i] = Os[(ty * RQ + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kv[j] = Ks[(tx + 16 * j) * DP + d];
      vv[j] = Vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
  const long long w_eff = g.window > 0 ? g.window : TS_GLOBAL_SPAN;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    const long long qpos = (long long)g.q_offset + q0 + r;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int kc = k0 + tx + 16 * j;
      const long long kpos = (long long)g.k_offset + kc;
      const bool keep = q0 + r < g.Sq && kc < g.Sk && kpos <= qpos &&
                        kpos > qpos - w_eff;
      float s = sc[i][j], dcap = 1.f;
      if (g.softcap > 0.f) {
        const float t = tanhf(s / g.softcap);
        s = g.softcap * t;
        dcap = 1.f - t * t;
      }
      const float pv = keep ? expf(s - Ls[r]) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - Ds[r]) * dcap;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            float* __restrict__ dk, float* __restrict__ dv, Geo g) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  constexpr int PP = BK + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * DP;
  float* Qs = Vs + BK * DP;
  float* Os = Qs + BQ * DP;
  float* Ps = Os + BQ * DP;   // [BQ][BK+1]
  float* Ss = Ps + BQ * PP;   // [BQ][BK+1] ds
  float* Ls = Ss + BQ * PP;
  float* Ds = Ls + BQ;

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / g.Hkv, kvh = blockIdx.y % g.Hkv;
  const int G = g.H / g.Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long w_eff = g.window > 0 ? g.window : TS_GLOBAL_SPAN;

  ts_load_tile<T, D, BK, NT>(Ks, k, b, k0, g.Sk, g.Hkv, kvh, 1.f);
  ts_load_tile<T, D, BK, NT>(Vs, v, b, k0, g.Sk, g.Hkv, kvh, 1.f);

  float dka[RK][DC], dva[RK][DC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // Query rows (relative to q) that can see a key of this tile: causal
  // from its first key, inside the window of its last.
  const long long kfirst = (long long)g.k_offset + k0;
  const long long klast = (long long)g.k_offset + min(k0 + BK, g.Sk) - 1;
  const long long r_lo = max(0LL, kfirst - g.q_offset);
  const int q_begin = (int)min((long long)g.Sq, (r_lo / BQ) * BQ);
  const int q_end =
      (int)max(0LL, min((long long)g.Sq, klast + w_eff - g.q_offset));

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // K/V landed; the previous tile is consumed
      ts_load_tile<T, D, BQ, NT>(Qs, q, b, q0, g.Sq, g.H, h, g.scale);
      ts_load_tile<T, D, BQ, NT>(Os, dout, b, q0, g.Sq, g.H, h, 1.f);
      load_rows(Ls, Ds, lse, dsum, b, h, q0, g);
      __syncthreads();
      float p[RQ][CK], ds[RQ][CK];
      tile_p_ds<D>(Qs, Os, Ks, Vs, Ls, Ds, q0, k0, g, p, ds);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          Ps[(ty * RQ + i) * PP + tx + 16 * j] = p[i][j];
          Ss[(ty * RQ + i) * PP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dv += p^T dout, dk += ds^T (scale q): key rows ty*RK + i.
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[RK], sr[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = Ps[r * PP + ty * RK + i];
          sr[i] = Ss[r * PP + ty * RK + i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float ov = Os[r * DP + tx + 16 * c];
          const float qv = Qs[r * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dva[i][c] = fmaf(pr[i], ov, dva[i][c]);
            dka[i][c] = fmaf(sr[i], qv, dka[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int s = k0 + ty * RK + i;
    if (s >= g.Sk) continue;
    const size_t row = (((size_t)b * g.Sk + s) * g.Hkv + kvh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[row + tx + 16 * c] = dka[i][c];
      dv[row + tx + 16 * c] = dva[i][c];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          float* __restrict__ dq, Geo g) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  constexpr int PP = BK + 1;
  float* Qs = smem;
  float* Os = Qs + BQ * DP;
  float* Ks = Os + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ss = Vs + BK * DP;   // [BQ][BK+1] ds
  float* Ls = Ss + BQ * PP;
  float* Ds = Ls + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (g.H / g.Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long w_eff = g.window > 0 ? g.window : TS_GLOBAL_SPAN;

  ts_load_tile<T, D, BQ, NT>(Qs, q, b, q0, g.Sq, g.H, h, g.scale);
  ts_load_tile<T, D, BQ, NT>(Os, dout, b, q0, g.Sq, g.H, h, 1.f);
  load_rows(Ls, Ds, lse, dsum, b, h, q0, g);

  float dqa[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[i][c] = 0.f;

  int k_begin, k_end;
  ts_key_range<BK>((long long)g.q_offset + q0,
                   (long long)g.q_offset + min(q0 + BQ, g.Sq) - 1,
                   g.k_offset, g.Sk, w_eff, k_begin, k_end);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q landed; the previous tile is consumed
    ts_load_tile<T, D, BK, NT>(Ks, k, b, k0, g.Sk, g.Hkv, kvh, 1.f);
    ts_load_tile<T, D, BK, NT>(Vs, v, b, k0, g.Sk, g.Hkv, kvh, 1.f);
    __syncthreads();
    float p[RQ][CK], ds[RQ][CK];
    tile_p_ds<D>(Qs, Os, Ks, Vs, Ls, Ds, q0, k0, g, p, ds);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j)
        Ss[(ty * RQ + i) * PP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq += ds k: query rows ty*RQ + i, columns tx + 16 c.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = Ss[(ty * RQ + i) * PP + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float kv = Ks[c * DP + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < RQ; ++i) dqa[i][dc] = fmaf(sv[i], kv, dqa[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q0 + ty * RQ + i;
    if (s >= g.Sq) continue;
    float* out = dq + (((size_t)b * g.Sq + s) * g.H + h) * D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) out[tx + 16 * dc] = dqa[i][dc] * g.scale;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   float* dq, float* dk, float* dv, int B, const Geo& g,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  cudaError_t err;
  if (g.Sk > 0) {
    auto kern = dkdv_kernel<T, D>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dkdv<D>());
    if (err != cudaSuccess) return err;
    dim3 grid((g.Sk + BK - 1) / BK, B * g.Hkv);
    kern<<<grid, NT, smem_dkdv<D>(), stream>>>(qt, kt, vt, ot, lse, dsum, dk,
                                               dv, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kern = dq_kernel<T, D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((g.Sq + BQ - 1) / BQ, g.H, B);
  kern<<<grid, NT, smem_dq<D>(), stream>>>(qt, kt, vt, ot, lse, dsum, dq, g);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by ops/flash_attention.py). dtype:
// 0 = f32, 1 = bf16 (q, k, v and dout share it). softcap <= 0 means none;
// window <= 0 means global. Launches the dk/dv pass, then the dq pass,
// on one stream; returns the first cudaError_t.
extern "C" int ts_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* dsum, float* dq, float* dk,
                            float* dv, int B, int Sq, int Sk, int H, int Hkv,
                            int D, int dtype, int q_offset, int k_offset,
                            int window, float scale, float softcap,
                            void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || Hkv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, H, Hkv, q_offset, k_offset, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TS_LAUNCH(T, DD) \
  return (int)launch<T, DD>(q, k, v, dout, lse, dsum, dq, dk, dv, B, g, s)
  if (dtype == TS_F32 && D == 128) TS_LAUNCH(float, 128);
  if (dtype == TS_F32 && D == 256) TS_LAUNCH(float, 256);
  if (dtype == TS_BF16 && D == 128) TS_LAUNCH(__nv_bfloat16, 128);
  if (dtype == TS_BF16 && D == 256) TS_LAUNCH(__nv_bfloat16, 256);
#undef TS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
