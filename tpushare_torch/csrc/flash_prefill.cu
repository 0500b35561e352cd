// Kernel 1 of the port: causal prefill flash attention on Hopper, and
// its partial mode (kernel 8).
//
// Replaces tpushare/ops/flash_attention.py _fa_kernel (K/V resident per
// (b, kv head)) and _fa_stream_kernel (K/V streamed tile by tile) behind
// flash_attention(), and _fa_kernel with partial=True behind
// flash_attention_partial() (ring attention's per-hop pass). One kernel
// serves all three: the 8 MiB resident/streaming split was a VMEM limit
// of the TPU, and here every K/V tile streams through shared memory
// anyway; the partial mode is a template parameter.
//
// Contract (mha_reference's, BSHD): q [B,Sq,H,D], k/v [B,Sk,Hkv,D],
// contiguous, f32 or bf16, D in {128,256}; query head h reads kv head
// h / (H/Hkv) in place (GQA without broadcasting K/V). q_offset and
// k_offset are the absolute positions of q[0] and k[0] (k_offset is 0
// outside the partial mode); the mask is causal (k_pos <= q_pos) and a
// window > 0 additionally keeps k_pos > q_pos - window (the port has no
// non-causal prefill, so neither does the kernel); softcap (> 0) maps
// logits to cap*tanh(s/cap) before masking; the scale multiplies q before
// the dot. Online softmax, running max/sum and accumulation in f32;
// masked logits are NEG_INF and get p = 0 (by the mask, never by
// magnitude), so a fully masked row yields acc / max(l, 1e-30) = 0.
// Normal mode: output in q's type, and the per-row log-sum-exp
// m + log(l) as f32 [B,H,Sq] when asked (the gradient's input). Partial
// mode: the unnormalized f32 accumulator [B,Sq,H,D] and the f32 stats m,
// l [B,H,Sq]; a chunk wholly past a q tile's causal frontier runs no
// tile and writes m = NEG_INF, l = 0, acc = 0.
//
// Bound: at prefill lengths the causal FLOPs dwarf the bytes, so the
// bound is operations. This first version does both products with f32
// FMAs out of shared memory (not the tensor cores), so it runs well
// below the bf16 peak; what it keeps from the TPU kernel is the work it
// skips: the k loop stops at the causal frontier of the block's last
// row, and tiles wholly below the window of its first row are never
// loaded (the TPU partial kernel masked the window without skipping).
// Tensor-core (wgmma) and TMA versions are later work.
//
// Layout: one block per (64-row q tile, head, batch); 256 threads as 16
// row groups x 16 column lanes. Q, K and V tiles sit in shared memory
// as f32 with a padded row stride (D+1 floats) so column walks are free
// of bank conflicts; the f32 tiles at D = 256 take ~209 KB, which needs
// the dynamic shared-memory opt-in.

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int NT = 256;       // threads per block
constexpr int RQ = BQ / 16;   // query rows per thread
constexpr int CK = BK / 16;   // score columns per thread

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(3 * BQ * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D, bool PARTIAL>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, void* __restrict__ o,
                     float* __restrict__ stat_m, float* __restrict__ stat_l,
                     int Sq, int Sk, int H, int Hkv, int q_offset,
                     int k_offset, int window, float scale, float softcap) {
  // Normal mode: o is T [B,Sq,H,D]; stat_m, when not null, receives the
  // log-sum-exp. Partial mode: o is f32 [B,Sq,H,D], stat_m/stat_l get
  // m and l.
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;  // [BQ][BK+1] probabilities of the tile

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long w_eff = window > 0 ? window : TS_GLOBAL_SPAN;

  ts_load_tile<T, D, BQ, NT>(Qs, q, b, q0, Sq, H, h, scale);

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = TS_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // Live key range of the whole q tile: up to the causal frontier of
  // its last real row, from the window floor of its first row.
  int k_begin, k_end;
  ts_key_range<BK>((long long)q_offset + q0,
                   (long long)q_offset + min(q0 + BQ, Sq) - 1, k_offset, Sk,
                   w_eff, k_begin, k_end);

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // Q landed; the previous tile is consumed
    ts_load_tile<T, D, BK, NT>(Ks, k, b, kt, Sk, Hkv, kvh, 1.f);
    ts_load_tile<T, D, BK, NT>(Vs, v, b, kt, Sk, Hkv, kvh, 1.f);
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty * RQ + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const long long qpos = (long long)q_offset + q0 + r;
      float mx = TS_NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kc = kt + tx + 16 * j;
        const long long kpos = (long long)k_offset + kc;
        const bool keep = kc < Sk && kpos <= qpos && kpos > qpos - w_eff;
        const float s = keep ? ts_softcap(sc[i][j], softcap) : TS_NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // The 16 lanes of one row group share a half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p =
            sc[i][j] > TS_NEG_INF / 2 ? expf(sc[i][j] - m_new) : 0.f;
        Ps[r * (BK + 1) + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty * RQ + i) * (BK + 1) + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float vv = Vs[c * DP + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q0 + ty * RQ + i;
    if (s >= Sq) continue;
    const size_t row = ((size_t)b * Sq + s) * H + h;
    const size_t stat = ((size_t)b * H + h) * Sq + s;
    if (PARTIAL) {
      float* out = static_cast<float*>(o) + row * D;
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) out[tx + 16 * dc] = acc[i][dc];
      if (tx == 0) {
        stat_m[stat] = m[i];
        stat_l[stat] = l[i];
      }
    } else {
      const float denom = fmaxf(l[i], 1e-30f);
      T* out = static_cast<T*>(o) + row * D;
#pragma unroll
      for (int dc = 0; dc < DC; ++dc)
        out[tx + 16 * dc] = ts_from_f<T>(acc[i][dc] / denom);
      if (stat_m != nullptr && tx == 0) stat_m[stat] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D, bool PARTIAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* stat_m, float* stat_l, int B, int Sq, int Sk,
                   int H, int Hkv, int q_offset, int k_offset, int window,
                   float scale, float softcap, cudaStream_t stream) {
  auto kern = flash_prefill_kernel<T, D, PARTIAL>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, stat_m, stat_l, Sq, Sk, H, Hkv, q_offset,
      k_offset, window, scale, softcap);
  return cudaGetLastError();
}

template <bool PARTIAL>
cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, void* o, float* stat_m, float* stat_l,
                     int B, int Sq, int Sk, int H, int Hkv, int q_offset,
                     int k_offset, int window, float scale, float softcap,
                     cudaStream_t s) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
#define TS_LAUNCH(T, DD)                                                   \
  return launch<T, DD, PARTIAL>(q, k, v, o, stat_m, stat_l, B, Sq, Sk, H,  \
                                Hkv, q_offset, k_offset, window, scale,    \
                                softcap, s)
  if (dtype == TS_F32 && D == 128) TS_LAUNCH(float, 128);
  if (dtype == TS_F32 && D == 256) TS_LAUNCH(float, 256);
  if (dtype == TS_BF16 && D == 128) TS_LAUNCH(__nv_bfloat16, 128);
  if (dtype == TS_BF16 && D == 256) TS_LAUNCH(__nv_bfloat16, 256);
#undef TS_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points (loaded with ctypes by ops/flash_attention.py). dtype:
// 0 = f32, 1 = bf16. softcap <= 0 means none; window <= 0 means global.
// Each returns the cudaError_t of its launch.

// flash_attention: normalized output o in q's type; lse (f32 [B,H,Sq])
// may be null.
extern "C" int ts_flash_prefill(const void* q, const void* k, const void* v,
                                void* o, float* lse, int B, int Sq, int Sk,
                                int H, int Hkv, int D, int dtype,
                                int q_offset, int window, float scale,
                                float softcap, void* stream) {
  return (int)dispatch<false>(dtype, D, q, k, v, o, lse, nullptr, B, Sq, Sk,
                              H, Hkv, q_offset, 0, window, scale, softcap,
                              static_cast<cudaStream_t>(stream));
}

// flash_attention_partial: f32 acc [B,Sq,H,D], m and l [B,H,Sq].
extern "C" int ts_flash_partial(const void* q, const void* k, const void* v,
                                float* acc, float* m, float* l, int B,
                                int Sq, int Sk, int H, int Hkv, int D,
                                int dtype, int q_offset, int k_offset,
                                int window, float scale, float softcap,
                                void* stream) {
  return (int)dispatch<true>(dtype, D, q, k, v, acc, m, l, B, Sq, Sk, H, Hkv,
                             q_offset, k_offset, window, scale, softcap,
                             static_cast<cudaStream_t>(stream));
}
