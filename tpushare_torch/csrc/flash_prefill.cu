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
// logits s = scale * q.k to cap*tanh(s/cap) before masking. Online
// softmax, running max/sum and accumulation in f32; masked logits are
// NEG_INF and get p = 0 (by the mask, never by magnitude), so a fully
// masked row yields acc / max(l, 1e-30) = 0. Normal mode: output in q's
// type, and the per-row log-sum-exp m + log(l) as f32 [B,H,Sq] when
// asked (the gradient's input). Partial mode: the unnormalized f32
// accumulator [B,Sq,H,D] and the f32 stats m, l [B,H,Sq]; a chunk wholly
// past a q tile's causal frontier runs no tile and writes m = NEG_INF,
// l = 0, acc = 0.
//
// Bound: at prefill lengths the causal FLOPs dwarf the bytes, so the
// bound is operations, at the bf16 tensor-core rate. What the kernel
// keeps from the TPU kernel is the work it skips: the k loop stops at
// the causal frontier of the block's last row, tiles wholly below the
// window of its first row are never loaded (the TPU partial kernel
// masked the window without skipping), and a warpgroup skips the
// products of a tile none of its rows can see.
//
// Two bodies, by element type:
//
// bf16 (every main path): the tensor-core body (tc::, wgmma.cuh). One
// block of two warpgroups per 128-row q tile and head; each warpgroup
// owns 64 rows. Q stays in shared memory; K and V stream through a
// two-stage ring of 64-key tiles, loaded by cp.async into the 128-byte
// swizzled layout wgmma reads, the next tile in flight while the current
// one is multiplied (at D = 256: Q 64 KB + 2 x (K 32 + V 32) KB = 192 KB
// of the 227 KB). S = Q.K^T is wgmma m64n64k16 with both operands in
// shared memory; the scale multiplies S in f32 after the product (Q is
// not rounded to bf16 after scaling: 128^-0.5 is not exact in bf16). The
// softcap, the mask (only on tiles a warpgroup's rows do not all see
// whole; 32-bit offsets relative to the row) and the online softmax run
// in registers on the accumulator layout (a row's max and sum reduce over
// the 4 threads that share it; the rescale of O is skipped when no row's
// max moved). O += P.V takes P from registers as the A operand and V as
// the MN-major B (wgmma m64n128k16, two per step at D = 256). P is f32
// and enters as three bf16 terms, hi + mid + lo, which carry all its 24
// bits: one rounding misses the plain version's gates by 11-44x; two
// terms (~16 bits) meet chip_smoke.py's gates but not the partial
// accumulator's absolute 1e-5 card-test floor at short lengths, and they
// flip more bf16 outputs than f32 does, which int8 KV pages amplify past
// the served-logit gate (PERF.md §6;
// tests/test_torch_flash_numerics.py). The grid launches the heavy
// causal q tiles first.
//
// f32 (the card tests' f32 cases only; no main path runs it): the SIMT
// body (simt::), unchanged from the first version: one block per 64-row
// q tile, both products as f32 FMAs out of padded f32 shared tiles. No
// bf16 or TF32 product meets its 2e-5 absolute test tolerance.

#include "wgmma.cuh"

namespace {

namespace simt {

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
flash_prefill_simt(const T* __restrict__ q, const T* __restrict__ k,
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

}  // namespace simt

namespace tc {

constexpr int NT = 256;   // two warpgroups
constexpr int BQ = 128;   // query rows per block (64 per warpgroup)
constexpr int BK = 64;    // key rows per tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * D * 2 + 1024;  // + alignment slack
}

template <int D, bool PARTIAL>
__global__ void __launch_bounds__(NT, 1)
flash_prefill_tc(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, void* __restrict__ o,
                 float* __restrict__ stat_m, float* __restrict__ stat_l,
                 int Sq, int Sk, int H, int Hkv, int q_offset, int k_offset,
                 int window, float scale, float softcap) {
  constexpr int NH = D / 128;               // n128 column halves of O
  constexpr uint32_t KB = BK * D * 2;       // one K or V tile, bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (ts_smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t KV = Qs + BQ * D * 2;      // stage st: K at KV + 2 st KB

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const long long w_eff = window > 0 ? window : TS_GLOBAL_SPAN;

  // This warpgroup's rows [rw, r_last].
  const int rw = q0 + 64 * wg, r_last = min(rw + 64, Sq) - 1;
  const int r0 = rw + 16 * warp + g;  // this thread's rows: r0, r0 + 8
  // Key kc is live for row r iff kc < Sk and d_lo < kc - r <= d_hi (the
  // causal edge and the window floor relative to the row, clamped to int).
  int d_lo, d_hi;
  ts_rel_limits(q_offset, k_offset, w_eff, d_lo, d_hi);

  int k_begin, k_end;
  ts_key_range<BK>((long long)q_offset + q0,
                   (long long)q_offset + min(q0 + BQ, Sq) - 1, k_offset, Sk,
                   w_eff, k_begin, k_end);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_kv = [&](int it) {
    const uint32_t st = KV + (it & 1) * 2 * KB;
    const int kt = k_begin + it * BK;
    ts_tile_async<D, BK, NT>(st, k, b, kt, Sk, Hkv, kvh);
    ts_tile_async<D, BK, NT>(st + KB, v, b, kt, Sk, Hkv, kvh);
  };
  ts_tile_async<D, BQ, NT>(Qs, q, b, q0, Sq, H, h);
  if (ntiles > 0) load_kv(0);
  ts_cp_commit();

  float acc[NH][64];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) ts_zero(acc[hh]);
  float m[2] = {TS_NEG_INF, TS_NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    ts_cp_commit();
    ts_cp_wait<1>();  // Q and tile it have landed
    ts_fence_async_smem();
    __syncthreads();
    const int kt = k_begin + it * BK;
    const uint32_t Ks = KV + (it & 1) * 2 * KB, Vs = Ks + KB;
    // Skip the products of a tile none of this warpgroup's rows sees
    // (exact: every p would be 0 and alpha 1).
    const int k_last = min(kt + BK, Sk) - 1;
    if (rw < Sq && kt - r_last <= d_hi && k_last - rw > d_lo) {
      float s[32];
      ts_zero(s);
      ts_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ts_wgmma_ss<64>(s, ts_desc_k<BQ>(Qs, 64 * wg, kk),
                        ts_desc_k<BK>(Ks, 0, kk));
      ts_wgmma_commit();
      ts_wgmma_wait<0>();
      ts_reg_fence(s);

      // Scale, softcap, mask (only on a tile the warpgroup's rows do not
      // all see whole); row max over the quad sharing the row. Element
      // 4 j + 2 i + e is row r0 + 8 i, key kt + 8 j + 2 c + e.
      const int dkr = kt + 2 * c - r0;  // key - row of element (0, 0, 0)
      const bool whole = kt + BK <= Sk && kt + BK - 1 - rw <= d_hi &&
                         kt - (rw + 63) > d_lo;
      float mx[2] = {TS_NEG_INF, TS_NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            x = ts_softcap(x * scale, softcap);
            if (!whole) {
              const int d = dkr + 8 * j + e - 8 * i;
              const bool keep =
                  kt + 8 * j + 2 * c + e < Sk && d <= d_hi && d > d_lo;
              x = keep ? x : TS_NEG_INF;
            }
            mx[i] = fmaxf(mx[i], x);
          }
      float alpha[2], ml[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f((m[i] - m_new) * LOG2E);
        m[i] = m_new;
        ml[i] = m_new * LOG2E;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            x = x > TS_NEG_INF / 2 ? exp2f(fmaf(x, LOG2E, -ml[i])) : 0.f;
            ps[i] += x;
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
        l[i] = l[i] * alpha[i] + ps[i];
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int r = 0; r < 64; ++r) acc[hh][r] *= alpha[(r / 2) % 2];
      }

      // O += P.V, P from registers as three bf16 terms, V the MN-major B.
      ts_rs_product<3, BK / 16>(
          acc, s, [&](int kk, int hh) {
            return ts_desc_mn<BK>(Vs, kk, 128 * hh);
          });
    }
    __syncthreads();  // the stage is consumed before it is reloaded
  }
  ts_cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = rw + 16 * warp + g + 8 * i;
    if (s >= Sq) continue;
    const size_t row = ((size_t)b * Sq + s) * H + h;
    const size_t stat = ((size_t)b * H + h) * Sq + s;
    if (PARTIAL) {
      float* out = static_cast<float*>(o) + row * D;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(out + 128 * hh + 8 * j + 2 * c) =
              make_float2(acc[hh][4 * j + 2 * i], acc[hh][4 * j + 2 * i + 1]);
      if (c == 0) {
        stat_m[stat] = m[i];
        stat_l[stat] = l[i];
      }
    } else {
      const float denom = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o) + row * D;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + 128 * hh + 8 * j + 2 * c) =
              __floats2bfloat162_rn(acc[hh][4 * j + 2 * i] / denom,
                                    acc[hh][4 * j + 2 * i + 1] / denom);
      if (stat_m != nullptr && c == 0) stat_m[stat] = m[i] + logf(l[i]);
    }
  }
}

}  // namespace tc

template <int D, bool PARTIAL>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        float* stat_m, float* stat_l, int B, int Sq, int Sk,
                        int H, int Hkv, int q_offset, int k_offset,
                        int window, float scale, float softcap,
                        cudaStream_t stream) {
  auto kern = simt::flash_prefill_simt<float, D, PARTIAL>;
  const size_t smem = simt::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + simt::BQ - 1) / simt::BQ, H, B);
  kern<<<grid, simt::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), o, stat_m, stat_l, Sq, Sk, H, Hkv,
      q_offset, k_offset, window, scale, softcap);
  return cudaGetLastError();
}

template <int D, bool PARTIAL>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* stat_m, float* stat_l, int B, int Sq, int Sk,
                      int H, int Hkv, int q_offset, int k_offset, int window,
                      float scale, float softcap, cudaStream_t stream) {
  auto kern = tc::flash_prefill_tc<D, PARTIAL>;
  const size_t smem = tc::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + tc::BQ - 1) / tc::BQ, H, B);
  kern<<<grid, tc::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), o, stat_m, stat_l, Sq, Sk, H,
      Hkv, q_offset, k_offset, window, scale, softcap);
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
#define TS_LAUNCH(BODY, DD)                                                \
  return BODY<DD, PARTIAL>(q, k, v, o, stat_m, stat_l, B, Sq, Sk, H, Hkv,  \
                           q_offset, k_offset, window, scale, softcap, s)
  if (dtype == TS_F32 && D == 128) TS_LAUNCH(launch_simt, 128);
  if (dtype == TS_F32 && D == 256) TS_LAUNCH(launch_simt, 256);
  if (dtype == TS_BF16 && D == 128) TS_LAUNCH(launch_tc, 128);
  if (dtype == TS_BF16 && D == 256) TS_LAUNCH(launch_tc, 256);
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
