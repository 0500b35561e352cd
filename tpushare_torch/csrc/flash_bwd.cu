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
// Two passes, no float atomics, so the result is deterministic (the ring
// relies on every owner getting identical dk/dv):
//   dkdv: one block per (key tile, b * Hkv + kv head). K and V stay in
//         shared memory; the block walks the q tiles that can see its
//         keys (causal from the first key, window up to the last) for
//         each head of the group, recomputes p and ds, and accumulates
//         dk and dv in registers.
//   dq:   one block per (q tile, head, batch). Q and dout stay in shared
//         memory; the block walks the key tiles in the q tile's live
//         range (the forward kernel's) and accumulates dq.
// Bound: operations at training lengths, like the forward. The score and
// dp products are computed in both passes.
//
// Two bodies, by element type:
//
// bf16 (every main path): the tensor-core body (tc::, wgmma.cuh), two
// warpgroups per block, the streamed tiles in a two-stage cp.async ring
// in the 128-byte swizzled layout wgmma reads, and every product a wgmma.
//   dkdv computes the TRANSPOSED scores, S^T = K.Q^T and dP^T = V.dO^T
//   (m64n64k16, both operands K-major in shared memory), so P^T and dS^T
//   come out on the accumulator layout with keys as rows, which is the
//   register A operand of dV += P^T.dO and dK += dS^T.Q (m64n128k16, dO
//   and Q the MN-major B): nothing is staged through shared memory. lse
//   and dsum ride along with each q tile. At D = 128 each warpgroup owns
//   64 of the block's 128 keys (dK and dV 64 x 128 f32 each); at D = 256
//   both own the same 64 keys and split D (each warpgroup recomputes S^T
//   and dP^T for its half: 8 products of 256-deep per pair where 6 would
//   do, the price of fitting 2 x 64 x 256 f32 accumulators in registers).
//   dk is multiplied by the scale once, at the end.
//   dq: 128 q rows per block, 64 per warpgroup; key tiles of 64 (32 at
//   D = 256, so the dq accumulator of 64 x 256 f32 fits beside S and dP);
//   S = Q.K^T and dP = dO.V^T, then dQ += dS.K with dS from registers and
//   K the MN-major B.
//   P and dS are f32; each enters its bf16 product as a hi/lo pair
//   (hi = bf16(x), lo = bf16(x - hi), two products): one rounding would
//   miss the plain version's gates 5-8x, the pair meets every gate of
//   chip_smoke.py and the card tests (the outputs stay f32 and are summed
//   or handed to the optimizer, so the pair's ~16 bits suffice here, where
//   the forward's bf16 outputs take three terms; PERF.md §6;
//   tests/test_torch_flash_numerics.py). So the kernel does 10 products
//   per live pair over the two passes (12 at D = 256) where the bound
//   counts 5.
//
// f32 (the card tests' f32 cases only; no main path runs it): the SIMT
// body (simt::), unchanged from the first version: f32 FMAs out of
// padded f32 shared tiles, 32-key tiles in dkdv, 64-row q tiles in dq.
// No bf16 or TF32 product meets its 2e-5 absolute test tolerance.

#include "wgmma.cuh"

namespace {

struct Geo {
  int Sq, Sk, H, Hkv, q_offset, k_offset, window;
  float scale, softcap;
};

namespace simt {

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
  int q_begin, q_end;
  ts_query_range<BQ>((long long)g.k_offset + k0,
                     (long long)g.k_offset + min(k0 + BK, g.Sk) - 1,
                     g.q_offset, g.Sq, w_eff, q_begin, q_end);

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

}  // namespace simt

namespace tc {

constexpr int NT = 256;   // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// p = exp(s - lse) and ds = p (dp - dsum) dcap for one element, from the
// raw product x = q.k (unscaled) and dp; keep is the mask.
__device__ __forceinline__ void p_ds(float x, float& dp, float lse,
                                     float dsum, bool keep, const Geo& g,
                                     float& p) {
  float s = x * g.scale, dcap = 1.f;
  if (g.softcap > 0.f) {
    const float t = tanhf(s / g.softcap);
    s = g.softcap * t;
    dcap = 1.f - t * t;
  }
  p = keep ? exp2f((s - lse) * LOG2E) : 0.f;
  dp = p * (dp - dsum) * dcap;
}

// dkdv pass. KW key groups of 64 per block: 2 at D = 128 (one per
// warpgroup), 1 at D = 256 (the warpgroups split D).
template <int D>
struct DkdvShape {
  static constexpr int KW = D == 128 ? 2 : 1;
  static constexpr int BKB = 64 * KW;      // keys per block
  static constexpr int BQ = 64;            // queries per step
  static constexpr uint32_t KVB = BKB * D * 2;
  static constexpr uint32_t QB = BQ * D * 2;
  static constexpr size_t smem = 2 * (size_t)KVB + 4 * (size_t)QB +
                                 4 * BQ * sizeof(float) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
dkdv_tc(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ dsum,
        float* __restrict__ dk, float* __restrict__ dv, Geo g) {
  using Sh = DkdvShape<D>;
  constexpr int BQ = Sh::BQ, BKB = Sh::BKB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Ks = (ts_smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Vs = Ks + Sh::KVB;
  const uint32_t QO = Vs + Sh::KVB;          // stage st: Q at QO + 2 st QB
  const uint32_t LD = QO + 4 * Sh::QB;       // stage st: lse, dsum rows
  const float* LDp = reinterpret_cast<const float*>(
      smem_raw + (LD - ts_smem_addr(smem_raw)));

  const int k0 = blockIdx.x * BKB;
  const int b = blockIdx.y / g.Hkv, kvh = blockIdx.y % g.Hkv;
  const int G = g.H / g.Hkv;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int gr = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const int kr0 = Sh::KW == 2 ? 64 * wg : 0;  // this warpgroup's key rows
  const int dc0 = Sh::KW == 2 ? 0 : 128 * wg;  // and its dk/dv columns
  const long long w_eff = g.window > 0 ? g.window : TS_GLOBAL_SPAN;

  // Query rows (relative to q) that can see a key of this block: causal
  // from its first key, inside the window of its last.
  int q_begin, q_end;
  ts_query_range<BQ>((long long)g.k_offset + k0,
                     (long long)g.k_offset + min(k0 + BKB, g.Sk) - 1,
                     g.q_offset, g.Sq, w_eff, q_begin, q_end);
  const int nq = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int ntiles = G * nq;

  int d_lo, d_hi;
  ts_rel_limits(g.q_offset, g.k_offset, w_eff, d_lo, d_hi);
  // This warpgroup's keys [wk, wk_last] and this thread's two key rows.
  const int wk = k0 + kr0, wk_last = min(wk + 64, g.Sk) - 1;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = wk + 16 * warp + gr + 8 * i;

  auto load_q = [&](int it) {
    const int st = it & 1, h = kvh * G + it / nq;
    const int q0 = q_begin + (it % nq) * BQ;
    const uint32_t Qs = QO + 2 * st * Sh::QB;
    ts_tile_async<D, BQ, NT>(Qs, q, b, q0, g.Sq, g.H, h);
    ts_tile_async<D, BQ, NT>(Qs + Sh::QB, dout, b, q0, g.Sq, g.H, h);
    const size_t row = ((size_t)b * g.H + h) * g.Sq;
    ts_vec_async<BQ, NT>(LD + st * 2 * BQ * 4, lse + row, q0, g.Sq);
    ts_vec_async<BQ, NT>(LD + (st * 2 + 1) * BQ * 4, dsum + row, q0, g.Sq);
  };
  ts_tile_async<D, BKB, NT>(Ks, k, b, k0, g.Sk, g.Hkv, kvh);
  ts_tile_async<D, BKB, NT>(Vs, v, b, k0, g.Sk, g.Hkv, kvh);
  if (ntiles > 0) load_q(0);
  ts_cp_commit();

  float dva[1][64], dka[1][64];
  ts_zero(dva[0]);
  ts_zero(dka[0]);

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_q(it + 1);
    ts_cp_commit();
    ts_cp_wait<1>();  // K, V and step it have landed
    ts_fence_async_smem();
    __syncthreads();
    const int st = it & 1;
    const int q0 = q_begin + (it % nq) * BQ;
    const uint32_t Qs = QO + 2 * st * Sh::QB, Os = Qs + Sh::QB;
    const float* Ls = LDp + st * 2 * BQ;
    const float* Ds = Ls + BQ;
    // Skip the products when no (key, query) pair of this warpgroup and
    // step is live (exact: p and ds would be 0).
    const int q_last = min(q0 + BQ, g.Sq) - 1;
    if (wk < g.Sk && wk - q_last <= d_hi && wk_last - q0 > d_lo) {
      float sT[32], dpT[32];
      ts_zero(sT);
      ts_zero(dpT);
      ts_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ts_wgmma_ss<64>(sT, ts_desc_k<BKB>(Ks, kr0, kk),
                        ts_desc_k<BQ>(Qs, 0, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ts_wgmma_ss<64>(dpT, ts_desc_k<BKB>(Vs, kr0, kk),
                        ts_desc_k<BQ>(Os, 0, kk));
      ts_wgmma_commit();
      ts_wgmma_wait<0>();
      ts_reg_fence(sT);
      ts_reg_fence(dpT);

      // Element 4 j + 2 i + e: key row key[i], query column 8 j + 2 c + e
      // (the mask only on a step whose pairs are not all live).
      const bool whole = wk + 64 <= g.Sk && q0 + BQ <= g.Sq &&
                         wk + 63 - q0 <= d_hi && wk - (q0 + BQ - 1) > d_lo;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * j + 2 * c + e;
          const float lq = Ls[qc], dq = Ds[qc];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int d = key[i] - (q0 + qc);
            const bool keep = whole || (q0 + qc < g.Sq && key[i] < g.Sk &&
                                        d <= d_hi && d > d_lo);
            const int r = 4 * j + 2 * i + e;
            p_ds(sT[r], dpT[r], lq, dq, keep, g, sT[r]);
          }
        }

      // dV += P^T.dO, then dK += dS^T.Q, each as hi + lo.
      ts_rs_product<2, BQ / 16>(dva, sT, [&](int kk, int) {
        return ts_desc_mn<BQ>(Os, kk, dc0);
      });
      ts_rs_product<2, BQ / 16>(dka, dpT, [&](int kk, int) {
        return ts_desc_mn<BQ>(Qs, kk, dc0);
      });
    }
    __syncthreads();  // the stage is consumed before it is reloaded
  }
  ts_cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= g.Sk) continue;
    const size_t row = (((size_t)b * g.Sk + key[i]) * g.Hkv + kvh) * D + dc0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * c, r = 4 * j + 2 * i;
      *reinterpret_cast<float2*>(dk + row + col) =
          make_float2(dka[0][r] * g.scale, dka[0][r + 1] * g.scale);
      *reinterpret_cast<float2*>(dv + row + col) =
          make_float2(dva[0][r], dva[0][r + 1]);
    }
  }
}

// dq pass: 128 q rows per block (64 per warpgroup), key tiles of BK.
template <int D>
struct DqShape {
  static constexpr int BQ = 128;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr uint32_t QB = BQ * D * 2;
  static constexpr uint32_t KB = BK * D * 2;
  static constexpr size_t smem = 2 * (size_t)QB + 4 * (size_t)KB + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
dq_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
      const __nv_bfloat16* __restrict__ v,
      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
      const float* __restrict__ dsum, float* __restrict__ dq, Geo g) {
  using Sh = DqShape<D>;
  constexpr int BQ = Sh::BQ, BK = Sh::BK, NH = D / 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (ts_smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t Os = Qs + Sh::QB;
  const uint32_t KV = Os + Sh::QB;           // stage st: K at KV + 2 st KB

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (g.H / g.Hkv);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int gr = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const long long w_eff = g.window > 0 ? g.window : TS_GLOBAL_SPAN;

  const int rw = q0 + 64 * wg, r_last = min(rw + 64, g.Sq) - 1;
  int d_lo, d_hi;
  ts_rel_limits(g.q_offset, g.k_offset, w_eff, d_lo, d_hi);
  int row[2];
  float lq[2], dsq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = rw + 16 * warp + gr + 8 * i;
    const size_t at = ((size_t)b * g.H + h) * g.Sq + row[i];
    lq[i] = row[i] < g.Sq ? lse[at] : 0.f;
    dsq[i] = row[i] < g.Sq ? dsum[at] : 0.f;
  }

  int k_begin, k_end;
  ts_key_range<BK>((long long)g.q_offset + q0,
                   (long long)g.q_offset + min(q0 + BQ, g.Sq) - 1,
                   g.k_offset, g.Sk, w_eff, k_begin, k_end);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_kv = [&](int it) {
    const uint32_t st = KV + (it & 1) * 2 * Sh::KB;
    const int kt = k_begin + it * BK;
    ts_tile_async<D, BK, NT>(st, k, b, kt, g.Sk, g.Hkv, kvh);
    ts_tile_async<D, BK, NT>(st + Sh::KB, v, b, kt, g.Sk, g.Hkv, kvh);
  };
  ts_tile_async<D, BQ, NT>(Qs, q, b, q0, g.Sq, g.H, h);
  ts_tile_async<D, BQ, NT>(Os, dout, b, q0, g.Sq, g.H, h);
  if (ntiles > 0) load_kv(0);
  ts_cp_commit();

  float dqa[NH][64];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) ts_zero(dqa[hh]);

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    ts_cp_commit();
    ts_cp_wait<1>();  // Q, dO and tile it have landed
    ts_fence_async_smem();
    __syncthreads();
    const int kt = k_begin + it * BK;
    const uint32_t Ks = KV + (it & 1) * 2 * Sh::KB, Vs = Ks + Sh::KB;
    const int k_last = min(kt + BK, g.Sk) - 1;
    if (rw < g.Sq && kt - r_last <= d_hi && k_last - rw > d_lo) {
      float s[BK / 2], dp[BK / 2];
      ts_zero(s);
      ts_zero(dp);
      ts_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ts_wgmma_ss<BK>(s, ts_desc_k<BQ>(Qs, 64 * wg, kk),
                        ts_desc_k<BK>(Ks, 0, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ts_wgmma_ss<BK>(dp, ts_desc_k<BQ>(Os, 64 * wg, kk),
                        ts_desc_k<BK>(Vs, 0, kk));
      ts_wgmma_commit();
      ts_wgmma_wait<0>();
      ts_reg_fence(s);
      ts_reg_fence(dp);

      // Element 4 j + 2 i + e: query row row[i], key column kt + 8 j + 2 c
      // + e (the mask only on a tile whose pairs are not all live).
      const bool whole = kt + BK <= g.Sk && rw + 64 <= g.Sq &&
                         kt + BK - 1 - rw <= d_hi && kt - (rw + 63) > d_lo;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = kt + 8 * j + 2 * c + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int d = kc - row[i];
            const bool keep = whole || (row[i] < g.Sq && kc < g.Sk &&
                                        d <= d_hi && d > d_lo);
            const int r = 4 * j + 2 * i + e;
            float p;
            p_ds(s[r], dp[r], lq[i], dsq[i], keep, g, p);
          }
        }

      // dQ += dS.K as hi + lo, dS from registers, K the MN-major B.
      ts_rs_product<2, BK / 16>(dqa, dp, [&](int kk, int hh) {
        return ts_desc_mn<BK>(Ks, kk, 128 * hh);
      });
    }
    __syncthreads();  // the stage is consumed before it is reloaded
  }
  ts_cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= g.Sq) continue;
    float* out = dq + (((size_t)b * g.Sq + row[i]) * g.H + h) * D;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = 4 * j + 2 * i;
        *reinterpret_cast<float2*>(out + 128 * hh + 8 * j + 2 * c) =
            make_float2(dqa[hh][r] * g.scale, dqa[hh][r + 1] * g.scale);
      }
  }
}

}  // namespace tc

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* dsum, float* dq, float* dk, float* dv,
                        int B, const Geo& g, cudaStream_t stream) {
  using T = float;
  using namespace simt;
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

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      float* dq, float* dk, float* dv, int B, const Geo& g,
                      cudaStream_t stream) {
  using T = __nv_bfloat16;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  cudaError_t err;
  if (g.Sk > 0) {
    using Sh = tc::DkdvShape<D>;
    auto kern = tc::dkdv_tc<D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::smem);
    if (err != cudaSuccess) return err;
    dim3 grid((g.Sk + Sh::BKB - 1) / Sh::BKB, B * g.Hkv);
    kern<<<grid, tc::NT, Sh::smem, stream>>>(qt, kt, vt, ot, lse, dsum, dk,
                                             dv, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  using Sh = tc::DqShape<D>;
  auto kern = tc::dq_tc<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Sh::smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.Sq + Sh::BQ - 1) / Sh::BQ, g.H, B);
  kern<<<grid, tc::NT, Sh::smem, stream>>>(qt, kt, vt, ot, lse, dsum, dq, g);
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
#define TS_LAUNCH(BODY, DD) \
  return (int)BODY<DD>(q, k, v, dout, lse, dsum, dq, dk, dv, B, g, s)
  if (dtype == TS_F32 && D == 128) TS_LAUNCH(launch_simt, 128);
  if (dtype == TS_F32 && D == 256) TS_LAUNCH(launch_simt, 256);
  if (dtype == TS_BF16 && D == 128) TS_LAUNCH(launch_tc, 128);
  if (dtype == TS_BF16 && D == 256) TS_LAUNCH(launch_tc, 256);
#undef TS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
