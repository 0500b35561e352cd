// Kernel 3 of the port: multi-token attention (Sq >= 2 query rows per
// slot) read straight off the block-table-paged KV pool, on Hopper.
//
// Replaces tpushare/ops/flash_attention.py _paged_verify_kernel behind
// paged_flash_verify(), for f32/bf16 pages and (quantized=True there)
// int8 pages. It carries speculative verify (Sq = gamma * horizon + 1)
// and the fused admission tick (Sq = the chunk width, up to 512 here).
// q [B,Sq,H,D]; pool_k/pool_v [nb,bs,Hkv,D] (one layer's pool) of q's
// type or int8; int8 pools add k_scale/v_scale f32 [nb,Hkv,bs]; table
// [B,mb] int32 (-1 = unallocated); pos [B] int32; D in {128,256}.
// Query row s of slot b sits at position pos[b] + s and attends pool
// positions t <= pos[b] + s (and t > pos[b] + s - window when
// window > 0) through table[b, t / bs]; -1 entries are never
// dereferenced: their rows are masked. Online softmax in f32, optional
// tanh softcap, int8 rows times their f32 scale; a row with no live
// position yields 0.
//
// Bound: at Sq = 5 (verify) a slot's live K/V pages dominate and the
// bound is bytes (int8: half, plus the scales); at a fused tick's
// Sq = 512 every slot's 512 rows attend thousands of positions and the
// bound is operations. The TPU kernel walked one (slot, all heads) per
// sequential grid row and folded the rows g-major into one VMEM tile;
// on Hopper the blocks run in parallel, so the kernel tiles the rows
// across blocks: one block per (row tile, kv head, slot), rows ordered
// s-major (row = s * g + j for query head kv_head * g + j), so a tile
// holds a few consecutive positions of the GQA group and its key walk
// stops at the causal frontier of its newest row and starts at the
// window floor of its oldest: pages outside the union of its rows' live
// ranges are never loaded. Every loaded K/V row is shared by the tile's
// query rows.
//
// Two bodies:
//
// tensor cores (tc::, wgmma.cuh), bf16 q over bf16 or int8 pages: the
// forward of flash_prefill.cu with a gathered K/V walk. Two warpgroups
// over a 128-row tile, or one over 64 when the slot has at most 64 rows
// (spec verify: Llama 20, Gemma-2B 40). Q stays in shared memory; K and
// V stream through two stages of 64 positions. Each thread's 16-byte
// cp.async reads pool row (table[b, t / bs] * bs + t % bs) * Hkv + kvh
// straight into the 128-byte swizzled tile, zero-filled for -1 pages and
// positions past the frontier; the pool rows and scales of a tile are
// looked up once, two tiles ahead, into shared memory. S = Q.K^T is
// wgmma with both operands in shared memory, the scale after the
// product; softcap, the mask (per row: positions differ along the GQA
// rows) and the online softmax run on the accumulator layout; O += P.V
// takes P from registers in three bf16 terms (all 24 bits, as
// flash_prefill.cu, which says why) and V as the MN-major B, and each
// 16-key step's products are summed apart and added to O with a rounded
// f32 add (the tensor cores' own chained sum rounds toward zero; see
// there). A warpgroup skips the products of a tile none of its rows sees.
// Int8 pages land int8 and are widened into the bf16 tiles in shared
// memory (exact, ts_widen_i8); the scales move off the rows onto the
// products, two exact reorderings of the plain version's (int8 * scale)
// rows, apart from the f32 order of the sums:
//   q . (k8 * ks) = (q . k8) * ks: k_scale multiplies S's column t after
//     Q.K^T (with the softmax scale);
//   sum_t p_t (v8_t * vs_t) = sum_t (p_t * vs_t) v8_t: v_scale multiplies
//     P's column t before P is split into its terms (the row sum l takes
//     the unscaled p).
//
// SIMT (simt::, the first version), f32 q over f32 or int8 pages (the
// card tests): both products as f32 FMAs out of padded f32 shared
// tiles, int8 rows times their scale right after the load; one block of
// 256 threads per 64-row tile. At spec verify's Sq 5 it was slower than
// the tensor-core body for bf16 q on an H100 (PERF.md §6), so bf16 q
// always takes the tensor cores.

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

template <typename T, typename P, int D>
__global__ void __launch_bounds__(NT)
paged_verify_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                    const P* __restrict__ pool_v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ o, int Sq,
                    int H, int Hkv, int bs, int mb, int window, float scale,
                    float softcap) {
  extern __shared__ float smem[];
  __shared__ long long rowsrc[BK];  // pool row of each key row, -1 masked
  __shared__ float rowks[BK], rowvs[BK];  // int8 pages: row scales
  constexpr bool Q8 = std::is_same<P, int8_t>::value;
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int CH = D / 8;
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;  // [BQ][BK+1] probabilities of the tile

  const int g = H / Hkv;
  const int rows = g * Sq;
  const int r0 = blockIdx.x * BQ, kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long p = pos[b];
  const long long w_eff = window > 0 ? window : TS_GLOBAL_SPAN;

  // Q tile, pre-scaled: tile row r is query row gr = r0 + r, i.e.
  // position p + gr / g of head kvh * g + gr % g.
  for (int i = threadIdx.x; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, gr = r0 + r;
    float v[8];
    if (gr < rows) {
      const int h = kvh * g + gr % g;
      ts_load8(q + (((size_t)b * Sq + gr / g) * H + h) * D + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[r * DP + c + e] = v[e] * scale;
  }

  float m[RQ], l[RQ], acc[RQ][DC];
  long long qpos[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = TS_NEG_INF;
    l[i] = 0.f;
    const int gr = r0 + ty * RQ + i;
    // A padding row (gr >= rows) gets a position no key reaches.
    qpos[i] = gr < rows ? p + gr / g : -TS_GLOBAL_SPAN;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // Union of the tile's rows' live ranges, within the table.
  const long long s_first = r0 / g;
  const long long s_last = (min(r0 + BQ, rows) - 1) / g;
  const long long k_end = min(p + s_last + 1, (long long)mb * bs);
  const long long lo = p + s_first - w_eff + 1;
  const long long k_begin = lo > 0 ? (lo / BK) * BK : 0;

  for (long long kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // Q landed; the previous tile is consumed
    if (threadIdx.x < BK) {
      const long long t = kt + threadIdx.x;
      long long src = -1;
      float sk = 0.f, sv = 0.f;
      if (t < k_end) {
        const int e = table[(size_t)b * mb + t / bs];
        if (e >= 0) {
          src = (long long)e * bs + t % bs;
          if constexpr (Q8) {
            const size_t sa = ((size_t)e * Hkv + kvh) * bs + t % bs;
            sk = k_scale[sa];
            sv = v_scale[sa];
          }
        }
      }
      rowsrc[threadIdx.x] = src;
      rowks[threadIdx.x] = sk;
      rowvs[threadIdx.x] = sv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const long long src = rowsrc[r];
      float kv[8], vv[8];
      if (src >= 0) {
        const size_t a = ((size_t)src * Hkv + kvh) * D + c;
        ts_load8(pool_k + a, kv);
        ts_load8(pool_v + a, vv);
        if constexpr (Q8) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kv[e] *= rowks[r];
            vv[e] *= rowvs[r];
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[r * DP + c + e] = kv[e];
        Vs[r * DP + c + e] = vv[e];
      }
    }
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
      float mx = TS_NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + 16 * j;
        const long long kpos = kt + c;
        const bool keep = rowsrc[c] >= 0 && kpos <= qpos[i] &&
                          kpos > qpos[i] - w_eff;
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
        const float pr =
            sc[i][j] > TS_NEG_INF / 2 ? expf(sc[i][j] - m_new) : 0.f;
        Ps[r * (BK + 1) + tx + 16 * j] = pr;
        ps += pr;
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
    const int gr = r0 + ty * RQ + i;
    if (gr >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + (((size_t)b * Sq + gr / g) * H + kvh * g + gr % g) * D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      out[tx + 16 * dc] = ts_from_f<T>(acc[i][dc] / denom);
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const float* ks, const float* vs, const int* table,
                   const int* pos, void* o, int B, int Sq, int H, int Hkv,
                   int bs, int mb, int window, float scale, float softcap,
                   cudaStream_t stream) {
  auto kern = paged_verify_kernel<T, P, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = (H / Hkv) * Sq;
  dim3 grid((rows + BQ - 1) / BQ, Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk),
      static_cast<const P*>(pv), ks, vs, table, pos, static_cast<T*>(o), Sq,
      H, Hkv, bs, mb, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_d(int D, const void* q, const void* pk, const void* pv,
                       const float* ks, const float* vs, const int* table,
                       const int* pos, void* o, int B, int Sq, int H,
                       int Hkv, int bs, int mb, int window, float scale,
                       float softcap, cudaStream_t s) {
  switch (D) {
    case 128:
      return launch<T, P, 128>(q, pk, pv, ks, vs, table, pos, o, B, Sq, H,
                               Hkv, bs, mb, window, scale, softcap, s);
    case 256:
      return launch<T, P, 256>(q, pk, pv, ks, vs, table, pos, o, B, Sq, H,
                               Hkv, bs, mb, window, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_page(int page, int D, const void* q, const void* pk,
                          const void* pv, const float* ks, const float* vs,
                          const int* table, const int* pos, void* o, int B,
                          int Sq, int H, int Hkv, int bs, int mb, int window,
                          float scale, float softcap, cudaStream_t s) {
  if (page == TS_I8) {
    if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
    return dispatch_d<T, int8_t>(D, q, pk, pv, ks, vs, table, pos, o, B, Sq,
                                 H, Hkv, bs, mb, window, scale, softcap, s);
  }
  return dispatch_d<T, T>(D, q, pk, pv, ks, vs, table, pos, o, B, Sq, H, Hkv,
                          bs, mb, window, scale, softcap, s);
}

}  // namespace simt

namespace tc {

constexpr int BK = 64;  // key positions per tile
constexpr float LOG2E = 1.4426950408889634f;

// NWG warpgroups over a tile of 64 * NWG query rows; Q8: int8 pages.
template <int D, int NWG, bool Q8>
struct Cfg {
  static constexpr int NTH = 128 * NWG, BQ = 64 * NWG;
  static constexpr uint32_t QB = BQ * D * 2;  // the Q tile, bytes
  static constexpr uint32_t TB = BK * D * 2;  // one bf16 K or V tile
  static constexpr uint32_t T8 = BK * D;      // one int8 K or V tile
  // bf16 pages: Q | 2 stages x (K, V). int8: Q | K, V widened | 2 stages
  // x (K, V) int8.
  static constexpr size_t SMEM =
      QB + (Q8 ? 2 * TB + 4 * T8 : 4 * TB) + 1024;
};

template <int D, int NWG, bool Q8>
__global__ void __launch_bounds__(128 * NWG, 1)
paged_verify_tc(const __nv_bfloat16* __restrict__ q,
                const void* __restrict__ pool_k,
                const void* __restrict__ pool_v,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ table, const int* __restrict__ pos,
                __nv_bfloat16* __restrict__ o, int Sq, int H, int Hkv, int bs,
                int mb, int window, float scale, float softcap) {
  using G = Cfg<D, NWG, Q8>;
  using P = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  constexpr int NTH = G::NTH, BQ = G::BQ, NH = D / 128;
  constexpr int UR = D * sizeof(P) / 16;  // 16-byte units of a pool row
  // Pool row (-1: masked) and int8 scales of each key of a tile, three
  // tiles' worth: tile it's are written two tiles ahead.
  __shared__ int rowsrc[3][BK];
  __shared__ float rowks[3][BK], rowvs[3][BK];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (ts_smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t KV = Qs + G::QB;  // bf16: stage st's K at KV + 2 st TB;
                                   // int8: the widened K, V at KV, KV + TB
  const uint32_t S8 = KV + 2 * G::TB;  // int8: stage st's K at S8 + 2 st T8
  const P* pk = static_cast<const P*>(pool_k);
  const P* pv = static_cast<const P*>(pool_v);

  const int gq = H / Hkv, rows = gq * Sq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const int p = pos[b];
  const long long w_eff = window > 0 ? window : TS_GLOBAL_SPAN;

  // Union of the tile's rows' live ranges, within the table.
  const int s_first = r0 / gq, s_last = (min(r0 + BQ, rows) - 1) / gq;
  const int k_end = (int)min((long long)p + s_last + 1, (long long)mb * bs);
  const long long lo = (long long)p + s_first - w_eff + 1;
  const int k_begin = lo > 0 ? (int)((lo / BK) * BK) : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // This thread's rows rw + 16 warp + g + 8 i attend lo_[i] < t <= hi[i];
  // a padding row attends nothing. The warpgroup's rows see no key above
  // wg_hi or at or below wg_lo.
  const int rw = r0 + 64 * wg;
  int hi[2], lo_[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = rw + 16 * warp + g + 8 * i;
    const long long qp = gr < rows ? p + gr / gq : -1;
    hi[i] = (int)qp;
    lo_[i] = (int)max(-1LL, qp - w_eff);
  }
  const int wg_hi = rw < rows ? p + (min(rw + 64, rows) - 1) / gq : -1;
  const long long wg_lo = (long long)p + rw / gq - w_eff;

  auto lookup = [&](int it) {  // tile it's pool rows into slot it % 3
    if (threadIdx.x < BK && it < ntiles) {
      const int sl = it % 3, t = k_begin + it * BK + threadIdx.x;
      int src = -1;
      float sk = 0.f, sv = 0.f;
      if (t < k_end) {
        const int e = table[(size_t)b * mb + t / bs];
        if (e >= 0) {
          src = e * bs + t % bs;
          if constexpr (Q8) {
            const size_t sa = ((size_t)e * Hkv + kvh) * bs + t % bs;
            sk = k_scale[sa];
            sv = v_scale[sa];
          }
        }
      }
      rowsrc[sl][threadIdx.x] = src;
      rowks[sl][threadIdx.x] = sk;
      rowvs[sl][threadIdx.x] = sv;
    }
  };
  auto load_kv = [&](int it) {  // gathered K/V rows of tile it
    const int sl = it % 3, st = it & 1;
    for (int i = threadIdx.x; i < BK * UR; i += NTH) {
      const int r = i / UR, cu = i % UR, src = rowsrc[sl][r];
      const bool ok = src >= 0;
      const size_t a = ((size_t)(ok ? src : 0) * Hkv + kvh) * D;
      if constexpr (Q8) {
        const uint32_t dst = S8 + st * 2 * G::T8 + r * D + cu * 16;
        ts_cp_async16(dst, pk + a + cu * 16, ok);
        ts_cp_async16(dst + G::T8, pv + a + cu * 16, ok);
      } else {
        const uint32_t dst = KV + st * 2 * G::TB + (cu / 8) * (BK * 128) +
                             r * 128 + (((cu % 8) ^ (r % 8)) << 4);
        ts_cp_async16(dst, pk + a + cu * 8, ok);
        ts_cp_async16(dst + G::TB, pv + a + cu * 8, ok);
      }
    }
  };

  // Q tile: tile row r is query row gr = r0 + r (position p + gr / gq of
  // head kvh * gq + gr % gq); rows past the slot's are zero.
  for (int i = threadIdx.x; i < BQ * (D / 8); i += NTH) {
    const int r = i / (D / 8), cu = i % (D / 8), gr = r0 + r;
    const bool ok = gr < rows;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * Sq + gr / gq) * H + kvh * gq + gr % gq) * D +
                 cu * 8
           : q;
    ts_cp_async16(Qs + (cu / 8) * (BQ * 128) + r * 128 +
                      (((cu % 8) ^ (r % 8)) << 4),
                  src, ok);
  }
  lookup(0);
  lookup(1);
  __syncthreads();
  if (ntiles > 0) load_kv(0);
  ts_cp_commit();

  float acc[NH][64];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) ts_zero(acc[hh]);
  float m[2] = {TS_NEG_INF, TS_NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    ts_cp_commit();
    // Slot (it + 2) % 3 last served tile it - 1, done before the barrier
    // that ended the previous step; it is read after the next one.
    lookup(it + 2);
    ts_cp_wait<1>();  // Q and tile it have landed
    if constexpr (Q8) {
      __syncthreads();  // every thread's int8 rows of tile it landed
      const uint32_t st = S8 + (it & 1) * 2 * G::T8;
      ts_widen_i8<D, BK, NTH>(KV, st);
      ts_widen_i8<D, BK, NTH>(KV + G::TB, st + G::T8);
    }
    ts_fence_async_smem();
    __syncthreads();
    const int sl = it % 3, kt = k_begin + it * BK;
    const uint32_t Ks = Q8 ? KV : KV + (it & 1) * 2 * G::TB, Vs = Ks + G::TB;
    // Skip the products of a tile none of this warpgroup's rows sees
    // (exact: every p would be 0 and alpha 1).
    if (kt <= wg_hi && kt + BK - 1 > wg_lo) {
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

      // Scale (times k_scale's column), softcap, mask; row max over the
      // quad sharing the row. Element 4 j + 2 i + e is row i of this
      // thread, key kt + 8 j + 2 c + e.
      float mx[2] = {TS_NEG_INF, TS_NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e, t = kt + col;
          const float cs = Q8 ? scale * rowks[sl][col] : scale;
          const bool live = rowsrc[sl][col] >= 0;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = s[4 * j + 2 * i + e];
            x = ts_softcap(x * cs, softcap);
            x = live && t <= hi[i] && t > lo_[i] ? x : TS_NEG_INF;
            mx[i] = fmaxf(mx[i], x);
          }
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
      if constexpr (Q8) {  // v_scale's column onto P, before the split
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float vs = rowvs[sl][8 * j + 2 * c + e];
            s[4 * j + e] *= vs;
            s[4 * j + 2 + e] *= vs;
          }
      }

      // O = O * alpha + P.V. P from registers as three bf16 terms, V the
      // MN-major B. Each 16-key step's three products form a partial of
      // their own, added to O with a rounded f32 add: the tensor cores'
      // chained f32 sum rounds toward zero, and chained over a tile or a
      // fused tick's thousands of keys it rounded outputs so that int8 KV
      // pages carried Llama-3-8B's served logits past their gate (PERF.md
      // §6: 0.0564 against 0.02 per tile, 0.0409 over the whole walk).
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        float part[64];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t f[3][4];
          ts_frag_split<3>(s, kk, f);
          ts_wgmma_fence();
          const uint64_t db = ts_desc_mn<BK>(Vs, kk, 128 * hh);
          ts_wgmma_rs128(part, f[0], db, 0);
          ts_wgmma_rs128(part, f[1], db);
          ts_wgmma_rs128(part, f[2], db);
          ts_wgmma_commit();
          ts_wgmma_wait<0>();
          ts_reg_fence(part);
#pragma unroll
          for (int r = 0; r < 64; ++r)
            acc[hh][r] = kk == 0
                             ? fmaf(acc[hh][r], alpha[(r / 2) % 2], part[r])
                             : acc[hh][r] + part[r];
        }
      }
    }
    __syncthreads();  // the stage and the slot are consumed
  }
  ts_cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = rw + 16 * warp + g + 8 * i;
    if (gr >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* out =
        o + (((size_t)b * Sq + gr / gq) * H + kvh * gq + gr % gq) * D;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 128 * hh + 8 * j + 2 * c) =
            __floats2bfloat162_rn(acc[hh][4 * j + 2 * i] / denom,
                                  acc[hh][4 * j + 2 * i + 1] / denom);
  }
}

template <int D, int NWG, bool Q8>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const float* ks, const float* vs, const int* table,
                   const int* pos, void* o, int B, int Sq, int H, int Hkv,
                   int bs, int mb, int window, float scale, float softcap,
                   cudaStream_t stream) {
  using G = Cfg<D, NWG, Q8>;
  auto kern = paged_verify_tc<D, NWG, Q8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  const int rows = (H / Hkv) * Sq;
  dim3 grid((rows + G::BQ - 1) / G::BQ, Hkv, B);
  kern<<<grid, G::NTH, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), pk, pv, ks, vs, table, pos,
      static_cast<__nv_bfloat16*>(o), Sq, H, Hkv, bs, mb, window, scale,
      softcap);
  return cudaGetLastError();
}

template <bool Q8>
cudaError_t dispatch(int D, const void* q, const void* pk, const void* pv,
                     const float* ks, const float* vs, const int* table,
                     const int* pos, void* o, int B, int Sq, int H, int Hkv,
                     int bs, int mb, int window, float scale, float softcap,
                     cudaStream_t s) {
  const bool one = (H / Hkv) * Sq <= 64;  // one warpgroup holds the rows
#define TS_LAUNCH(DD, NW)                                                   \
  return launch<DD, NW, Q8>(q, pk, pv, ks, vs, table, pos, o, B, Sq, H, Hkv, \
                            bs, mb, window, scale, softcap, s)
  if (D == 128 && one) TS_LAUNCH(128, 1);
  if (D == 128) TS_LAUNCH(128, 2);
  if (D == 256 && one) TS_LAUNCH(256, 1);
  if (D == 256) TS_LAUNCH(256, 2);
#undef TS_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// C entry point (loaded with ctypes by ops/flash_attention.py; the same
// signature as ts_paged_decode). dtype: q/output type, 0 = f32,
// 1 = bf16; page: the pools' type, equal to dtype or 2 = int8 (then
// k_scale and v_scale are [nb,Hkv,bs] f32). Sq >= 2. softcap <= 0 means
// none; window <= 0 means global. Returns the cudaError_t of its
// launch. The tensor-core body for bf16 q, the SIMT body for f32 q.
extern "C" int ts_paged_verify(const void* q, const void* pool_k,
                               const void* pool_v, const void* k_scale,
                               const void* v_scale, const void* table,
                               const void* pos, void* o, int B, int Sq,
                               int H, int Hkv, int D, int bs, int mb,
                               int dtype, int page, int window, float scale,
                               float softcap, void* stream) {
  if (B <= 0 || Sq < 2 || H <= 0 || Hkv <= 0 || H % Hkv || bs <= 0 ||
      mb <= 0 || B > 65535 || Hkv > 65535 ||
      (page != dtype && page != TS_I8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == TS_F32)
    return (int)simt::dispatch_page<float>(page, D, q, pool_k, pool_v, ks,
                                           vs, tb, ps, o, B, Sq, H, Hkv, bs,
                                           mb, window, scale, softcap, s);
  if (dtype != TS_BF16) return (int)cudaErrorInvalidValue;
  if (page == TS_I8) {
    if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
    return (int)tc::dispatch<true>(D, q, pool_k, pool_v, ks, vs, tb, ps, o,
                                   B, Sq, H, Hkv, bs, mb, window, scale,
                                   softcap, s);
  }
  return (int)tc::dispatch<false>(D, q, pool_k, pool_v, ks, vs, tb, ps, o, B,
                                  Sq, H, Hkv, bs, mb, window, scale, softcap,
                                  s);
}
