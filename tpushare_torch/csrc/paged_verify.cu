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
// tanh softcap, int8 rows times their f32 scale right after the load;
// a row with no live position yields 0.
//
// Bound: at Sq = 5 (verify) a slot's live K/V pages dominate and the
// bound is bytes (int8: half, plus the scales); at a fused tick's
// Sq = 512 every slot's 512 rows attend thousands of positions and the
// bound is operations. The TPU kernel walked one (slot, all heads) per
// sequential grid row and folded the rows g-major into one VMEM tile;
// on Hopper the blocks run in parallel, so this kernel tiles the rows
// across blocks: one block per (64-row tile, kv head, slot), rows
// ordered s-major (row = s * g + j for query head kv_head * g + j), so
// a tile holds a few consecutive positions of the GQA group and its
// key walk stops at the causal frontier of its newest row and starts
// at the window floor of its oldest: pages outside the union of its
// rows' live ranges are never loaded. Every loaded K/V row is shared
// by the tile's 64 query rows. Products are f32 FMAs out of shared
// memory, as in flash_prefill.cu (tensor cores are later work).

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

}  // namespace

// C entry point (loaded with ctypes by ops/flash_attention.py; the same
// signature as ts_paged_decode). dtype: q/output type, 0 = f32,
// 1 = bf16; page: the pools' type, equal to dtype or 2 = int8 (then
// k_scale and v_scale are [nb,Hkv,bs] f32). Sq >= 2. softcap <= 0 means
// none; window <= 0 means global. Returns the cudaError_t of the launch.
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
    return (int)dispatch_page<float>(page, D, q, pool_k, pool_v, ks, vs, tb,
                                     ps, o, B, Sq, H, Hkv, bs, mb, window,
                                     scale, softcap, s);
  if (dtype == TS_BF16)
    return (int)dispatch_page<__nv_bfloat16>(page, D, q, pool_k, pool_v, ks,
                                             vs, tb, ps, o, B, Sq, H, Hkv, bs,
                                             mb, window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
