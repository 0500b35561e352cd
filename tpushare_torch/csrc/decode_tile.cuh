// The one-query-row decode walk shared by paged_decode.cu (a KV pool
// addressed through a block table) and flash_decode.cu (contiguous KV
// rows): both are S = 1 decode over the positions t <= pos[b] of a slot
// (and t > pos[b] - window when window > 0), and a contiguous row is a
// table of consecutive pages. The kernel is a template on the
// addressing (PagedAddr / RowAddr below), so each entry point launches
// its own instantiation and counts its own launches.
//
// One block per (kv head, slot) walks the slot's live positions 64 rows
// at a time, loading K and V rows (16-byte loads) into shared memory;
// the GQA group of H/Hkv query heads shares every loaded row. Rows
// outside the live range are never loaded. Online softmax in f32,
// optional tanh softcap applied before the mask; int8 pages (paged
// addressing only) are multiplied by their f32 row scale right after
// the load. A slot with no live row yields 0.
#pragma once

#include "common.cuh"

namespace decode_tile {

constexpr int ROWS = 64;  // cache positions per tile (2 per lane per warp)
constexpr int NT = 128;   // threads per block
constexpr int NW = NT / 32;

template <int D>
size_t smem_bytes(int g) {
  return sizeof(float) *
         (size_t)(2 * ROWS * (D + 1) + g * D + g * ROWS + g * D + 3 * g);
}

// Block-table pool [nb, bs, Hkv, D]: position t of slot b lives in pool
// row table[b, t / bs] * bs + t % bs; -1 entries are never dereferenced.
// The walk covers _kv_live_range's whole pages, [lo, hi) pages from the
// window floor to pos[b].
struct PagedAddr {
  const int* table;
  int bs, mb;
  __device__ void range(int, long long p, long long w_eff, long long& t_lo,
                        long long& t_hi) const {
    const long long hi = min(max(ts_floordiv(p, bs) + 1, 1LL), (long long)mb);
    const long long lo =
        min(max(ts_floordiv(p - w_eff + 1, bs), 0LL), hi - 1);
    t_lo = lo * bs;
    t_hi = hi * bs;
  }
  // Pool row of position t (or -1); *sidx: its scale-page index.
  __device__ long long row(int b, long long t, int kvh, int Hkv,
                           size_t* sidx) const {
    const int e = table[(size_t)b * mb + t / bs];
    if (e < 0) return -1;
    *sidx = ((size_t)e * Hkv + kvh) * bs + t % bs;
    return (long long)e * bs + t % bs;
  }
};

// Contiguous rows [B, M, Hkv, D]: position t of slot b is row b * M + t.
// The walk covers exactly max(0, pos[b] - window + 1) .. min(pos[b], M-1).
struct RowAddr {
  int M;
  __device__ void range(int, long long p, long long w_eff, long long& t_lo,
                        long long& t_hi) const {
    t_hi = min(p + 1, (long long)M);
    t_lo = max(p - w_eff + 1, 0LL);
  }
  __device__ long long row(int b, long long t, int, int, size_t*) const {
    return (long long)b * M + t;
  }
};

template <typename T, typename P, int D, typename Addr>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const P* __restrict__ kc,
              const P* __restrict__ vc, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, Addr addr,
              const int* __restrict__ pos, T* __restrict__ o, int H, int Hkv,
              int window, float scale, float softcap) {
  extern __shared__ float smem[];
  __shared__ long long rowsrc[ROWS];  // cache row of each tile row, -1 masked
  __shared__ float rowks[ROWS], rowvs[ROWS];  // int8 pages: row scales
  constexpr bool Q8 = std::is_same<P, int8_t>::value;
  constexpr int DP = D + 1;
  constexpr int CH = D / 8;
  const int g = H / Hkv;
  float* Ks = smem;                // [ROWS][DP]
  float* Vs = Ks + ROWS * DP;      // [ROWS][DP]
  float* Qs = Vs + ROWS * DP;      // [g][D], pre-scaled
  float* Ps = Qs + g * D;          // [g][ROWS] scores, then probabilities
  float* acc = Ps + g * ROWS;      // [g][D]
  float* mstat = acc + g * D;      // running max [g]
  float* lstat = mstat + g;        // running sum [g]
  float* astat = lstat + g;        // this tile's rescale factor [g]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long p = pos[b];
  const long long w_eff = window > 0 ? window : TS_GLOBAL_SPAN;
  long long t_lo, t_hi;
  addr.range(b, p, w_eff, t_lo, t_hi);

  for (int i = tid; i < g * D; i += NT) {
    Qs[i] = ts_to_f(q[((size_t)b * H + kvh * g) * D + i]) * scale;
    acc[i] = 0.f;
  }
  for (int h = tid; h < g; h += NT) {
    mstat[h] = TS_NEG_INF;
    lstat[h] = 0.f;
  }

  for (long long t0 = t_lo; t0 < t_hi; t0 += ROWS) {
    __syncthreads();  // previous tile consumed
    if (tid < ROWS) {
      const long long t = t0 + tid;
      long long src = -1;
      float sk = 0.f, sv = 0.f;
      if (t < t_hi && t <= p && t > p - w_eff) {
        size_t sa = 0;
        src = addr.row(b, t, kvh, Hkv, &sa);
        if constexpr (Q8) {
          if (src >= 0) {
            sk = k_scale[sa];
            sv = v_scale[sa];
          }
        }
      }
      rowsrc[tid] = src;
      rowks[tid] = sk;
      rowvs[tid] = sv;
    }
    __syncthreads();
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const long long src = rowsrc[r];
      float kv[8], vv[8];
      if (src >= 0) {
        const size_t a = ((size_t)src * Hkv + kvh) * D + c;
        ts_load8(kc + a, kv);
        ts_load8(vc + a, vv);
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
    for (int e = tid; e < g * ROWS; e += NT) {
      const int h = e / ROWS, r = e % ROWS;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(Qs[h * D + d], Ks[r * DP + d], s);
      Ps[e] = rowsrc[r] >= 0 ? ts_softcap(s, softcap) : TS_NEG_INF;
    }
    __syncthreads();
    // Online softmax: one warp per query head, two tile rows per lane.
    for (int h = warp; h < g; h += NW) {
      const float s0 = Ps[h * ROWS + lane], s1 = Ps[h * ROWS + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mstat[h];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = s0 > TS_NEG_INF / 2 ? expf(s0 - m_new) : 0.f;
      const float p1 = s1 > TS_NEG_INF / 2 ? expf(s1 - m_new) : 0.f;
      Ps[h * ROWS + lane] = p0;
      Ps[h * ROWS + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        astat[h] = alpha;
        lstat[h] = lstat[h] * alpha + sum;
        mstat[h] = m_new;
      }
    }
    __syncthreads();
    // acc[h][d] = acc * alpha + sum_r p[h][r] * V[r][d]; each thread
    // owns whole columns, so no two threads touch one accumulator.
    for (int d = tid; d < D; d += NT) {
      for (int h = 0; h < g; ++h) {
        float a = acc[h * D + d] * astat[h];
#pragma unroll 8
        for (int r = 0; r < ROWS; ++r)
          a = fmaf(Ps[h * ROWS + r], Vs[r * DP + d], a);
        acc[h * D + d] = a;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += NT) {
    const int h = i / D;
    o[((size_t)b * H + kvh * g) * D + i] =
        ts_from_f<T>(acc[i] / fmaxf(lstat[h], 1e-30f));
  }
}

template <typename T, typename P, int D, typename Addr>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const float* ks, const float* vs, Addr addr,
                   const int* pos, void* o, int B, int H, int Hkv, int window,
                   float scale, float softcap, cudaStream_t stream) {
  auto kern = decode_kernel<T, P, D, Addr>;
  const size_t smem = smem_bytes<D>(H / Hkv);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kc),
      static_cast<const P*>(vc), ks, vs, addr, pos, static_cast<T*>(o), H,
      Hkv, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T, typename P, typename Addr>
cudaError_t dispatch_d(int D, const void* q, const void* kc, const void* vc,
                       const float* ks, const float* vs, Addr addr,
                       const int* pos, void* o, int B, int H, int Hkv,
                       int window, float scale, float softcap,
                       cudaStream_t s) {
  switch (D) {
    case 128:
      return launch<T, P, 128>(q, kc, vc, ks, vs, addr, pos, o, B, H, Hkv,
                               window, scale, softcap, s);
    case 256:
      return launch<T, P, 256>(q, kc, vc, ks, vs, addr, pos, o, B, H, Hkv,
                               window, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode_tile
