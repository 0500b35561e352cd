// Kernel 2 of the port: one decode step (S = 1) of attention read
// straight off the block-table-paged KV pool, on Hopper.
//
// Replaces tpushare/ops/flash_attention.py _paged_decode_kernel behind
// paged_flash_decode() for f32/bf16 pages (the int8-page variant is not
// ported yet). q [B,1,H,D]; pool_k/pool_v [nb,bs,Hkv,D] (one layer's
// pool); table [B,mb] int32 pool block ids (-1 = unallocated); pos [B]
// int32; D in {128,256}. Slot b's query attends pool positions t <= pos[b] (and
// t > pos[b] - window when window > 0) through table[b, t / bs].
// Entries of -1 are never dereferenced: they are clamped out and their
// rows masked. Pages outside the slot's live range
// (_kv_live_range: [lo, hi) pages from the window floor to pos[b]) are
// never read. Online softmax in f32, optional tanh softcap; a slot with
// no live row (inactive, all -1) yields 0.
//
// Bound: decode moves every live K/V byte once and does ~4 FLOPs per
// element, so the bound is bytes. The design reads each live row once
// per (slot, kv head): one block per (kv head, slot) walks the slot's
// live positions 64 rows at a time, loading K and V rows (16-byte loads)
// into shared memory, and the GQA group of H/Hkv query heads shares
// every loaded row. At Gemma-2B's shape (Hkv = 1, 8 slots) that is 8
// blocks on 132 SMs, far from the memory rate: splitting the KV walk
// across blocks (split-KV) is the follow-up.

#include "common.cuh"

namespace {

constexpr int ROWS = 64;  // cache positions per tile (2 per lane per warp)
constexpr int NT = 128;   // threads per block
constexpr int NW = NT / 32;

template <int D>
size_t smem_bytes(int g) {
  return sizeof(float) *
         (size_t)(2 * ROWS * (D + 1) + g * D + g * ROWS + g * D + 3 * g);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ o, int H,
                    int Hkv, int bs, int mb, int window, float scale,
                    float softcap) {
  extern __shared__ float smem[];
  __shared__ long long rowsrc[ROWS];  // pool row of each tile row, -1 masked
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
  // _kv_live_range in pages: hi exclusive top, lo from the window floor.
  const long long hi = min(max(ts_floordiv(p, bs) + 1, 1LL), (long long)mb);
  const long long lo =
      min(max(ts_floordiv(p - w_eff + 1, bs), 0LL), hi - 1);

  for (int i = tid; i < g * D; i += NT) {
    Qs[i] = ts_to_f(q[((size_t)b * H + kvh * g) * D + i]) * scale;
    acc[i] = 0.f;
  }
  for (int h = tid; h < g; h += NT) {
    mstat[h] = TS_NEG_INF;
    lstat[h] = 0.f;
  }

  for (long long t0 = lo * bs; t0 < hi * bs; t0 += ROWS) {
    __syncthreads();  // previous tile consumed
    if (tid < ROWS) {
      const long long t = t0 + tid;
      long long src = -1;
      if (t < hi * bs && t <= p && t > p - w_eff) {
        const int e = table[(size_t)b * mb + t / bs];
        if (e >= 0) src = (long long)e * bs + t % bs;
      }
      rowsrc[tid] = src;
    }
    __syncthreads();
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const long long src = rowsrc[r];
      float kv[8], vv[8];
      if (src >= 0) {
        const size_t a = ((size_t)src * Hkv + kvh) * D + c;
        ts_load8(pool_k + a, kv);
        ts_load8(pool_v + a, vv);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* table, const int* pos, void* o, int B, int H,
                   int Hkv, int bs, int mb, int window, float scale,
                   float softcap, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, D>;
  const size_t smem = smem_bytes<D>(H / Hkv);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, pos, static_cast<T*>(o), H, Hkv, bs,
      mb, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* pk, const void* pv,
                       const int* table, const int* pos, void* o, int B,
                       int H, int Hkv, int bs, int mb, int window,
                       float scale, float softcap, cudaStream_t s) {
  switch (D) {
    case 128:
      return launch<T, 128>(q, pk, pv, table, pos, o, B, H, Hkv, bs, mb,
                            window, scale, softcap, s);
    case 256:
      return launch<T, 256>(q, pk, pv, table, pos, o, B, H, Hkv, bs, mb,
                            window, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (loaded with ctypes by ops/flash_attention.py). dtype:
// 0 = f32, 1 = bf16. softcap <= 0 means none; window <= 0 means global.
// Returns the cudaError_t of the launch.
extern "C" int ts_paged_decode(const void* q, const void* pool_k,
                               const void* pool_v, const void* table,
                               const void* pos, void* o, int B, int H,
                               int Hkv, int D, int bs, int mb, int dtype,
                               int window, float scale, float softcap,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == TS_F32)
    return (int)dispatch_d<float>(D, q, pool_k, pool_v, tb, ps, o, B, H, Hkv,
                                  bs, mb, window, scale, softcap, s);
  if (dtype == TS_BF16)
    return (int)dispatch_d<__nv_bfloat16>(D, q, pool_k, pool_v, tb, ps, o, B,
                                          H, Hkv, bs, mb, window, scale,
                                          softcap, s);
  return (int)cudaErrorInvalidValue;
}
