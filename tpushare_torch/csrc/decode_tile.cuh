// The one-query-row decode walk shared by paged_decode.cu (a KV pool
// addressed through a block table) and flash_decode.cu (contiguous KV
// rows): both are S = 1 decode over the positions t <= pos[b] of a slot
// (and t > pos[b] - window when window > 0), and a contiguous row is a
// table of consecutive pages. The kernels are templates on the
// addressing (PagedAddr / RowAddr below), so each entry point launches
// its own instantiation and counts its own launches.
//
// Split-KV. Decode moves every live K/V byte once and does 1-4 FMAs per
// byte, so it is bound by bytes, and a slot's walk must be spread over
// the card to reach its memory rate: the grid is (split, kv head [x head
// chunk], slot), the split fastest so that one slot's splits go to
// neighbouring SMs rather than stacking on a few, and split s of S
// walks its own piece of the slot's live range. The host picks S from
// the shapes alone (ops/flash_attention.py decode_splits); each block
// finds its piece on the device from pos[b] and the window, by this
// rule:
//
//   [a, z)  = the live range: Addr::range's [t_lo, t_hi), cut to
//             t > pos - window and t <= pos
//   n       = ceil((z - a) / ROWS) tiles (0 when z <= a)
//   split s = tiles [s * n / S, (s + 1) * n / S) (floor division),
//             positions [a + ROWS * (s * n / S),
//                        min(a + ROWS * ((s + 1) * n / S), z))
//
// so every live position lies in exactly one split, a split holds whole
// tiles counted from a, and a split past the last tile is empty. Each
// split writes its unnormalized f32 accumulator [g, D], running max m and
// sum l to scratch; merge_kernel, launched right after it by the same C
// entry point (one ctypes call per decode), combines the S partials of
// each (slot, head) in a fixed order (two launches on the same inputs
// give equal bits) and writes the output. An empty split only writes m =
// -1e30 (TS_NEG_INF) and l = 0, and the merge skips it; a slot with no
// live row yields 0. With S = 1 the split kernel writes the output itself
// and no merge runs. Nothing on the host depends on device data.
//
// Inside a block (128 threads, 4 warps): K and V tiles of ROWS positions
// stay in their stored type in shared memory (bf16, f32, or int8), in a
// ring of 2-4 stages filled by 16-byte cp.async copies. A paged tile's
// table entries are copied (4-byte cp.async) LEAD + 1 tiles ahead of its K/V
// copies and turned into pool rows by warp 0 in between, so no copy
// waits on a table read. Warp w takes rows [8w, 8w + 8) of each tile in
// chunks of RC rows. Lane l holds D / 32 elements of a row (element d =
// c * 32 W + l * W + j: W-wide shared loads, c < D / (32 W)) and the q
// of all G heads of the block for those elements, in registers: each K
// or V element is read from shared memory once and used for every head.
// A chunk's RC x G partial dot products are summed across lanes by a
// reduce-scatter of shuffles (each lane ends with one score), so no
// dependent chain is longer than D / 32. Int8 rows are widened to f32 in
// registers; the row's k scale multiplies its score and its v scale its
// probability. Online softmax in f32, optional tanh softcap applied
// before the mask. Rows outside the split's range and -1 table entries
// are never read: their copies zero-fill.
#pragma once

#include "wgmma.cuh"

namespace decode_tile {

constexpr int ROWS = 32;        // positions per tile (DECODE_TILE_ROWS)
constexpr int NT = 128;         // threads per block
constexpr int NW = NT / 32;     // warps
constexpr int RPW = ROWS / NW;  // tile rows per warp
constexpr int GMAX = 8;         // query heads per block (DECODE_GROUP)
constexpr int MERGE_NT = 256;   // threads per merge block
static_assert(ROWS == 32, "warp 0 looks up a tile's rows, one per lane");

// Per (page type, head dim): a lane's share of a row and the ring.
template <typename P, int D>
struct Cfg {
  static constexpr int E = D / 32;  // elements of a row per lane
  static constexpr int W =
      E < 16 / (int)sizeof(P) ? E : 16 / (int)sizeof(P);  // per load
  static constexpr int NC = E / W;                        // loads per row
  static constexpr int ROW_BYTES = D * (int)sizeof(P);
  static constexpr int UNITS = ROW_BYTES / 16;  // 16-byte copies per row
  static constexpr int STAGE = 2 * ROWS * ROW_BYTES;  // K tile, V tile
  // 2-4 stages: 64-128 KB of ring a block, so two or more blocks share
  // an SM (bf16 at D 256: 3 x 32 KB).
  static constexpr int STAGES = STAGE >= 65536 ? 2 : STAGE >= 32768 ? 3 : 4;
  static constexpr int LEAD = STAGES - 1;  // K/V copies: tiles ahead
  // Paged: a tile's table entries are copied LEAD + 1 tiles ahead of its
  // K/V copies; warp 0 turns them into pool rows the iteration before.
  static constexpr int NSLOT = 2 * LEAD + 2;  // entry and pool-row rings
};

// Block-table pool [nb, bs, Hkv, D]: position t of slot b lives in pool
// row table[b, t / bs] * bs + t % bs; -1 entries are never dereferenced.
// range: _kv_live_range's whole pages, [lo, hi) pages from the window
// floor to pos[b].
struct PagedAddr {
  static constexpr bool TABLE = true;
  const int* table;
  int bs, mb;
  __device__ void range(long long p, long long w_eff, long long& t_lo,
                        long long& t_hi) const {
    const long long hi = min(max(ts_floordiv(p, bs) + 1, 1LL), (long long)mb);
    const long long lo =
        min(max(ts_floordiv(p - w_eff + 1, bs), 0LL), hi - 1);
    t_lo = lo * bs;
    t_hi = hi * bs;
  }
  // The table entry of position t (0 <= t < mb * bs) of slot b.
  __device__ const int* entry(int b, long long t) const {
    return table + (size_t)b * mb + t / bs;
  }
  // Pool row of position t given its table entry e, or -1.
  __device__ long long src(int, int e, long long t) const {
    return e < 0 ? -1 : (long long)e * bs + t % bs;
  }
  // Index of pool row src's scale for kv head kvh in [nb, Hkv, bs].
  __device__ size_t scale_index(long long src, int kvh, int Hkv) const {
    return ((size_t)(src / bs) * Hkv + kvh) * bs + src % bs;
  }
};

// Contiguous rows [B, M, Hkv, D]: position t of slot b is row b * M + t.
// range: max(0, pos[b] - window + 1) .. min(pos[b], M - 1).
struct RowAddr {
  static constexpr bool TABLE = false;
  int M;
  __device__ void range(long long p, long long w_eff, long long& t_lo,
                        long long& t_hi) const {
    t_hi = min(p + 1, (long long)M);
    t_lo = max(p - w_eff + 1, 0LL);
  }
  __device__ const int* entry(int, long long) const { return nullptr; }
  __device__ long long src(int b, int, long long t) const {
    return (long long)b * M + t;
  }
  __device__ size_t scale_index(long long, int, int) const { return 0; }
};

// Four int8 (one word) as four f32, exactly: byte x + 128 becomes the
// low mantissa bits of 2^23, and subtracting 2^23 + 128 leaves x.
__device__ __forceinline__ void i8x4_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
             8388736.f;
}

// W consecutive elements of type P from shared memory, as f32.
template <int W, typename P>
__device__ __forceinline__ void ld_w(const P* s, float* out) {
  if constexpr (std::is_same<P, float>::value) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(s + i);
      out[i] = a.x;
      out[i + 1] = a.y;
      out[i + 2] = a.z;
      out[i + 3] = a.w;
    }
  } else if constexpr (std::is_same<P, __nv_bfloat16>::value) {
    uint32_t w[W / 2];
    if constexpr (W == 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(s);
      w[0] = a.x;
      w[1] = a.y;
      w[2] = a.z;
      w[3] = a.w;
    } else {
      static_assert(W == 4, "bf16 rows load 8 or 16 bytes");
      const uint2 a = *reinterpret_cast<const uint2*>(s);
      w[0] = a.x;
      w[1] = a.y;
    }
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
    static_assert(std::is_same<P, int8_t>::value, "f32, bf16 or int8");
    if constexpr (W == 8) {
      const uint2 a = *reinterpret_cast<const uint2*>(s);
      i8x4_f32(a.x, out);
      i8x4_f32(a.y, out + 4);
    } else {
      static_assert(W == 4, "int8 rows load 4 or 8 bytes");
      i8x4_f32(*reinterpret_cast<const uint32_t*>(s), out);
    }
  }
}

// This lane's D / 32 elements of a row in shared memory, as f32.
template <typename P, int D>
__device__ __forceinline__ void lane_row(const unsigned char* row, int lane,
                                         float* out) {
  using C = Cfg<P, D>;
  const P* r = reinterpret_cast<const P*>(row);
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
    ld_w<C::W>(r + c * 32 * C::W + lane * C::W, out + c * C::W);
}

// Reduce-scatter of N values (N a power of two, <= 32) over a warp: on
// return v[0] of every lane holds the warp's sum of value lane >> (5 -
// log2 N). Each step trades half of the values still held with the lane
// OFF away, so summing 32 values takes 31 shuffles, not 160.
template <int N, int n, int OFF>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float (&v)[N], int lane) {
    if constexpr (OFF > 0) {
      if constexpr (n > 1) {
        const bool up = lane & OFF;
#pragma unroll
        for (int i = 0; i < n / 2; ++i) {
          const float keep = up ? v[i + n / 2] : v[i];
          const float give = up ? v[i] : v[i + n / 2];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, give, OFF);
        }
        ReduceScatter<N, n / 2, OFF / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
        ReduceScatter<N, 1, OFF / 2>::run(v, lane);
      }
    }
  }
};

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// One split of one (kv head, head chunk, slot): grid (S, Hkv * chunks,
// B). G: query heads this block holds (the group g rounded up to 1, 2,
// 4 or 8; a group above 8 takes ceil(g / 8) blocks per kv head). part:
// S > 1 only, [B, H, S, D] accumulators and [B, H, S, 2] (m, l).
template <typename T, typename P, int D, int G, typename Addr>
__global__ void __launch_bounds__(NT, 2)
split_kernel(const T* __restrict__ q, const P* __restrict__ kc,
             const P* __restrict__ vc, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, Addr addr,
             const int* __restrict__ pos, T* __restrict__ o,
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             int H, int Hkv, int window, float scale, float softcap) {
  using C = Cfg<P, D>;
  constexpr bool Q8 = std::is_same<P, int8_t>::value;
  constexpr int E = C::E, STAGES = C::STAGES, NSLOT = C::NSLOT;
  constexpr int LEAD = C::LEAD;
  constexpr int RC = 32 / G < RPW ? 32 / G : RPW;  // rows per chunk
  constexpr int N = RC * G;                        // scores per chunk
  constexpr int LOGG = ilog2(G);
  constexpr int SH = 5 - ilog2(N);  // lane >> SH: the lane's score index
  static_assert(NW * G * D * 4 <= STAGES * C::STAGE,
                "the warps' merge reuses the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  // Paged: each tile row's table entry, and its pool row (-1: masked).
  __shared__ int rowe[Addr::TABLE ? NSLOT : 1][ROWS];
  __shared__ long long rowsrc[Addr::TABLE ? NSLOT : 1][ROWS];
  __shared__ float rowks[Q8 ? STAGES : 1][ROWS], rowvs[Q8 ? STAGES : 1][ROWS];
  __shared__ __align__(16) float pbuf[NW][2][32 + GMAX];  // p, then alpha
  __shared__ float wst[3][NW][G];  // per warp: m, l, merge factor
  __shared__ float hsum[G];        // per head: the block's l

  const int nch = (H / Hkv + G - 1) / G;
  const int kvh = blockIdx.y / nch, hc = blockIdx.y % nch;
  const int b = blockIdx.z, split = blockIdx.x, S = gridDim.x;
  const int g = H / Hkv, h0 = kvh * g + hc * G, gcount = min(G, g - hc * G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t ring = ts_smem_addr(smem);

  // This split's piece of the live range (the rule above).
  const long long p = pos[b];
  const long long w_eff = window > 0 ? window : TS_GLOBAL_SPAN;
  long long a, z;
  addr.range(p, w_eff, a, z);
  a = max(a, p - w_eff + 1);
  z = min(z, p + 1);
  const long long n = z > a ? (z - a + ROWS - 1) / ROWS : 0;
  const long long j0 = split * n / S, j1 = (split + 1) * n / S;
  const long long s_lo = a + j0 * ROWS, s_hi = min(a + j1 * ROWS, z);
  const int ntiles = (int)(j1 - j0);

  // Nothing live in this piece: the output 0 (S = 1), or m = -1e30 and
  // l = 0, which the merge skips without reading the accumulator.
  if (ntiles == 0) {
    if (S == 1) {
      for (int i = tid; i < gcount * D; i += NT)
        o[((size_t)b * H + h0) * D + i] = ts_from_f<T>(0.f);
    } else if (tid < gcount) {
      const size_t bh = (size_t)b * H + h0 + tid;
      part_ml[(bh * S + split) * 2] = TS_NEG_INF;
      part_ml[(bh * S + split) * 2 + 1] = 0.f;
    }
    return;
  }

  auto in_piece = [&](int it, int r) {
    return it < ntiles && s_lo + (long long)it * ROWS + r < s_hi;
  };
  auto t_of = [&](int it, int r) { return s_lo + (long long)it * ROWS + r; };
  // Pool row of row r of tile it, or -1 (past the piece, or a -1 entry).
  auto src_of = [&](int it, int r) -> long long {
    if constexpr (Addr::TABLE)
      return rowsrc[it % NSLOT][r];
    else
      return in_piece(it, r) ? addr.src(b, 0, t_of(it, r)) : -1LL;
  };
  // Paged, warp 0 (one row per lane): copy tile it's table entries ...
  auto fetch_entries = [&](int it) {
    if constexpr (Addr::TABLE) {
      if (warp == 0 && in_piece(it, lane))
        ts_cp_async4(ts_smem_addr(&rowe[it % NSLOT][lane]),
                     addr.entry(b, t_of(it, lane)), true);
    }
  };
  // ... and, once they have landed, turn them into pool rows.
  auto convert = [&](int it) {
    if constexpr (Addr::TABLE) {
      if (warp == 0)
        rowsrc[it % NSLOT][lane] =
            in_piece(it, lane)
                ? addr.src(b, rowe[it % NSLOT][lane], t_of(it, lane))
                : -1LL;
    }
  };
  // K, V (and int8 scales) of tile it into ring stage it % STAGES, and
  // the table entries of tile it + LEAD + 1; one cp.async group per call.
  auto copy_tile = [&](int it) {
    if (it < ntiles) {
      const int st = it % STAGES;
      const uint32_t kd = ring + st * C::STAGE, vd = kd + ROWS * C::ROW_BYTES;
      for (int i = tid; i < ROWS * C::UNITS; i += NT) {
        const int r = i / C::UNITS, u = i % C::UNITS;
        const long long src = src_of(it, r);
        const bool ok = src >= 0;
        const size_t e = ((size_t)(ok ? src : 0) * Hkv + kvh) * D;
        const uint32_t off = r * C::ROW_BYTES + u * 16;
        ts_cp_async16(kd + off, reinterpret_cast<const char*>(kc + e) + u * 16,
                      ok);
        ts_cp_async16(vd + off, reinterpret_cast<const char*>(vc + e) + u * 16,
                      ok);
      }
      if constexpr (Q8) {
        if (tid < ROWS) {
          const long long src = src_of(it, tid);
          const bool ok = src >= 0;
          const size_t si = ok ? addr.scale_index(src, kvh, Hkv) : 0;
          ts_cp_async4(ts_smem_addr(&rowks[st][tid]), k_scale + si, ok);
          ts_cp_async4(ts_smem_addr(&rowvs[st][tid]), v_scale + si, ok);
        }
      }
    }
    fetch_entries(it + LEAD + 1);
    ts_cp_commit();
  };

  // q of the block's heads for this lane's elements, pre-scaled.
  float qr[G][E];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    const T* qh = q + ((size_t)b * H + h0 + min(hh, gcount - 1)) * D;
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
      ld_w<C::W>(qh + c * 32 * C::W + lane * C::W, &qr[hh][c * C::W]);
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[hh][e] = hh < gcount ? qr[hh][e] * scale : 0.f;
  }

  // The pool rows of the first LEAD + 1 tiles from plain table loads,
  // then the first LEAD tiles' copies.
  if constexpr (Addr::TABLE) {
    if (warp == 0) {
      int en[LEAD + 1];
#pragma unroll
      for (int s = 0; s <= LEAD; ++s)
        en[s] = in_piece(s, lane) ? *addr.entry(b, t_of(s, lane)) : -1;
#pragma unroll
      for (int s = 0; s <= LEAD; ++s)
        rowsrc[s][lane] =
            in_piece(s, lane) ? addr.src(b, en[s], t_of(s, lane)) : -1LL;
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < LEAD; ++s) copy_tile(s);

  // The lane's score: row my_r of the chunk, head my_h; its m and l are
  // that head's (equal on every lane of the head).
  const int my_i = lane >> SH, my_r = my_i / G, my_h = my_i % G;
  const bool owner = (lane & ((1 << SH) - 1)) == 0;
  float m_run = TS_NEG_INF, l_run = 0.f;
  float acc[G][E];
#pragma unroll
  for (int hh = 0; hh < G; ++hh)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[hh][e] = 0.f;
  int par = 0;

  for (int it = 0; it < ntiles; ++it) {
    ts_cp_wait<STAGES - 2>();
    __syncthreads();  // tile it and tile it + LEAD + 1's entries landed
    copy_tile(it + LEAD);
    convert(it + LEAD + 1);
    const int st = it % STAGES;
    const unsigned char* kt = smem + st * C::STAGE;
    const unsigned char* vt = kt + ROWS * C::ROW_BYTES;
#pragma unroll
    for (int c0 = 0; c0 < RPW; c0 += RC) {
      const int r0 = warp * RPW + c0;
      float sv[N];
#pragma unroll
      for (int i = 0; i < N; ++i) sv[i] = 0.f;
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float kf[E];
        lane_row<P, D>(kt + (r0 + r) * C::ROW_BYTES, lane, kf);
#pragma unroll
        for (int hh = 0; hh < G; ++hh)
#pragma unroll
          for (int e = 0; e < E; ++e)
            sv[r * G + hh] = fmaf(qr[hh][e], kf[e], sv[r * G + hh]);
      }
      ReduceScatter<N, N, 16>::run(sv, lane);
      const int row = r0 + my_r;
      const bool valid = src_of(it, row) >= 0;
      float s = sv[0];
      if constexpr (Q8) s *= rowks[st][row];
      s = valid ? ts_softcap(s, softcap) : TS_NEG_INF;
      float cm = s;
#pragma unroll
      for (int off = 1 << (SH + LOGG); off < 32; off <<= 1)
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
      const float m_new = fmaxf(m_run, cm);
      const float alpha = expf(m_run - m_new);
      const float pr = valid ? expf(s - m_new) : 0.f;
      float cs = pr;
#pragma unroll
      for (int off = 1 << (SH + LOGG); off < 32; off <<= 1)
        cs += __shfl_xor_sync(0xffffffffu, cs, off);
      l_run = l_run * alpha + cs;
      m_run = m_new;
      // Every lane needs every p and alpha of the chunk: one owner lane
      // per score publishes them (v scale folded into p).
      float* pb = pbuf[warp][par];
      par ^= 1;
      if (owner) {
        float pw = pr;
        if constexpr (Q8) pw *= rowvs[st][row];
        pb[my_i] = pw;
        if (my_r == 0) pb[32 + my_h] = alpha;
      }
      __syncwarp();
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        const float al = pb[32 + hh];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[hh][e] *= al;
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float vf[E];
        lane_row<P, D>(vt + (r0 + r) * C::ROW_BYTES, lane, vf);
#pragma unroll
        for (int hh = 0; hh < G; ++hh) {
          const float pw = pb[r * G + hh];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[hh][e] = fmaf(pw, vf[e], acc[hh][e]);
        }
      }
    }
  }

  // Merge the four warps' partials through the (now idle) ring.
  ts_cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [NW][G][D]
#pragma unroll
  for (int hh = 0; hh < G; ++hh)
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int j = 0; j < C::W; ++j)
        red[(warp * G + hh) * D + c * 32 * C::W + lane * C::W + j] =
            acc[hh][c * C::W + j];
  if (owner && my_r == 0) {
    wst[0][warp][my_h] = m_run;
    wst[1][warp][my_h] = l_run;
  }
  __syncthreads();
  if (tid < G) {
    float M = wst[0][0][tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) M = fmaxf(M, wst[0][w][tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wst[0][w][tid] - M);
      wst[2][w][tid] = f;
      L += wst[1][w][tid] * f;
    }
    wst[0][0][tid] = M;  // read below once every warp's m is folded in
    hsum[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int hh = i / D, d = i % D;
    if (hh >= gcount) continue;
    float acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      acc_d = fmaf(red[(w * G + hh) * D + d], wst[2][w][hh], acc_d);
    const size_t bh = (size_t)b * H + h0 + hh;
    if (S == 1)
      o[bh * D + d] = ts_from_f<T>(acc_d / fmaxf(hsum[hh], 1e-30f));
    else
      part_acc[(bh * S + split) * D + d] = acc_d;
  }
  if (S > 1 && tid < gcount) {
    const size_t bh = (size_t)b * H + h0 + tid;
    part_ml[(bh * S + split) * 2] = wst[0][0][tid];
    part_ml[(bh * S + split) * 2 + 1] = hsum[tid];
  }
}

// Combine the S partials of (head blockIdx.x, slot blockIdx.y): M = max
// m_s, L = sum l_s exp(m_s - M), out = sum acc_s exp(m_s - M) / max(L,
// 1e-30), with splits of l_s = 0 (empty, or nothing live) skipped. The
// order is fixed: thread (phase j, column c) sums splits j, j + J, ...
// in turn, and the J phases are added in order, so two launches give
// equal bits. Shared memory: 2 S + 4 MERGE_NT floats.
template <typename T>
__global__ void __launch_bounds__(MERGE_NT)
merge_kernel(const float* __restrict__ part_acc,
             const float* __restrict__ part_ml, T* __restrict__ o, int H,
             int S, int D) {
  extern __shared__ float ws[];  // [S] weights, [S] l, [J][D] phase sums
  const size_t bh = (size_t)blockIdx.y * H + blockIdx.x;
  const float* ml = part_ml + bh * S * 2;
  const int C4 = D / 4, J = MERGE_NT / C4;  // float4 columns, phases
  const int c = threadIdx.x % C4, j = threadIdx.x / C4;
  float* wl = ws + S;
  float* ph = ws + 2 * S;
  for (int s = threadIdx.x; s < S; s += MERGE_NT) {
    ws[s] = ml[2 * s];
    wl[s] = ml[2 * s + 1];
  }
  __syncthreads();
  float M = TS_NEG_INF;
  for (int s = 0; s < S; ++s) M = fmaxf(M, ws[s]);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += MERGE_NT)
    ws[s] = wl[s] > 0.f ? expf(ws[s] - M) : 0.f;
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < S; ++s) L = fmaf(wl[s], ws[s], L);
  const float* acc = part_acc + bh * S * D + 4 * c;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = j; s0 < S; s0 += 4 * J) {
    float w[4];
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + i * J;
      w[i] = s < S ? ws[s] : 0.f;
      if (w[i] != 0.f)
        x[i] = *reinterpret_cast<const float4*>(acc + (size_t)s * D);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (w[i] != 0.f) {
        sum.x = fmaf(x[i].x, w[i], sum.x);
        sum.y = fmaf(x[i].y, w[i], sum.y);
        sum.z = fmaf(x[i].z, w[i], sum.z);
        sum.w = fmaf(x[i].w, w[i], sum.w);
      }
  }
  *reinterpret_cast<float4*>(ph + j * D + 4 * c) = sum;
  __syncthreads();
  if (j == 0) {
    const float inv = L > 0.f ? 1.f / L : 0.f;
    T* out = o + bh * D + 4 * c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float t = 0.f;
      for (int jj = 0; jj < J; ++jj) t += ph[jj * D + 4 * c + e];
      out[e] = ts_from_f<T>(t * inv);
    }
  }
}

template <typename T, typename P, int D, int G, typename Addr>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const float* ks, const float* vs, Addr addr,
                   const int* pos, void* o, float* scratch, int B, int H,
                   int Hkv, int S, int window, float scale, float softcap,
                   cudaStream_t stream) {
  using C = Cfg<P, D>;
  auto kern = split_kernel<T, P, D, G, Addr>;
  const int smem = C::STAGES * C::STAGE;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  float* part_ml = S > 1 ? scratch + (size_t)B * H * S * D : nullptr;
  const int nch = (H / Hkv + G - 1) / G;
  kern<<<dim3(S, Hkv * nch, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kc),
      static_cast<const P*>(vc), ks, vs, addr, pos, static_cast<T*>(o),
      scratch, part_ml, H, Hkv, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  merge_kernel<T><<<dim3(H, B), MERGE_NT,
                     (2 * S + 4 * MERGE_NT) * sizeof(float), stream>>>(
      scratch, part_ml, static_cast<T*>(o), H, S, D);
  return cudaGetLastError();
}

// Instantiation by head dim and group: G is g rounded up to 1, 2, 4 or
// 8. S >= 1 splits; scratch: B * H * S * (D + 2) f32 when S > 1.
template <typename T, typename P, typename Addr>
cudaError_t dispatch_d(int D, const void* q, const void* kc, const void* vc,
                       const float* ks, const float* vs, Addr addr,
                       const int* pos, void* o, float* scratch, int B, int H,
                       int Hkv, int S, int window, float scale,
                       float softcap, cudaStream_t s) {
  if (S < 1 || (S > 1 && scratch == nullptr)) return cudaErrorInvalidValue;
  const int g = H / Hkv;
#define TS_DECODE_G(DD, GG)                                                 \
  return launch<T, P, DD, GG>(q, kc, vc, ks, vs, addr, pos, o, scratch, B, \
                              H, Hkv, S, window, scale, softcap, s)
#define TS_DECODE_D(DD)    \
  if (g <= 1) TS_DECODE_G(DD, 1); \
  if (g <= 2) TS_DECODE_G(DD, 2); \
  if (g <= 4) TS_DECODE_G(DD, 4); \
  TS_DECODE_G(DD, 8)
  switch (D) {
    case 128:
      TS_DECODE_D(128);
    case 256:
      TS_DECODE_D(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef TS_DECODE_D
#undef TS_DECODE_G
}

}  // namespace decode_tile
