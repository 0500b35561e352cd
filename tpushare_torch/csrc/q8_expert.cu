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
// Two passes, no float atomics, so every sum has one fixed order and two
// launches on the same inputs are bit-equal: pass 1 forms ff = act(g *
// sg) * (u * su) over (F tile, C tile, expert) blocks, pass 2 reduces
// ff . Wd over F for each (Dm tile, C tile, expert) and applies sd.
//
// Bound: at decode (C = the slots, 8) bytes: every int8 weight byte
// crosses HBM once per call (Mixtral-8x7B: 1.41 GB a layer, 0.42 ms at
// 3.35 TB/s); at admission blocks under dense dispatch (C in the
// thousands) operations: 6 Dm F C E flops (Mixtral C 2048: 5.84 ms at
// the bf16 tensor-core rate).
//
// Two bodies, by x's type:
//
// bf16 x (every main path): the tensor-core body (tc::, wgmma.cuh), which
// replaced the SIMT body below for bf16. The product is swapped: pass 1
// computes ff^T [F, C] = Wg^T . x^T (and Wu^T . x^T), pass 2 y^T [Dm, C]
// = Wd^T . ff^T, so the weights are wgmma's 64-row M side and the tokens
// its N (a C tile of 8 .. 128). One orientation serves both regimes: at
// C 8 no product is spent on padding rows (an m64n8 per step), and at
// C 2048 each widened weight tile is reused by 64 or 128 tokens. A block
// of two warpgroups owns 128 weight columns (64 each) of one C tile of
// one expert (pass 1 past 64 tokens: 64 columns, one warpgroup per
// matrix), blockIdx.x the C tile, so the blocks that share a weight tile
// run together and the weights cross HBM about once.
// - Weights stay int8 in device memory. Each 64-deep int8 tile (pass 1:
//   Wg's and Wu's) lands by cp.async in a ring of 3..8 stages, with the B
//   tile of the same depth (x, or the ff terms) beside it in the 128-byte
//   swizzled layout; S - 1 tiles are in flight while one is used. Where
//   four stages still fit in half an SM's shared memory (both passes at
//   decode) two blocks share an SM.
// - The int8 tile is widened in shared memory into a bf16 swizzled tile
//   (exact; ts_widen_i8, by byte permutes and an f32 add, no I2F), double
//   buffered past 16 tokens: tile k + 1 is widened while tile k's
//   products run. The widened tile is the A operand as it lies: [depth]
//   [columns] is MN-major (ts_wgmma_ss_mn), so no transpose is spent.
// - Each stage's products land in a fresh accumulator and are added to
//   the sum with rounded f32 adds: the tensor cores' chained f32 sum
//   rounds toward zero, and chained over Mixtral's 14336-deep down
//   product it moved outputs near 0 by 2-5x their gate (on an H100).
// - x and the int8 weights are both exact in bf16: x . Wg and x . Wu need
//   no split. ff is f32 and enters pass 2 as FF_TERMS = 3 bf16 terms
//   (t0 = bf16(ff), t1 = bf16(ff - t0), t2 = bf16(ff - t0 - t1): all its
//   24 bits), stored one after another so one product of N = 3 x C tile
//   covers them all. One rounding misses chip_smoke.py's gate by >100x;
//   two terms meet it but flip ~6x more bf16 outputs than three
//   (tests/test_torch_q8_numerics.py) and carried Mixtral's served
//   logits past their gate on an H100 (PERF.md §6). Three terms cost 5/3
//   of the one-term MMA work at C 2048.
// - Pass 1's epilogue applies sg, su and the activation in f32 on the
//   sums, stages the tile through shared memory and writes ff as its
//   bf16 terms [3, E, C, F] with 16-byte stores; pass 2 applies sd
//   after its dot and writes y the same way.
//
// f32 x (the card tests' f32 cases; no main path runs it): the SIMT body
// (simt::), unchanged from the first version: 32 x 128 int8 tiles widened
// to f32 in shared memory with the next tile's 16-byte loads in flight,
// f32 FMAs on register tiles, ff in f32 [E, C, F].

#include "wgmma.cuh"

namespace {

enum TsAct { ACT_SILU = 0, ACT_GELU = 1 };

__device__ __forceinline__ float apply_act(int act, float x) {
  if (act == ACT_SILU) return x / (1.f + expf(-x));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

namespace simt {

constexpr int NT = 256;         // threads per block
constexpr int TX = 64;          // threads across the output columns
constexpr int TY = NT / TX;     // threads across the rows
constexpr int MC = 2;           // output columns per thread
constexpr int BN = TX * MC;     // output columns per block
constexpr int BK = 32;          // contraction depth per tile
constexpr int WCH = BN / 16;    // 16-byte weight chunks per tile row

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

template <int MR>
cudaError_t run(const float* x, bool shared, const int8_t* wgq,
                const float* wgs, const int8_t* wuq, const float* wus,
                const int8_t* wdq, const float* wds, float* ff, float* y,
                int E, int C, int Dm, int F, int act, cudaStream_t s) {
  constexpr int BM = TY * MR;
  const dim3 g1(F / BN, (C + BM - 1) / BM, E), g2(Dm / BN, g1.y, E);
  q8_pass<float, float, MR, true><<<g1, NT, 0, s>>>(
      x, shared ? 0LL : (long long)C * Dm, wgq, wuq, wgs, wus, ff, C, Dm, F,
      act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q8_pass<float, float, MR, false><<<g2, NT, 0, s>>>(
      ff, (long long)C * F, wdq, nullptr, wds, nullptr, y, C, F, Dm, act);
  return cudaGetLastError();
}

}  // namespace simt

namespace tc {

constexpr int NTH = 256;            // two warpgroups
constexpr int BK = 64;              // depth per stage
constexpr int SMEM_CAP = 232448 - 1024;  // 227 KB less alignment slack
constexpr int SMEM_HALF = 114688;        // two blocks on an SM's 228 KB
constexpr int FF_TERMS = 3;         // bf16 terms of ff (see the note above)

// One pass's shapes: BN tokens per block, NTB bf16 terms of the B operand
// (x: 1; ff: the term count), DUAL for pass 1's two weight matrices.
// A block owns BM weight columns: 128, 64 a warpgroup, each warpgroup
// running every matrix on its columns; or, SPLIT (pass 1 at 128-token
// tiles), 64, warpgroup 0 running Wg and warpgroup 1 Wu on all of them,
// so each holds one matrix's sums and partials (at 128 tokens, two
// matrices' would take 256 registers).
template <int BN, int NTB, bool DUAL, bool SPLIT>
struct Cfg {
  static constexpr int NMAT = DUAL ? 2 : 1;   // matrices a block streams
  static constexpr int NMW = SPLIT ? 1 : NMAT;  // matrices a warpgroup runs
  static constexpr int BM = SPLIT ? 64 : 128;
  static constexpr int WT = BK * BM;          // bytes of one int8 tile
  // Widened tiles: double-buffered, so tile k + 1 is widened while tile
  // k's products run; at decode-sized C tiles (<= 16 tokens) those
  // products are a few hundred cycles and one buffer frees the room for
  // a second block on the SM.
  static constexpr int NWB = BN <= 16 ? 1 : 2;
  static constexpr int WBUF = NWB * NMAT * 2 * WT;
  static constexpr int STAGE = NMAT * WT + NTB * BN * BK * 2;
  // Two blocks an SM where each still gets four stages (Mixtral decode:
  // both passes), else one block with all the stages 227 KB hold; at
  // most 8.
  static constexpr int FIT2 = (SMEM_HALF - WBUF) / STAGE;
  static constexpr int FIT = FIT2 >= 4 ? FIT2 : (SMEM_CAP - WBUF) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int TP = BM + 4;  // epilogue tile row, f32 (bank skew)
  static constexpr size_t SMEM = (size_t)WBUF + STAGES * STAGE + 1024;
  static_assert(!SPLIT || DUAL, "only pass 1 splits its matrices");
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(STAGES * STAGE >= (SPLIT ? 2 : 1) * BN * TP * 4,
                "epilogue tile fits the ring");
};

struct Pass {
  const __nv_bfloat16* b;  // B rows: x [*, C, K] or ff terms [NTB, E, C, K]
  long long b_es, b_ts;    // B's expert stride (0 = shared rows), term stride
  const int8_t* w1;        // [E, K, M]: wg (pass 1) or wd (pass 2)
  const int8_t* w2;        // wu (pass 1)
  const float* s1;         // [E, 1, M]
  const float* s2;
  __nv_bfloat16* out;      // ff terms [nt_out, E, C, M] or y [E, C, M]
  long long out_ts;        // term stride of out
  int nt_out, C, K, M, act;
};

// out^T tile [BM columns of M, BN tokens] of one expert: the int8 weight
// tiles are wgmma's A (MN-major, widened), the B rows its K-major B.
template <int BN, int NTB, bool DUAL, bool SPLIT>
__global__ void __launch_bounds__(NTH, 1) q8_pass_tc(const Pass a) {
  using G = Cfg<BN, NTB, DUAL, SPLIT>;
  constexpr int NMAT = G::NMAT, NMW = G::NMW, BM = G::BM, WT = G::WT;
  constexpr int S = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = ts_smem_addr(smem_raw);
  const uint32_t wbuf = (raw + 1023) & ~1023u;  // [NWB][NMAT] widened tiles
  const uint32_t ring = wbuf + G::WBUF;         // [S] int8 tiles + B tiles
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, c = threadIdx.x % 4;
  const int KT = a.K / BK;
  const size_t wbase = (size_t)e * a.K * a.M + m0;
  const __nv_bfloat16* be = a.b + e * a.b_es;

  auto load = [&](int kt) {
    const uint32_t st = ring + (kt % S) * G::STAGE;
    const int k0 = kt * BK;
    constexpr int U = BM / 16;  // 16-byte units of an int8 tile row
#pragma unroll
    for (int n = 0; n < NMAT * BK * U / NTH; ++n) {
      const int i = threadIdx.x + n * NTH;
      const int mat = i / (BK * U), r = (i / U) % BK, u = i % U;
      const int8_t* w = mat ? a.w2 : a.w1;
      ts_cp_async16(st + mat * WT + r * BM + u * 16,
                    w + wbase + (size_t)(k0 + r) * a.M + u * 16, true);
    }
    for (int i = threadIdx.x; i < NTB * BN * 8; i += NTH) {
      const int t = i / (BN * 8), r = (i / 8) % BN, u = i % 8;
      const bool ok = n0 + r < a.C;
      const __nv_bfloat16* src =
          ok ? be + t * a.b_ts + (size_t)(n0 + r) * a.K + k0 + u * 8 : a.b;
      ts_cp_async16(st + NMAT * WT + t * (BN * 128) + r * 128 +
                        ((u ^ (r % 8)) << 4),
                    src, ok);
    }
  };
  auto widen = [&](int kt) {  // int8 tile kt -> its widened buffer
    const uint32_t st = ring + (kt % S) * G::STAGE;
    const uint32_t wb = wbuf + (kt % G::NWB) * NMAT * 2 * WT;
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat)
      ts_widen_i8<BM, BK, NTH>(wb + mat * 2 * WT, st + mat * WT);
  };

  // acc: the f32 sum over the stages; each stage's products (part) are
  // added with rounded f32 adds (the note at the top says why).
  float acc[NMW][BN / 2], part[NMW][NTB * BN / 2];
#pragma unroll
  for (int mw = 0; mw < NMW; ++mw) ts_zero(acc[mw]);
#pragma unroll
  for (int kt = 0; kt < S - 1; ++kt) {
    if (kt < KT) load(kt);
    ts_cp_commit();
  }
  ts_cp_wait<S - 2>();  // tile 0 has landed
  __syncthreads();
  widen(0);
  ts_fence_async_smem();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    // Tile kt's products, from its widened buffer and its B tiles.
    const uint32_t st = ring + (kt % S) * G::STAGE;
    const uint32_t wb = wbuf + (kt % G::NWB) * NMAT * 2 * WT;
    ts_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // The NTB term tiles lie one after another: one product of N =
      // NTB * BN, term t in columns [t BN, (t + 1) BN).
      const uint64_t db = ts_desc_k<NTB * BN>(st + NMAT * WT, 0, kk);
#pragma unroll
      for (int mw = 0; mw < NMW; ++mw) {
        const int mat = SPLIT ? wg : mw;
        ts_wgmma_ss_mn<NTB * BN>(
            part[mw],
            ts_desc_mn<BK>(wb + mat * 2 * WT, kk, SPLIT ? 0 : 64 * wg), db,
            kk > 0);
      }
    }
    ts_wgmma_commit();
    // While they run: tile kt + S - 1 into the slot of tile kt - 1 (its
    // products and its widening are done), then tile kt + 1 widened into
    // the other buffer (tile kt - 1's products read it last); with one
    // buffer, once tile kt's products are done in both warpgroups.
    if (kt + S - 1 < KT) load(kt + S - 1);
    ts_cp_commit();
    ts_cp_wait<S - 2>();  // tile kt + 1 has landed
    if constexpr (G::NWB == 1) ts_wgmma_wait<0>();
    __syncthreads();
    if (kt + 1 < KT) widen(kt + 1);
    ts_fence_async_smem();
    ts_wgmma_wait<0>();
#pragma unroll
    for (int mw = 0; mw < NMW; ++mw) {
      ts_reg_fence(part[mw]);
#pragma unroll
      for (int x = 0; x < BN / 2; ++x) {
        float v = part[mw][x];
#pragma unroll
        for (int t = 1; t < NTB; ++t) v += part[mw][t * BN / 2 + x];
        acc[mw][x] += v;
      }
    }
    __syncthreads();  // tile kt + 1 widened; tile kt's products done
  }
  ts_cp_wait<0>();
  __syncthreads();  // the ring is free: the epilogue stages its tile there

  // Scales (and, unsplit, pass 1's activation) in f32 on the accumulator:
  // element 4 j + 2 i + ee is weight column m0 + mr, token n0 + 8 j + 2 c
  // + ee. SPLIT: each warpgroup stages its matrix's scaled sums apart.
  float* tile = reinterpret_cast<float*>(smem_raw + (ring - raw));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mr = (SPLIT ? 0 : 64 * wg) + 16 * warp + g + 8 * i;
    const size_t m = (size_t)e * a.M + m0 + mr;
    const float sa = SPLIT && wg ? a.s2[m] : a.s1[m];
    const float sb = DUAL && !SPLIT ? a.s2[m] : 0.f;
    float* t0 = tile + (SPLIT ? wg * BN * G::TP : 0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int ee = 0; ee < 2; ++ee) {
        const int x = 4 * j + 2 * i + ee;
        float v = acc[0][x] * sa;
        if constexpr (DUAL && !SPLIT)
          v = apply_act(a.act, v) * (acc[NMW - 1][x] * sb);
        t0[(8 * j + 2 * c + ee) * G::TP + mr] = v;
      }
  }
  __syncthreads();
  // Token rows of BM values, 8 (one 16-byte bf16 store per term) a step.
  for (int idx = threadIdx.x; idx < BN * (BM / 8); idx += NTH) {
    const int n = idx / (BM / 8), m8 = (idx % (BM / 8)) * 8;
    if (n0 + n >= a.C) continue;
    float v[8];
    const float* row = tile + n * G::TP + m8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = row[k];
      if constexpr (SPLIT)  // act(g * sg) * (u * su)
        v[k] = apply_act(a.act, v[k]) * row[BN * G::TP + k];
    }
    __nv_bfloat16* dst =
        a.out + ((size_t)e * a.C + n0 + n) * a.M + m0 + m8;
    for (int t = 0; t < a.nt_out; ++t) {  // pass 2: one term, y itself
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        w[k] = ts_bf16x2_bits(h);
        const float2 hf = __bfloat1622float2(h);
        v[2 * k] -= hf.x;
        v[2 * k + 1] -= hf.y;
      }
      *reinterpret_cast<uint4*>(dst + t * a.out_ts) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int BN, int NTB, bool DUAL, bool SPLIT = false>
cudaError_t launch(const Pass& a, int E, cudaStream_t s) {
  using G = Cfg<BN, NTB, DUAL, SPLIT>;
  auto kern = q8_pass_tc<BN, NTB, DUAL, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.C + BN - 1) / BN, a.M / G::BM, E);
  kern<<<grid, NTH, G::SMEM, s>>>(a);
  return cudaGetLastError();
}

// The C tile: the smallest of 8, 16, 32, 64 that holds C; past 64, pass 1
// takes 128-token tiles split by matrix, pass 2 64 (at 128, its sum and
// three terms' partials would take 256 registers).
template <int NTB, bool DUAL>
cudaError_t by_tile(const Pass& a, int E, cudaStream_t s) {
  if (a.C <= 8) return launch<8, NTB, DUAL>(a, E, s);
  if (a.C <= 16) return launch<16, NTB, DUAL>(a, E, s);
  if (a.C <= 32) return launch<32, NTB, DUAL>(a, E, s);
  if constexpr (DUAL)
    if (a.C > 64) return launch<128, NTB, DUAL, true>(a, E, s);
  return launch<64, NTB, DUAL>(a, E, s);
}

cudaError_t run(const __nv_bfloat16* x, bool shared, const int8_t* wgq,
                const float* wgs, const int8_t* wuq, const float* wus,
                const int8_t* wdq, const float* wds, __nv_bfloat16* ff,
                __nv_bfloat16* y, int E, int C, int Dm, int F, int act,
                cudaStream_t s) {
  const long long ecf = (long long)E * C * F;
  const Pass p1{x, shared ? 0LL : (long long)C * Dm, 0, wgq, wuq, wgs, wus,
                ff, ecf, FF_TERMS, C, Dm, F, act};
  cudaError_t err = by_tile<1, true>(p1, E, s);
  if (err != cudaSuccess) return err;
  const Pass p2{ff, (long long)C * F, ecf, wdq, nullptr, wds, nullptr, y, 0,
                1, C, F, Dm, act};
  return by_tile<FF_TERMS, false>(p2, E, s);
}

}  // namespace tc

}  // namespace

// C entry point (loaded with ctypes by ops/q8_expert.py). x: [C,Dm] when
// shared != 0, else [E,C,Dm]; dtype: x and y type, 0 = f32, 1 = bf16;
// act: 0 = silu, 1 = tanh-gelu; ff: scratch the caller allocates, f32
// [E,C,F] for f32 x, bf16 [3,E,C,F] (ff's three bf16 terms) for bf16 x.
// Dm and F must be multiples of 128.
// Returns the cudaError_t of the launches.
extern "C" int ts_q8_expert_ffn(const void* x, const void* wgq,
                                const void* wgs, const void* wuq,
                                const void* wus, const void* wdq,
                                const void* wds, void* ff, void* y, int E,
                                int C, int Dm, int F, int shared, int dtype,
                                int act, void* stream) {
  if (E <= 0 || C <= 0 || Dm <= 0 || F <= 0 || Dm % 128 || F % 128 ||
      E > 65535 || Dm / 128 > 65535 || F / 128 > 65535 ||
      (act != ACT_SILU && act != ACT_GELU))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* gq = static_cast<const int8_t*>(wgq);
  auto* uq = static_cast<const int8_t*>(wuq);
  auto* dq = static_cast<const int8_t*>(wdq);
  auto* gs = static_cast<const float*>(wgs);
  auto* us = static_cast<const float*>(wus);
  auto* ds = static_cast<const float*>(wds);
  if (dtype == TS_F32) {
    auto* xf = static_cast<const float*>(x);
    auto* f = static_cast<float*>(ff);
    auto* yf = static_cast<float*>(y);
    if (C <= 16)  // decode ticks: 8-row tiles waste no FMAs on padding
      return (int)simt::run<2>(xf, shared != 0, gq, gs, uq, us, dq, ds, f,
                               yf, E, C, Dm, F, act, s);
    return (int)simt::run<8>(xf, shared != 0, gq, gs, uq, us, dq, ds, f, yf,
                             E, C, Dm, F, act, s);
  }
  if (dtype != TS_BF16) return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* f = static_cast<__nv_bfloat16*>(ff);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  return (int)tc::run(xb, shared != 0, gq, gs, uq, us, dq, ds, f, yb, E, C,
                      Dm, F, act, s);
}
