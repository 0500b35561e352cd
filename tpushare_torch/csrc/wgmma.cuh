// Hopper tensor-core helpers for the port's bf16 kernels (flash_prefill.cu,
// flash_bwd.cu, paged_verify.cu, q8_expert.cu): cp.async loads into
// 128-byte-swizzled shared-memory tiles, the exact widening of int8 tiles
// into them, wgmma descriptors over those tiles, the wgmma forms the
// kernels use, and the split of an f32 operand into bf16 terms.
//
// Swizzled tile. R rows x D bf16 columns (D a multiple of 64) are stored
// as D/64 column chunks of R rows x 128 bytes; chunk c starts at byte
// c * R * 128, row r of a chunk at r * 128, and the 16-byte unit u
// (columns 8u..8u+7 of the chunk) of row r sits at unit u ^ (r % 8). That
// is the layout TMA's SWIZZLE_128B writes and a 128B-swizzle wgmma
// descriptor reads; the tile's base must be 1024-byte aligned, R a
// multiple of 8.
//
// A tile serves as a wgmma operand either way round:
//   K-major (ts_desc_k): rows are the product's M or N index, columns its
//     depth (K) — q, k, v and dout as the left or right factor of q.k^T,
//     dout.v^T;
//   MN-major (ts_desc_mn): rows are the depth, columns N — v in p.v, k in
//     ds.k, dout and q in p^T.dout and ds^T.q (the "transposed" B), and
//     the int8 expert weights [depth][columns] as the A of q8_expert.cu.
//
// Accumulator layout of wgmma m64nNk16 (f32), thread t of the warpgroup,
// warp w = t / 32, g = (t % 32) / 4, c = t % 4: d[4j + 2i + e] is row
// 16 w + g + 8 i, column 8 j + 2 c + e. The A operand from registers uses
// the same rows and, for depth step kk, the columns 16 kk .. 16 kk + 15,
// so the accumulator of one product is the register A operand of the
// next: A step kk = pack(d[8 kk .. 8 kk + 7]) in pairs (ts_frag_split).
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t ts_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src must
// still be a mapped address).
__device__ __forceinline__ void ts_cp_async16(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero when !valid.
__device__ __forceinline__ void ts_cp_async4(uint32_t dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ts_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void ts_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy shared-memory writes (cp.async's)
// visible to the async proxy that wgmma reads through; then a barrier.
__device__ __forceinline__ void ts_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [s0, s0 + R) of head hx of a contiguous [B, S, Hx, D] bf16 tensor
// into the swizzled tile at shared address dst; rows past S are zero.
// All NTH threads of the block share the copy (16 bytes each per step).
template <int D, int R, int NTH>
__device__ __forceinline__ void ts_tile_async(uint32_t dst,
                                              const __nv_bfloat16* src, int b,
                                              int s0, int S, int Hx, int hx) {
  constexpr int U = D / 8;  // 16-byte units per row
  static_assert((R * U) % NTH == 0, "tile copy must split evenly");
#pragma unroll
  for (int n = 0; n < R * U / NTH; ++n) {
    const int i = threadIdx.x + n * NTH;
    const int r = i / U, cu = i % U, s = s0 + r;
    const bool ok = s < S;
    const __nv_bfloat16* g =
        ok ? src + (((size_t)b * S + s) * Hx + hx) * D + cu * 8 : src;
    ts_cp_async16(dst + (cu / 8) * (R * 128) + r * 128 +
                      (((cu % 8) ^ (r % 8)) << 4),
                  g, ok);
  }
}

// R consecutive f32 of a row vector (entries [s0, s0 + R) of src, S long)
// into shared memory at dst; entries past S are zero.
template <int R, int NTH>
__device__ __forceinline__ void ts_vec_async(uint32_t dst, const float* src,
                                             int s0, int S) {
  for (int i = threadIdx.x; i < R; i += NTH) {
    const bool ok = s0 + i < S;
    ts_cp_async4(dst + 4 * i, ok ? src + s0 + i : src, ok);
  }
}

// 16 bytes of shared memory at a shared address, as four words.
__device__ __forceinline__ uint4 ts_lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void ts_sts128(uint32_t a, uint32_t x, uint32_t y,
                                          uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(x),
               "r"(y), "r"(z), "r"(w)
               : "memory");
}

// Four int8 (one word) as four bf16 (two bf16x2 words), exactly: byte
// x + 128 becomes the low mantissa bits of 2^23 (0x4B0000uu), and
// subtracting 2^23 + 128 leaves x in f32, whose top 16 bits are x's
// bf16 (an integer of 8 bits needs no rounding). Full-rate integer and
// f32 adds; no I2F.
__device__ __forceinline__ void ts_i8x4_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// An int8 tile of R rows x COLS columns (COLS a multiple of 64), row-major
// in shared memory at src, widened into the swizzled bf16 tile at dst
// (the layout above: column chunk c of 64 at c * R * 128). NTH threads
// share it, 16 int8 (two 16-byte bf16 units) each per step. Int8 ->
// bf16 is exact, so a product of the widened tile is the int8 product.
template <int COLS, int R, int NTH>
__device__ __forceinline__ void ts_widen_i8(uint32_t dst, uint32_t src) {
  constexpr int U = COLS / 16;  // 16-byte int8 units per row
  static_assert((R * U) % NTH == 0, "widening must split evenly");
#pragma unroll
  for (int n = 0; n < R * U / NTH; ++n) {
    const int i = threadIdx.x + n * NTH;
    const int r = i / U, u = i % U, cu = 2 * u;  // cu: first bf16 unit
    const uint4 w = ts_lds128(src + r * COLS + u * 16);
    uint32_t b[8];
    ts_i8x4_bf16(w.x, b[0], b[1]);
    ts_i8x4_bf16(w.y, b[2], b[3]);
    ts_i8x4_bf16(w.z, b[4], b[5]);
    ts_i8x4_bf16(w.w, b[6], b[7]);
    const uint32_t row = dst + (cu / 8) * (R * 128) + r * 128;
    ts_sts128(row + (((cu % 8) ^ (r % 8)) << 4), b[0], b[1], b[2], b[3]);
    ts_sts128(row + ((((cu + 1) % 8) ^ (r % 8)) << 4), b[4], b[5], b[6],
              b[7]);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t ts_desc(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows [r0, r0 + 64 or N) of a swizzled tile of R rows,
// depth step kk (columns 16 kk .. 16 kk + 15). 8-row groups lie 1024
// bytes apart; a step inside a 128-byte row moves the start address.
template <int R>
__device__ __forceinline__ uint64_t ts_desc_k(uint32_t tile, int r0, int kk) {
  return ts_desc(tile + (kk / 4) * (R * 128) + r0 * 128 + (kk % 4) * 32, 16,
                 1024);
}

// MN-major operand: depth step kk (rows 16 kk .. 16 kk + 15) of a swizzled
// tile of R rows, columns from n0 (a multiple of 64). The leading offset
// steps N across 64-column chunks (R * 128 bytes), the stride offset steps
// the depth across 8-row groups (1024 bytes).
template <int R>
__device__ __forceinline__ uint64_t ts_desc_mn(uint32_t tile, int kk, int n0) {
  return ts_desc(tile + (n0 / 64) * (R * 128) + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ void ts_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ts_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void ts_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers after a wait, so no read of them is
// scheduled before the asynchronous product has landed.
template <int N>
__device__ __forceinline__ void ts_reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void ts_zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d[64 x N] += A[64 x 16] . B[N x 16]^T: A and B K-major in shared memory
// (bf16 in, f32 accumulate). N = 32 or 64.
template <int N>
__device__ __forceinline__ void ts_wgmma_ss(float (&d)[N / 2], uint64_t da,
                                            uint64_t db);

template <>
__device__ __forceinline__ void ts_wgmma_ss<32>(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss<64>(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x N] = A[64 x 16] . B[N x 16]^T (+ d when acc != 0) with A MN-major
// in shared memory (ts_desc_mn: rows of the tile are the depth, its 64
// columns the M rows of d) and B K-major (ts_desc_k). N = 8 .. 192. The
// int8 expert FFN's form: the widened weight tile is A as it lies,
// [depth][columns].
template <int N>
__device__ __forceinline__ void ts_wgmma_ss_mn(float (&d)[N / 2], uint64_t da,
                                               uint64_t db, int acc);

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<8>(
    float (&d)[4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<16>(
    float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<24>(
    float (&d)[12], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<32>(
    float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<48>(
    float (&d)[24], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<64>(
    float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<96>(
    float (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<128>(
    float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void ts_wgmma_ss_mn<192>(
    float (&d)[96], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95}, %96, %97, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(acc));
}


// d[64 x 128] += A[64 x 16] . B[16 x 128]: A from registers (four bf16
// pairs, the layout above), B MN-major in shared memory (acc == 0: d = the
// product).
__device__ __forceinline__ void ts_wgmma_rs128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The split. An operand the kernel computed in f32 (p, ds) enters a bf16
// product as NT bf16 terms, x = t0 + t1 (+ t2), t0 = bf16(x), t1 =
// bf16(x - t0), ...: each remainder is exact in f32, so two terms carry
// ~16 significant bits where one rounding keeps 8, and three carry all
// 24. One rounding misses the plain versions' gates by 5-44x. The
// gradient's f32 outputs meet every gate with two; the forward takes
// three (flash_prefill.cu says why; PERF.md §6;
// tests/test_torch_flash_numerics.py).
__device__ __forceinline__ uint32_t ts_bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand of depth step kk (columns 16 kk .. 16 kk + 15) of an m64nN f32
// accumulator, as NT bf16 terms.
template <int NT, int N>
__device__ __forceinline__ void ts_frag_split(const float (&d)[N], int kk,
                                              uint32_t (&f)[NT][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x0 = d[8 * kk + 2 * i], x1 = d[8 * kk + 2 * i + 1];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      f[t][i] = ts_bf16x2_bits(h);
      const float2 hf = __bfloat1622float2(h);
      x0 -= hf.x;
      x1 -= hf.y;
    }
  }
}

// acc[hh] += d . B(kk, hh) over depth steps kk < KS and column halves hh <
// NH (128 columns each): d an m64nN f32 accumulator split into NT bf16
// terms (the register A operand), desc_b(kk, hh) the B descriptor. The
// fragments are double-buffered: step kk's products are in flight while
// step kk + 1's fragments are formed, and a buffer is rewritten only after
// the products that read it have completed.
template <int NT, int KS, int NH, int N, class DescB>
__device__ __forceinline__ void ts_rs_product(float (&acc)[NH][64],
                                              const float (&d)[N],
                                              DescB desc_b) {
  uint32_t f[2][NT][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ts_frag_split<NT>(d, kk, f[kk % 2]);
    ts_wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const uint64_t db = desc_b(kk, hh);
#pragma unroll
      for (int t = 0; t < NT; ++t) ts_wgmma_rs128(acc[hh], f[kk % 2][t], db);
    }
    ts_wgmma_commit();
    ts_wgmma_wait<1>();
  }
  ts_wgmma_wait<0>();
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) ts_reg_fence(acc[hh]);
}
