// Kernel 2 of the port: one decode step (S = 1) of attention read
// straight off the block-table-paged KV pool, on Hopper.
//
// Replaces tpushare/ops/flash_attention.py _paged_decode_kernel behind
// paged_flash_decode(), for f32/bf16 pages and (quantized=True there)
// int8 pages. q [B,1,H,D]; pool_k/pool_v [nb,bs,Hkv,D] (one layer's
// pool) of q's type or int8; int8 pools add k_scale/v_scale f32
// [nb,Hkv,bs] (the port's scale page layout: one (page, head) is bs
// contiguous floats); table [B,mb] int32 pool block ids (-1 =
// unallocated); pos [B] int32; D in {128,256}. Each loaded int8 K/V
// row is multiplied by its f32 scale right after the load and all
// arithmetic stays f32, as in the Pallas body. Slot b's query attends
// pool positions t <= pos[b] (and t > pos[b] - window when window > 0)
// through table[b, t / bs]. Entries of -1 are never dereferenced: they
// are clamped out and their rows masked. Pages outside the slot's live
// range (_kv_live_range: [lo, hi) pages from the window floor to
// pos[b]) are never read. Online softmax in f32, optional tanh softcap;
// a slot with no live row (inactive, all -1) yields 0.
//
// Bound: decode moves every live K/V byte once and does ~4 FLOPs per
// element, so the bound is bytes (int8 pages: half of bf16's, plus 4
// bytes of scale per row and head). The design reads each live row once
// per (slot, kv head): the walk of decode_tile.cuh (one block per (kv
// head, slot), 64 rows per tile, the GQA group sharing every loaded
// row) through the block table. At Gemma-2B's shape (Hkv = 1, 8 slots)
// that is 8 blocks on 132 SMs, far from the memory rate: splitting the
// KV walk across blocks (split-KV) is the follow-up.

#include "decode_tile.cuh"

namespace {

using decode_tile::PagedAddr;

template <typename T>
cudaError_t dispatch_page(int page, int D, const void* q, const void* pk,
                          const void* pv, const float* ks, const float* vs,
                          PagedAddr addr, const int* pos, void* o, int B,
                          int H, int Hkv, int window, float scale,
                          float softcap, cudaStream_t s) {
  if (page == TS_I8) {
    if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
    return decode_tile::dispatch_d<T, int8_t>(D, q, pk, pv, ks, vs, addr,
                                              pos, o, B, H, Hkv, window,
                                              scale, softcap, s);
  }
  return decode_tile::dispatch_d<T, T>(D, q, pk, pv, ks, vs, addr, pos, o,
                                       B, H, Hkv, window, scale, softcap, s);
}

}  // namespace

// C entry point (loaded with ctypes by ops/flash_attention.py; the same
// signature as ts_paged_verify). dtype: q/output type, 0 = f32, 1 = bf16;
// page: the pools' type, equal to dtype or 2 = int8 (then k_scale and
// v_scale are [nb,Hkv,bs] f32). Sq must be 1. softcap <= 0 means none;
// window <= 0 means global. Returns the cudaError_t of the launch.
extern "C" int ts_paged_decode(const void* q, const void* pool_k,
                               const void* pool_v, const void* k_scale,
                               const void* v_scale, const void* table,
                               const void* pos, void* o, int B, int Sq,
                               int H, int Hkv, int D, int bs, int mb,
                               int dtype, int page, int window, float scale,
                               float softcap, void* stream) {
  if (B <= 0 || Sq != 1 || H <= 0 || Hkv <= 0 || H % Hkv || bs <= 0 ||
      mb <= 0 || (page != dtype && page != TS_I8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const PagedAddr addr{static_cast<const int*>(table), bs, mb};
  const int* ps = static_cast<const int*>(pos);
  if (dtype == TS_F32)
    return (int)dispatch_page<float>(page, D, q, pool_k, pool_v, ks, vs,
                                     addr, ps, o, B, H, Hkv, window, scale,
                                     softcap, s);
  if (dtype == TS_BF16)
    return (int)dispatch_page<__nv_bfloat16>(page, D, q, pool_k, pool_v, ks,
                                             vs, addr, ps, o, B, H, Hkv,
                                             window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
