// Kernel 2 of the port: one decode step (S = 1) of attention read
// straight off the block-table-paged KV pool, on Hopper.
//
// Replaces tpushare/ops/flash_attention.py _paged_decode_kernel behind
// paged_flash_decode(), for f32/bf16 pages and (quantized=True there)
// int8 pages. q [B,1,H,D]; pool_k/pool_v [nb,bs,Hkv,D] (one layer's
// pool) of q's type or int8; int8 pools add k_scale/v_scale f32
// [nb,Hkv,bs] (the port's scale page layout: one (page, head) is bs
// contiguous floats); table [B,mb] int32 pool block ids (-1 =
// unallocated); pos [B] int32; D in {128,256}. Int8 rows are widened to
// f32 in registers, the k scale multiplies each score and the v scale
// each probability; all arithmetic stays f32, as in the Pallas body.
// Slot b's query attends pool positions t <= pos[b] (and t > pos[b] -
// window when window > 0) through table[b, t / bs]. Entries of -1 are
// never dereferenced: their rows are masked and never copied. Positions
// outside the slot's live range (_kv_live_range: [lo, hi) pages from
// the window floor to pos[b]) are never read. Online softmax in f32,
// optional tanh softcap; a slot with no live row (inactive, all -1)
// yields 0.
//
// Bound: decode moves every live K/V byte once and does 1-4 FMAs per
// byte (the GQA group: Gemma-2B 8 heads per kv head, Llama-3-8B 4), far
// below the card's ~295 operations per byte, so the bound is bytes
// (int8 pages: half of bf16's, plus 4 bytes of scale per row and head).
// The design is decode_tile.cuh's split-KV walk through the block table:
// a (split, kv head, slot) grid sized by the host to cover the SMs about
// twice (Gemma-2B's one kv head and 8 slots: 8 x 33 blocks where the
// unsplit walk had 8), each split's pool rows looked up from the table
// ahead of its 16-byte cp.async copies, K/V kept in shared memory as
// stored (bf16 or int8) in a ring of 3-4 stages, scores split over the
// lanes of a warp with q in registers, and a small merge kernel
// combining the splits in a fixed order.

#include "decode_tile.cuh"

namespace {

using decode_tile::PagedAddr;

template <typename T>
cudaError_t dispatch_page(int page, int D, const void* q, const void* pk,
                          const void* pv, const float* ks, const float* vs,
                          PagedAddr addr, const int* pos, void* o,
                          float* scratch, int B, int H, int Hkv, int S,
                          int window, float scale, float softcap,
                          cudaStream_t s) {
  if (page == TS_I8) {
    if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
    return decode_tile::dispatch_d<T, int8_t>(D, q, pk, pv, ks, vs, addr,
                                              pos, o, scratch, B, H, Hkv, S,
                                              window, scale, softcap, s);
  }
  return decode_tile::dispatch_d<T, T>(D, q, pk, pv, ks, vs, addr, pos, o,
                                       scratch, B, H, Hkv, S, window, scale,
                                       softcap, s);
}

}  // namespace

// C entry point (loaded with ctypes by ops/flash_attention.py; the
// signature of ts_paged_verify plus splits and scratch). dtype: q/output
// type, 0 = f32, 1 = bf16; page: the pools' type, equal to dtype or 2 =
// int8 (then k_scale and v_scale are [nb,Hkv,bs] f32). Sq must be 1.
// softcap <= 0 means none; window <= 0 means global. splits: S >= 1
// (ops/flash_attention.py decode_splits); scratch: B*H*S*(D+2) f32 when
// S > 1, else unused. Launches the split kernel, then (S > 1) the merge
// kernel, on stream; returns the cudaError_t of the launches.
extern "C" int ts_paged_decode(const void* q, const void* pool_k,
                               const void* pool_v, const void* k_scale,
                               const void* v_scale, const void* table,
                               const void* pos, void* o, int B, int Sq,
                               int H, int Hkv, int D, int bs, int mb,
                               int dtype, int page, int window, float scale,
                               float softcap, int splits, void* scratch,
                               void* stream) {
  if (B <= 0 || Sq != 1 || H <= 0 || Hkv <= 0 || H % Hkv || bs <= 0 ||
      mb <= 0 || (page != dtype && page != TS_I8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* sc = static_cast<float*>(scratch);
  const PagedAddr addr{static_cast<const int*>(table), bs, mb};
  const int* ps = static_cast<const int*>(pos);
  if (dtype == TS_F32)
    return (int)dispatch_page<float>(page, D, q, pool_k, pool_v, ks, vs,
                                     addr, ps, o, sc, B, H, Hkv, splits,
                                     window, scale, softcap, s);
  if (dtype == TS_BF16)
    return (int)dispatch_page<__nv_bfloat16>(page, D, q, pool_k, pool_v, ks,
                                             vs, addr, ps, o, sc, B, H, Hkv,
                                             splits, window, scale, softcap,
                                             s);
  return (int)cudaErrorInvalidValue;
}
