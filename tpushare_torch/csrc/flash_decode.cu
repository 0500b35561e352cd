// Kernel 5 of the port: one ragged decode step (S = 1) of attention over
// a contiguous KV cache, on Hopper.
//
// Replaces tpushare/ops/flash_attention.py _decode_kernel behind
// flash_decode(): q [B,1,H,D]; k/v [B,M,Hkv,D] (one layer's dense rows)
// of q's type, f32 or bf16; pos [B] int32; D in {128,256}. Row b attends
// cache positions max(0, pos[b] - window + 1) .. pos[b] (window <= 0:
// from 0), the token just written at pos[b] included. The tanh softcap
// comes before the mask, softmax is online in f32 and the output is in
// q's type, as in the Pallas body.
//
// Bound: bytes: the live K/V of the step (each live row read once per
// kv head) and 1-4 FMAs per byte (Gemma-2-2B: 2 query heads per kv
// head). The design is decode_tile.cuh's split-KV walk on contiguous
// rows (a row is a table of consecutive pages): a (split, kv head,
// slot) grid sized by the host to cover the SMs about twice (Gemma-2-2B,
// 8 slots x 4 kv heads: 32 x 9 blocks where the unsplit walk had 32),
// each split streaming its piece of the live range through a ring of
// three 32 KB cp.async stages of bf16 K/V, and a small merge kernel
// combining the splits in a fixed order. Positions past pos[b] and below the
// window floor are never read.

#include "decode_tile.cuh"

// C entry point (loaded with ctypes by ops/flash_attention.py). dtype:
// q, k, v and output type, 0 = f32, 1 = bf16. softcap <= 0 means none;
// window <= 0 means global. splits: S >= 1 (ops/flash_attention.py
// decode_splits); scratch: B*H*S*(D+2) f32 when S > 1, else unused.
// Returns the cudaError_t of the launches.
extern "C" int ts_flash_decode(const void* q, const void* k, const void* v,
                               const void* pos, void* o, int B, int M, int H,
                               int Hkv, int D, int dtype, int window,
                               float scale, float softcap, int splits,
                               void* scratch, void* stream) {
  if (B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode_tile::RowAddr addr{M};
  const int* ps = static_cast<const int*>(pos);
  float* sc = static_cast<float*>(scratch);
  if (dtype == TS_F32)
    return (int)decode_tile::dispatch_d<float, float>(
        D, q, k, v, nullptr, nullptr, addr, ps, o, sc, B, H, Hkv, splits,
        window, scale, softcap, s);
  if (dtype == TS_BF16)
    return (int)decode_tile::dispatch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k, v, nullptr, nullptr, addr, ps, o, sc, B, H, Hkv, splits,
        window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
