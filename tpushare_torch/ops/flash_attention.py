"""Attention kernels of the port: wrappers around the hand-written Hopper
kernels in ``csrc/``, each with its plain PyTorch version beside it.
Counterpart of ``tpushare/ops/flash_attention.py``.

- ``flash_attention`` -> ``csrc/flash_prefill.cu`` (replaces the Pallas
  ``_fa_kernel`` and ``_fa_stream_kernel``); plain version:
  ``mha_reference``. Differentiable through ``FlashAttentionFn``.
- ``flash_attention_partial`` -> the partial mode of
  ``csrc/flash_prefill.cu`` (replaces ``_fa_kernel`` with
  ``partial=True``: one KV chunk's unnormalized accumulator and softmax
  stats, for ring attention); plain version:
  ``flash_attention_partial_plain``.
- ``flash_attention_bwd`` -> ``csrc/flash_bwd.cu``: the attention
  gradient (the JAX package has none; its training differentiates the
  reference paths); plain version: ``flash_attention_bwd_plain``.
- ``paged_flash_decode`` -> ``csrc/paged_decode.cu`` (replaces the
  Pallas ``_paged_decode_kernel``, f32/bf16 and int8 pages); plain
  version: ``paged_flash_decode_plain``.
- ``paged_flash_verify`` -> ``csrc/paged_verify.cu`` (replaces the
  Pallas ``_paged_verify_kernel``, f32/bf16 and int8 pages); plain
  version: ``paged_flash_verify_plain``.
- ``flash_decode`` -> ``csrc/flash_decode.cu`` (replaces the Pallas
  ``_decode_kernel``: ragged S = 1 decode over contiguous KV rows);
  plain version: ``flash_decode_plain``, the masked ``mha_reference``
  of the dense ragged branch.

The two decode kernels share one split-KV walk (``csrc/decode_tile.cuh``):
``decode_splits`` picks how many blocks share each slot's KV walk, the
wrapper allocates the splits' f32 partials with ``torch.empty``, and its
one C call launches the split kernel and, past one split, their merge.

Dispatch rule: a wrapper given CPU tensors runs the plain version; given
CUDA tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream, and raises on anything the kernel does not
take or on a launch error — never a quiet fallback. Each wrapper counts
its kernel launches in ``<wrapper>.launches`` (a plain int; the paged
wrappers count int8-page launches apart, in ``.launches_int8``), so a
run can show that its main path went through each kernel variant.

The TPU package gates these kernels behind TPU measurements (the
``TPUSHARE_DECODE_KERNEL`` opt-in for verify and contiguous decode,
``PAGED_Q8_KERNEL_MIN_CTX`` for int8 pages, the ``M % 128`` tiling rule
of ``decode_eligible``); those are not facts about this card, so on
CUDA the port always launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpushare_torch.ops import _build
from tpushare_torch.ops.attention import NEG_INF, mha_reference, window_keep

KERNEL_HEAD_DIMS = (128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I8 = 2                          # page type code of int8 pages
# The decode walk (csrc/decode_tile.cuh): positions per tile, and query
# heads one block holds (a larger GQA group takes several blocks).
DECODE_TILE_ROWS = 32
DECODE_GROUP = 8
H100_SMS = 132

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib(name: str, fn: str, argtypes):
    lib = _build.load(name)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: kernel needs contiguous tensors")


def _window(window: Optional[int]) -> int:
    if window is None:
        return 0
    if not isinstance(window, int):
        raise TypeError(f"window must be a Python int or None on the "
                        f"kernel path, got {type(window).__name__}")
    return window


def decode_splits(B: int, H: int, Hkv: int, max_rows: int,
                  sms: int = H100_SMS) -> int:
    """How many splits the decode walk cuts each (slot, kv head) into,
    from the shapes alone: enough that the grid of B x Hkv x ceil(g / 8)
    x S blocks covers the card's ``sms`` SMs about twice, at most one
    split per tile of the longest slot a cache can hold (``max_rows``: M
    for rows, mb * bs for a paged pool), and 1 once B x Hkv blocks fill
    the card. The kernel cuts each slot's live range into that many
    tile-aligned pieces on the device (csrc/decode_tile.cuh)."""
    blocks = B * Hkv * -(-(H // Hkv) // DECODE_GROUP)
    if blocks >= sms:
        return 1
    tiles = -(-max_rows // DECODE_TILE_ROWS)
    return max(1, min(-(-2 * sms // blocks), tiles))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_split_args(q: torch.Tensor, Hkv: int, max_rows: int):
    """(S, scratch, its pointer) of one decode launch: the splits' f32
    partials [B, H, S, D] and (m, l) [B, H, S, 2] in one ``torch.empty``
    (held by the caller until the launch is enqueued), none when S = 1."""
    B, _, H, D = q.shape
    S = decode_splits(B, H, Hkv, max_rows, _sm_count(q.device.index or 0))
    if S == 1:
        return S, None, 0
    scratch = torch.empty(B * H * S * (D + 2), dtype=torch.float32,
                          device=q.device)
    return S, scratch, scratch.data_ptr()


def _scale(D: int, scale: Optional[float]) -> float:
    return D ** -0.5 if scale is None else float(scale)


def _cap(attn_softcap: Optional[float]) -> float:
    return 0.0 if attn_softcap is None else float(attn_softcap)


def _chunk_checks(what: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *offsets) -> None:
    """Validate q [B,Sq,H,D] against one KV chunk k, v [B,Sk,Hkv,D] for
    the prefill-shaped kernels (flash, partial, gradient)."""
    _check_cuda(what, q, k, v)
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or H % Hkv:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: kernel takes f32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if not all(isinstance(o, int) for o in offsets):
        raise TypeError(f"{what}: q_offset / k_offset must be Python ints")


def _flash_launch(q, k, v, *, q_offset, scale, window, attn_softcap,
                  with_lse: bool):
    """Launch the flash prefill kernel: (out in q's type, and the f32
    [B, H, Sq] log-sum-exp when ``with_lse``, else None)."""
    _chunk_checks("flash_attention", q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or Sq == 0:
        return out, lse
    fn = _lib("flash_prefill", "ts_flash_prefill",
              [_P] * 5 + [_I] * 9 + [_F, _F, _P])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              0 if lse is None else lse.data_ptr(),
              B, Sq, Sk, H, Hkv, D, _DTYPE_CODE[q.dtype], q_offset,
              _window(window), _scale(D, scale), _cap(attn_softcap),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int = 0,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Causal flash attention; the contract of ``mha_reference`` with
    ``causal=True`` (BSHD).

    q [B, Sq, H, D]; k, v [B, Sk, Hkv, D]; ``q_offset`` (a Python int)
    is the absolute position of q[0]. On CUDA: f32 or bf16, D in
    {128, 256}, any Sq >= 1 and any Sk. On CPU: ``mha_reference``.
    When autograd records (grad mode on, q, k or v requiring grad) the
    call goes through ``FlashAttentionFn``: the same kernel, plus its
    log-sum-exp, and ``flash_attention_bwd`` for the gradient.
    """
    kw = dict(q_offset=q_offset, scale=scale, window=window,
              attn_softcap=attn_softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_offset, scale, window,
                                      attn_softcap)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, **kw)
    return _flash_launch(q, k, v, with_lse=False, **kw)[0]


flash_attention.launches = 0


def softmax_dsum(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dout * out) as f32 [B, H, Sq] from BSHD tensors: the
    ``dsum`` input of the attention gradient."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient. Forward: the prefill kernel
    with its log-sum-exp (on CPU tensors the plain partial pass,
    normalized). Backward: ``flash_attention_bwd`` (its plain version on
    CPU tensors), its f32 gradients cast to the inputs' types."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, scale, window, attn_softcap):
        kw = dict(q_offset=q_offset, scale=scale, window=window,
                  attn_softcap=attn_softcap)
        if q.device.type == "cpu":
            acc, m, l = flash_attention_partial_plain(q, k, v, **kw)
            out = (acc / l.clamp(min=1e-30).transpose(1, 2)[..., None]
                   ).to(q.dtype)
            lse = m + torch.log(l)
        else:
            out, lse = _flash_launch(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse,
                                         softmax_dsum(dout, out), **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def _chunk_scores(q, k, *, q_offset, k_offset, scale, window, attn_softcap):
    """Plain scores of q against one KV chunk, grouped [B, Hkv, G, Sq, Sk]
    f32, with the causal/window keep-mask [Sq, Sk]: the scale multiplies
    q before the dot, then the softcap, as the kernels do. Returns
    (scaled grouped q, raw scores, capped scores, keep)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).float() * _scale(D, scale)
    raw = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = raw if attn_softcap is None else \
        attn_softcap * torch.tanh(raw / attn_softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = k_offset + torch.arange(Sk, device=q.device)[None, :]
    keep = k_pos <= q_pos
    if window is not None:
        keep &= window_keep(q_pos, k_pos, window)
    return qg, raw, s, keep


def flash_attention_partial_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, q_offset: int = 0,
                                  k_offset: int = 0,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  attn_softcap: Optional[float] = None):
    """Plain version of the partial kernel — the contract of the JAX
    ``partial_reference`` (and of ring attention's ``chunk_dense``):
    (acc [B, Sq, H, D] f32 unnormalized, m [B, H, Sq] f32, l [B, H, Sq]
    f32) of q against one KV chunk at absolute positions ``q_offset`` /
    ``k_offset``. Masked logits are NEG_INF and masked p is 0 by the mask,
    so a fully masked row gives m = NEG_INF, l = 0, acc = 0."""
    B, Sq, H, D = q.shape
    _, _, s, keep = _chunk_scores(q, k, q_offset=q_offset, k_offset=k_offset,
                                  scale=scale, window=window,
                                  attn_softcap=attn_softcap)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)                                 # [B, Hkv, G, Sq]
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return (acc.reshape(B, Sq, H, D), m.reshape(B, H, Sq),
            l.reshape(B, H, Sq))


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, q_offset: int = 0,
                            k_offset: int = 0,
                            scale: Optional[float] = None,
                            window: Optional[int] = None,
                            attn_softcap: Optional[float] = None):
    """One KV chunk's flash pass returning the UNNORMALIZED accumulator
    and the softmax stats, for cross-chunk merging (ring attention).

    q [B, Sq, H, D]; k, v [B, Sk, Hkv, D]; ``q_offset`` / ``k_offset``
    (Python ints) are the absolute positions of q[0] and k[0]. Returns
    (acc [B, Sq, H, D] f32, m [B, H, Sq] f32, l [B, H, Sq] f32) with
    softmax(...) @ v == acc / l after merging. On CUDA: f32 or bf16, D in
    {128, 256}, any Sq >= 1 and Sk; the kernel skips key tiles past the
    causal frontier and below the window. On CPU:
    ``flash_attention_partial_plain``. Launches in ``.launches``.
    """
    kw = dict(q_offset=q_offset, k_offset=k_offset, scale=scale,
              window=window, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return flash_attention_partial_plain(q, k, v, **kw)
    _chunk_checks("flash_attention_partial", q, k, v, q_offset, k_offset)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Sq, H, D), **f32)
    m = torch.empty((B, H, Sq), **f32)
    l = torch.empty((B, H, Sq), **f32)
    if B == 0 or Sq == 0:
        return acc, m, l
    fn = _lib("flash_prefill", "ts_flash_partial",
              [_P] * 6 + [_I] * 10 + [_F, _F, _P])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
              m.data_ptr(), l.data_ptr(), B, Sq, Sk, H, Hkv, D,
              _DTYPE_CODE[q.dtype], q_offset, k_offset, _window(window),
              _scale(D, scale), _cap(attn_softcap),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention_partial")
    flash_attention_partial.launches += 1
    return acc, m, l


flash_attention_partial.launches = 0


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              lse: torch.Tensor, dsum: torch.Tensor, *,
                              q_offset: int = 0, k_offset: int = 0,
                              scale: Optional[float] = None,
                              window: Optional[int] = None,
                              attn_softcap: Optional[float] = None):
    """Plain version of the gradient kernel: (dq [B, Sq, H, D], dk, dv
    [B, Sk, Hkv, D]), all f32, of q against one KV chunk, given the
    final per-row ``lse`` = m + log(l) and ``dsum`` = rowsum(dout * out)
    (both f32 [B, H, Sq]). p = exp(s - lse) where the mask keeps, else 0
    (by the mask); ds = p (dout.v - dsum) times the softcap factor
    1 - tanh^2(raw / cap); the scale reaches dq and dk as the forward
    applies it (to q before the dot); dk and dv sum over each GQA
    group."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg, raw, s, keep = _chunk_scores(q, k, q_offset=q_offset,
                                     k_offset=k_offset, scale=scale,
                                     window=window,
                                     attn_softcap=attn_softcap)
    lse_g = lse.reshape(B, Hkv, G, Sq)[..., None]
    p = torch.where(keep, torch.exp(s - lse_g), 0.0)
    og = dout.reshape(B, Sq, Hkv, G, D).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, og)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", og, v.float())
    ds = p * (dp - dsum.reshape(B, Hkv, G, Sq)[..., None])
    if attn_softcap is not None:
        t = torch.tanh(raw / attn_softcap)
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * _scale(D, scale)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.reshape(B, Sq, H, D), dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        dsum: torch.Tensor, *, q_offset: int = 0,
                        k_offset: int = 0, scale: Optional[float] = None,
                        window: Optional[int] = None,
                        attn_softcap: Optional[float] = None):
    """The attention gradient of q against one KV chunk: (dq, dk, dv),
    f32, the contract of ``flash_attention_bwd_plain``. On CUDA: q, k, v
    and dout of one type (f32 or bf16), lse and dsum f32 [B, H, Sq], D in
    {128, 256}; two deterministic passes (dk/dv, then dq), no float
    atomics. On CPU: the plain version. Launches in ``.launches``.
    """
    kw = dict(q_offset=q_offset, k_offset=k_offset, scale=scale,
              window=window, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, lse, dsum, **kw)
    _chunk_checks("flash_attention_bwd", q, k, v, q_offset, k_offset)
    _check_cuda("flash_attention_bwd", q, dout, lse, dsum)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: dout must match q, got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    for name, t in (("lse", lse), ("dsum", dsum)):
        if t.dtype != torch.float32 or t.shape != (B, H, Sq):
            raise ValueError(f"flash_attention_bwd: {name} must be f32 "
                             f"{(B, H, Sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, **f32)
    dk = torch.empty(k.shape, **f32)
    dv = torch.empty(k.shape, **f32)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    fn = _lib("flash_bwd", "ts_flash_bwd", [_P] * 9 + [_I] * 10
              + [_F, _F, _P])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), B, Sq, Sk, H, Hkv, D, _DTYPE_CODE[q.dtype],
              q_offset, k_offset, _window(window), _scale(D, scale),
              _cap(attn_softcap),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def paged_flash_verify_plain(q: torch.Tensor, pool_k: torch.Tensor,
                             pool_v: torch.Tensor, table: torch.Tensor,
                             pos: torch.Tensor, *,
                             scale: Optional[float] = None,
                             window: Optional[int] = None,
                             attn_softcap: Optional[float] = None,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the paged kernels, for Sq >= 1 query
    rows per slot: gather each slot's pages through its table into a
    dense view (int8 pages times their f32 scales, in f32), and let row
    s of slot b attend positions <= pos[b] + s that lie inside the
    window and under an allocated (>= 0) entry. Online-softmax
    conventions of the kernels: f32 throughout, masked p = 0, output
    acc / max(l, 1e-30), so a row with no live position yields 0."""
    B, Sq, H, D = q.shape
    nb, bs, Hkv, _ = pool_k.shape
    mb = table.shape[1]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    safe = table.clamp(min=0).long()
    kd, vd = pool_k[safe].float(), pool_v[safe].float()  # [B, mb, bs, Hkv, D]
    if k_scale is not None:
        kd = kd * k_scale[safe].transpose(-1, -2)[..., None]
        vd = vd * v_scale[safe].transpose(-1, -2)[..., None]
    kd = kd.reshape(B, mb * bs, Hkv, D)
    vd = vd.reshape(B, mb * bs, Hkv, D)
    k_pos = torch.arange(mb * bs, device=q.device)[None, None, :]
    q_pos = (pos.long()[:, None]
             + torch.arange(Sq, device=q.device)[None, :])[..., None]
    keep = (table >= 0).repeat_interleave(bs, dim=1)[:, None, :] \
        & (k_pos <= q_pos)                                   # [B, Sq, K]
    if window is not None:
        keep &= window_keep(q_pos, k_pos, window)
    qg = q.reshape(B, Sq, Hkv, G, D).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kd)
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    keep = keep[:, None, None]
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.where(keep, torch.exp(s - m), 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bhgqd", pr, vd) / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def paged_flash_decode_plain(q: torch.Tensor, pool_k: torch.Tensor,
                             pool_v: torch.Tensor, table: torch.Tensor,
                             pos: torch.Tensor, **kw) -> torch.Tensor:
    """Plain PyTorch version of the paged decode kernel: the Sq = 1
    case of ``paged_flash_verify_plain`` (same keywords); int8 pages
    dequantize in f32."""
    return paged_flash_verify_plain(q, pool_k, pool_v, table, pos, **kw)


def _paged_checks(what: str, q, pool_k, pool_v, table, pos, k_scale,
                  v_scale) -> int:
    """Validate a paged kernel call on CUDA tensors; returns the page
    type code (the q type's code, or ``_I8`` for int8 pages)."""
    quantized = k_scale is not None or v_scale is not None
    extra = (k_scale, v_scale) if quantized else ()
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError(f"{what}: int8 pages need both k_scale and v_scale")
    _check_cuda(what, q, pool_k, pool_v, table, pos, *extra)
    B, Sq, H, D = q.shape
    nb, bs, Hkv, Dk = pool_k.shape
    if (pool_v.shape != pool_k.shape or Dk != D or H % Hkv
            or table.ndim != 2 or table.shape[0] != B
            or pos.shape != (B,)):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)} pool {tuple(pool_k.shape)} "
            f"table {tuple(table.shape)} pos {tuple(pos.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: kernel takes f32 or bf16 q, got {q.dtype}")
    if quantized:
        if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
            raise ValueError(f"{what}: scales given, pages must be int8, "
                             f"got {pool_k.dtype}")
        for s in extra:
            if s.dtype != torch.float32 or s.shape != (nb, Hkv, bs):
                raise ValueError(
                    f"{what}: scale pages must be f32 [nb, Hkv, bs] = "
                    f"{(nb, Hkv, bs)}, got {s.dtype} {tuple(s.shape)}")
    elif pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise ValueError(f"{what}: kernel takes f32 or bf16 pages matching "
                         f"q (or int8 pages with scales), got "
                         f"{q.dtype}/{pool_k.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{what}: table and pos must be int32")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    return _I8 if quantized else _DTYPE_CODE[q.dtype]


def _paged_launch(what, lib, fn, q, pool_k, pool_v, table, pos, k_scale,
                  v_scale, page_code, scale, window, attn_softcap,
                  split=False):
    """Launch one paged kernel (decode or verify: one C signature, to
    which decode, ``split``, adds its split count and scratch); returns
    the output."""
    B, Sq, H, D = q.shape
    nb, bs, Hkv, _ = pool_k.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    tail, types = (), []
    if split:
        S, scratch, ptr = _decode_split_args(q, Hkv, table.shape[1] * bs)
        tail, types = (S, ptr), [_I, _P]
    f = _lib(lib, fn, [_P] * 8 + [_I] * 10 + [_F, _F] + types + [_P])
    code = f(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
             0 if k_scale is None else k_scale.data_ptr(),
             0 if v_scale is None else v_scale.data_ptr(),
             table.data_ptr(), pos.data_ptr(), out.data_ptr(),
             B, Sq, H, Hkv, D, bs, table.shape[1], _DTYPE_CODE[q.dtype],
             page_code, _window(window),
             _scale(D, scale), _cap(attn_softcap), *tail,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, what)
    return out


def paged_flash_decode(q: torch.Tensor, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, table: torch.Tensor,
                       pos: torch.Tensor, *, scale: Optional[float] = None,
                       window: Optional[int] = None,
                       attn_softcap: Optional[float] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Ragged decode attention straight off a paged KV pool.

    q [B, 1, H, D]; pool_k/pool_v [n_blocks, bs, Hkv, D] (one layer's
    pool); table [B, max_blocks] int32 (-1 = unallocated); pos [B] int32
    — slot b attends positions <= pos[b] through its table (the new
    token's KV must already be written at pos[b]). Int8 pools pass
    ``k_scale``/``v_scale`` f32 [n_blocks, Hkv, bs] (the port's scale
    page layout, ``models/quant.py``); pages dequantize in f32 after the
    load. On CUDA: f32 or bf16 q, pages of q's type or int8, D in
    {128, 256}. On CPU: ``paged_flash_decode_plain``. Launches are
    counted in ``.launches`` (f32/bf16 pages) and ``.launches_int8``.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, pool_k, pool_v, table, pos,
                                        scale=scale, window=window,
                                        attn_softcap=attn_softcap,
                                        k_scale=k_scale, v_scale=v_scale)
    page = _paged_checks("paged_flash_decode", q, pool_k, pool_v, table, pos,
                         k_scale, v_scale)
    if q.shape[1] != 1:
        raise ValueError(f"paged_flash_decode: Sq must be 1, got "
                         f"{q.shape[1]} (Sq > 1 is paged_flash_verify)")
    out = _paged_launch("paged_flash_decode", "paged_decode",
                        "ts_paged_decode", q, pool_k, pool_v, table, pos,
                        k_scale, v_scale, page, scale, window, attn_softcap,
                        split=True)
    if page == _I8:
        paged_flash_decode.launches_int8 += 1
    else:
        paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
paged_flash_decode.launches_int8 = 0


def paged_flash_verify(q: torch.Tensor, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, table: torch.Tensor,
                       pos: torch.Tensor, *, scale: Optional[float] = None,
                       window: Optional[int] = None,
                       attn_softcap: Optional[float] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Multi-token attention straight off a paged KV pool: speculative
    verify (Sq = gamma * horizon + 1) and the fused admission tick (Sq =
    the chunk width).

    q [B, Sq, H, D] — slot b's Sq query rows at positions pos[b] ..
    pos[b] + Sq - 1, whose KV must already be written to the pool; row
    s attends positions <= pos[b] + s. Pool, table, scales and types as
    ``paged_flash_decode``. On CUDA any Sq >= 2 (the TPU wrapper's
    Sq <= 16 cap was a VMEM policy and is not carried over). On CPU:
    ``paged_flash_verify_plain``. Launches are counted in ``.launches``
    and ``.launches_int8``.
    """
    if q.device.type == "cpu":
        return paged_flash_verify_plain(q, pool_k, pool_v, table, pos,
                                        scale=scale, window=window,
                                        attn_softcap=attn_softcap,
                                        k_scale=k_scale, v_scale=v_scale)
    page = _paged_checks("paged_flash_verify", q, pool_k, pool_v, table, pos,
                         k_scale, v_scale)
    if q.shape[1] < 2:
        raise ValueError(f"paged_flash_verify: Sq must be >= 2, got "
                         f"{q.shape[1]} (Sq = 1 is paged_flash_decode)")
    out = _paged_launch("paged_flash_verify", "paged_verify",
                        "ts_paged_verify", q, pool_k, pool_v, table, pos,
                        k_scale, v_scale, page, scale, window, attn_softcap)
    if page == _I8:
        paged_flash_verify.launches_int8 += 1
    else:
        paged_flash_verify.launches += 1
    return out


paged_flash_verify.launches = 0
paged_flash_verify.launches_int8 = 0


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor, *, scale: Optional[float] = None,
                       window: Optional[int] = None,
                       attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the contiguous decode kernel: the masked
    ``mha_reference`` of the dense ragged S = 1 branch (row b keeps
    positions <= pos[b], windowed), as the reference model builds it."""
    M = k.shape[1]
    k_pos = torch.arange(M, device=q.device)[None, :]
    p = pos.long()[:, None]
    kv_mask = k_pos <= p
    if window is not None:
        kv_mask &= window_keep(p, k_pos, window)
    return mha_reference(q, k, v, causal=False, kv_mask=kv_mask, scale=scale,
                         attn_softcap=attn_softcap)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, *, scale: Optional[float] = None,
                 window: Optional[int] = None,
                 attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Ragged decode attention over contiguous KV rows.

    q [B, 1, H, D]; k, v [B, M, Hkv, D] (one layer's row cache); pos [B]
    int32 — row b attends positions <= pos[b] (its new token already
    written there), the last ``window`` of them when window > 0. On
    CUDA: f32 or bf16, k and v of q's type, D in {128, 256}, any M. On
    CPU: ``flash_decode_plain``. Launches are counted in ``.launches``.
    """
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos, scale=scale, window=window,
                                  attn_softcap=attn_softcap)
    _check_cuda("flash_decode", q, k, v, pos)
    B, Sq, H, D = q.shape
    Bk, M, Hkv, Dk = k.shape
    if (Sq != 1 or v.shape != k.shape or Bk != B or Dk != D or H % Hkv
            or pos.shape != (B,)):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} pos "
                         f"{tuple(pos.shape)} (Sq must be 1)")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: kernel takes f32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if pos.dtype != torch.int32:
        raise ValueError("flash_decode: pos must be int32")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_decode: kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    S, scratch, ptr = _decode_split_args(q, Hkv, M)
    fn = _lib("flash_decode", "ts_flash_decode", [_P] * 5 + [_I] * 7
              + [_F, _F, _I, _P, _P])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
              out.data_ptr(), B, M, H, Hkv, D, _DTYPE_CODE[q.dtype],
              _window(window), _scale(D, scale), _cap(attn_softcap), S, ptr,
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
