"""Attention kernels of the port: wrappers around the hand-written Hopper
kernels in ``csrc/``, each with its plain PyTorch version beside it.
Counterpart of ``tpushare/ops/flash_attention.py``.

- ``flash_attention`` -> ``csrc/flash_prefill.cu`` (replaces the Pallas
  ``_fa_kernel`` and ``_fa_stream_kernel``); plain version:
  ``mha_reference``.
- ``paged_flash_decode`` -> ``csrc/paged_decode.cu`` (replaces the
  Pallas ``_paged_decode_kernel`` for f32/bf16 pages); plain version:
  ``paged_flash_decode_plain``.

Dispatch rule: a wrapper given CPU tensors runs the plain version; given
CUDA tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream, and raises on anything the kernel does not
take or on a launch error — never a quiet fallback. Each wrapper counts
its kernel launches in ``<wrapper>.launches`` (a plain int), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpushare_torch.ops import _build
from tpushare_torch.ops.attention import NEG_INF, mha_reference, window_keep

KERNEL_HEAD_DIMS = (128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

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
    """
    if q.device.type == "cpu":
        return mha_reference(q, k, v, q_offset=q_offset, scale=scale,
                             window=window, attn_softcap=attn_softcap)
    _check_cuda("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or H % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: kernel takes f32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if not isinstance(q_offset, int):
        raise TypeError("flash_attention: q_offset must be a Python int")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    fn = _lib("flash_prefill", "ts_flash_prefill",
              [_P] * 4 + [_I] * 9 + [_F, _F, _P])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              B, Sq, Sk, H, Hkv, D, _DTYPE_CODE[q.dtype], q_offset,
              _window(window),
              D ** -0.5 if scale is None else float(scale),
              0.0 if attn_softcap is None else float(attn_softcap),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def paged_flash_decode_plain(q: torch.Tensor, pool_k: torch.Tensor,
                             pool_v: torch.Tensor, table: torch.Tensor,
                             pos: torch.Tensor, *,
                             scale: Optional[float] = None,
                             window: Optional[int] = None,
                             attn_softcap: Optional[float] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the paged decode kernel: gather each
    slot's pages through its table into a dense view, mask positions
    past ``pos``, outside the window, or under a -1 entry, and run the
    online-softmax arithmetic (f32, masked p = 0, acc / max(l, 1e-30):
    a slot with no live position yields 0, as in the kernel)."""
    B, _, H, D = q.shape
    nb, bs, Hkv, _ = pool_k.shape
    mb = table.shape[1]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    safe = table.clamp(min=0).long()
    kd = pool_k[safe].reshape(B, mb * bs, Hkv, D).float()
    vd = pool_v[safe].reshape(B, mb * bs, Hkv, D).float()
    k_pos = torch.arange(mb * bs, device=q.device)[None, :]
    p = pos.long()[:, None]
    keep = (table >= 0).repeat_interleave(bs, dim=1) & (k_pos <= p)
    if window is not None:
        keep &= window_keep(p, k_pos, window)
    qg = q[:, 0].reshape(B, Hkv, G, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kd)
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    keep = keep[:, None, None, :]
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.where(keep, torch.exp(s - m), 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", pr, vd) / l.clamp(min=1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)


def paged_flash_decode(q: torch.Tensor, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, table: torch.Tensor,
                       pos: torch.Tensor, *, scale: Optional[float] = None,
                       window: Optional[int] = None,
                       attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Ragged decode attention straight off a paged KV pool.

    q [B, 1, H, D]; pool_k/pool_v [n_blocks, bs, Hkv, D] (one layer's
    pool); table [B, max_blocks] int32 (-1 = unallocated); pos [B] int32
    — slot b attends positions <= pos[b] through its table (the new
    token's KV must already be written at pos[b]). On CUDA: f32 or bf16
    pages, D in {128, 256}. On CPU: ``paged_flash_decode_plain``.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, pool_k, pool_v, table, pos,
                                        scale=scale, window=window,
                                        attn_softcap=attn_softcap)
    _check_cuda("paged_flash_decode", q, pool_k, pool_v, table, pos)
    B, Sq, H, D = q.shape
    nb, bs, Hkv, Dk = pool_k.shape
    if (Sq != 1 or pool_v.shape != pool_k.shape or Dk != D or H % Hkv
            or table.ndim != 2 or table.shape[0] != B
            or pos.shape != (B,)):
        raise ValueError(
            f"paged_flash_decode: shapes q {tuple(q.shape)} pool "
            f"{tuple(pool_k.shape)} table {tuple(table.shape)} pos "
            f"{tuple(pos.shape)}")
    if q.dtype not in _DTYPE_CODE or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise ValueError(f"paged_flash_decode: kernel takes f32 or bf16 "
                         f"pages matching q, got {q.dtype}/{pool_k.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_flash_decode: table and pos must be int32")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_flash_decode: kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _lib("paged_decode", "ts_paged_decode",
              [_P] * 6 + [_I] * 8 + [_F, _F, _P])
    code = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
              table.data_ptr(), pos.data_ptr(), out.data_ptr(),
              B, H, Hkv, D, bs, table.shape[1], _DTYPE_CODE[q.dtype],
              _window(window),
              D ** -0.5 if scale is None else float(scale),
              0.0 if attn_softcap is None else float(attn_softcap),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
