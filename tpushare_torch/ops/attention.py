"""Multi-head / grouped-query attention: the plain reference and the
implementation dispatch. Counterpart of ``tpushare/ops/attention.py``.

``mha_reference`` is the semantic ground truth (grouped einsum, f32
softmax); ``attention()`` routes to the hand-written flash kernel
(``ops/flash_attention.py``) unless the caller asks for the reference.

Layout: [batch, seq, heads, head_dim] (BSHD). GQA is num_kv_heads <
num_heads with num_heads a multiple of num_kv_heads.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free

# Window span standing in for "global" (window <= 0): large enough that
# no cache position trails a query by more.
GLOBAL_SPAN = 2 ** 30


def window_keep(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int) -> torch.Tensor:
    """Keep-mask for sliding-window attention: True where ``k_pos`` is
    within the last ``window`` positions of ``q_pos``; ``window <= 0``
    means global. The one copy of the window boundary rule the plain
    paths share (the kernels spell the same comparison in CUDA)."""
    w_eff = window if window > 0 else GLOBAL_SPAN
    return k_pos > q_pos - w_eff


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  q_offset: int = 0,
                  scale: Optional[float] = None,
                  kv_mask: Optional[torch.Tensor] = None,
                  window: Optional[int] = None,
                  attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Attention ground truth.

    q: [B, Sq, H, D]; k, v: [B, Sk, Hkv, D]. ``q_offset`` is the
    absolute position of q[0] within the kv sequence. ``kv_mask``
    [B, Sk] (or [B, Sq, Sk]) marks valid kv positions. ``window`` limits
    causal attention to the last ``window`` positions (<= 0 = global).
    ``attn_softcap`` applies cap*tanh(logits/cap) before masking.
    Softmax in f32, output in q.dtype.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    # Grouped einsum: KV is contracted once per kv head, never
    # broadcast up to H heads.
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if attn_softcap is not None:
        logits = attn_softcap * torch.tanh(logits / attn_softcap)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(k_pos <= q_pos, logits, NEG_INF)
        if window is not None:
            logits = torch.where(window_keep(q_pos, k_pos, window),
                                 logits, NEG_INF)
    if kv_mask is not None:
        if kv_mask.ndim == 3:                       # [B, Sq, Sk]
            logits = torch.where(kv_mask[:, None, None], logits, NEG_INF)
        else:                                       # [B, Sk]
            logits = torch.where(kv_mask[:, None, None, None], logits,
                                 NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              q_offset: int = 0,
              scale: Optional[float] = None,
              kv_mask: Optional[torch.Tensor] = None,
              window: Optional[int] = None,
              attn_softcap: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Dispatching attention entry point used by the models.

    impl: 'auto' (the causal flash kernel wrapper — kernel on CUDA
    tensors, its plain version on CPU tensors) or 'reference'. Masked
    or non-causal reads (``kv_mask``, ``causal=False``) take the
    reference: the kernel is causal and has no mask operand (the JAX
    flash kernel has none either).
    """
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto" and causal and kv_mask is None:
        from tpushare_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, q_offset=q_offset, scale=scale,
                               window=window, attn_softcap=attn_softcap)
    return mha_reference(q, k, v, causal=causal, q_offset=q_offset,
                         scale=scale, kv_mask=kv_mask, window=window,
                         attn_softcap=attn_softcap)
