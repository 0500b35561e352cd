"""Normalization primitives. Counterpart of ``tpushare/ops/norms.py``.

Plain PyTorch: these are elementwise passes the card runs near its
memory rate without a hand-written kernel, as XLA fused them on the TPU.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             upcast: bool = True, offset: float = 0.0) -> torch.Tensor:
    """RMSNorm (Gemma/Llama style).

    ``offset=1.0`` is Gemma's ``(1 + w) * norm(x)``; Llama uses 0.0.
    Statistics in f32 regardless of input dtype, result cast back.
    """
    dtype = x.dtype
    if upcast:
        x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.reciprocal(torch.sqrt(var + eps))
    y = y * (offset + weight.to(y.dtype))
    return y.to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm (BERT style; eps default matches BERT's 1e-12)."""
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    y = y * weight.to(y.dtype) + bias.to(y.dtype)
    return y.to(dtype)
