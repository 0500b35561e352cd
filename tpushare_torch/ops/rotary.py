"""Rotary position embeddings (RoPE), half-split layout. Counterpart of
``tpushare/ops/rotary.py``: rotate pairs (i, i + d/2), tables and
rotation in f32, result cast back to the input dtype."""

from __future__ import annotations

import math

import torch


def rotary_embedding(positions: torch.Tensor, head_dim: int, *,
                     base: float = 10000.0,
                     scaling=None,
                     dtype: torch.dtype = torch.float32):
    """cos/sin tables for integer ``positions`` ([...] -> [..., head_dim/2]).

    ``scaling``: optional Llama-3 long-context frequency remap, a
    (factor, low_freq_factor, high_freq_factor, original_max_pos)
    tuple: wavelengths longer than original_max/low are slowed by
    ``factor``, shorter than original_max/high pass through, and the
    band between interpolates smoothly.
    """
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = base ** (-idx / half)
    if scaling is not None:
        factor, low, high, orig = scaling
        wavelen = 2.0 * math.pi / freqs
        smooth = torch.clamp((orig / wavelen - low) / (high - low), 0.0, 1.0)
        mixed = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(wavelen > orig / low, freqs / factor,
                            torch.where(wavelen < orig / high, freqs, mixed))
    angles = positions.float()[..., None] * freqs               # [..., half]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ([B, S, H, D]) by per-position cos/sin ([B, S, D/2]),
    broadcast over heads; computed in f32 and cast back to x.dtype."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)
