"""Token sampling for the decoder LM. Counterpart of
``tpushare/models/generate.py`` (``sample_logits``); the scanned
``generate`` loop is not ported yet (ROADMAP A12)."""

from __future__ import annotations

import torch

TODO_SAMPLING = "ROADMAP A7 (temperature / top-k / top-p sampling)"


def sample_logits(logits: torch.Tensor, *,
                  temperature: float = 0.0) -> torch.Tensor:
    """One sampling step on [B, V] logits -> [B] token ids. Greedy
    (temperature <= 0) is argmax, first index on ties as in JAX."""
    if temperature > 0.0:
        raise NotImplementedError(f"temperature sampling: {TODO_SAMPLING}")
    return torch.argmax(logits, dim=-1)
