"""Token sampling for the decoder LM. Counterpart of
``tpushare/models/generate.py`` (``filter_logits``, ``sample_logits``);
the scanned ``generate`` loop is not ported yet (ROADMAP A12).

Sampling runs on the logits' device with plain torch ops (``topk``,
``sort``, ``softmax``, ``cumsum``, ``rand``): no host round trip and no
data-dependent host decision, so a tick keeps its one fetch and stays
capturable. The draw is Gumbel-max, ``argmax(f - log(-log(u)))`` with
``u`` uniform from the caller's ``torch.Generator``: the same law
``jax.random.categorical`` draws by the same construction (the bits
differ between the frameworks; the tests compare laws)."""

from __future__ import annotations

from typing import Optional

import torch


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked f32 logits on [..., V];
    the softmax of the result IS the sampling law (speculative
    acceptance evaluates it directly). Filters compose in the reference
    order: temperature, top-k at the k-th value, then top-p (keep the
    ranks whose PRECEDING mass is < p; rank 0 always survives; the
    cutoff is the smallest kept logit). Threshold-tied logits all
    survive both filters. Requires temperature > 0."""
    logits = logits.float() / temperature
    if top_k is not None and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        cutoff = sorted_logits.masked_fill(~keep, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def categorical(logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of [..., V] logits (-inf = excluded) by
    Gumbel-max, ``u`` clamped into (0, 1) so both logs stay finite."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny, max=1.0 - 2.0 ** -24)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  temperature: float = 0.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """One sampling step on [B, V] logits -> [B] token ids. Greedy
    (temperature <= 0) is argmax, first index on ties as in JAX; else one
    draw from ``softmax(filter_logits(...))`` off ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return categorical(filter_logits(logits, temperature, top_k=top_k,
                                     top_p=top_p), generator)
