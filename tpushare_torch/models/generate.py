"""Token sampling and the generate loop for the decoder LM. Counterpart
of ``tpushare/models/generate.py`` (``filter_logits``, ``sample_logits``,
``generate``).

``generate`` is the dense-cache loop: one prefill into a row cache of
exactly prompt + new tokens (``last_logit_only``), then S = 1 steps at a
scalar offset (the reference's ``lax.scan`` is a Python loop). Every
pick stays on the device; nothing is read back until the caller reads
the result, so the loop makes no per-token host sync.

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

from tpushare_torch.models.transformer import (TransformerConfig, forward,
                                               init_cache)


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


def generate(params, tokens: torch.Tensor, cfg: TransformerConfig, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             attn_impl: str = "auto", layers_hook=None) -> torch.Tensor:
    """tokens [B, S] -> [B, S + max_new_tokens], on tokens' device.

    Temperature 0 is greedy; otherwise sampling at that temperature with
    the optional top-k / top-p filters, drawing from ``generator`` (the
    reference's ``rng``). The cache is sized S + max_new_tokens, so the
    footprint is known before the first step."""
    B, S = tokens.shape
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    with torch.no_grad():
        cache = init_cache(cfg, B, S + max_new_tokens, device=tokens.device)
        logits, cache = forward(params, tokens, cfg, cache=cache,
                                pos_offset=0, attn_impl=attn_impl,
                                last_logit_only=True,
                                layers_hook=layers_hook)
        last = logits[:, -1]
        out = torch.empty((B, max_new_tokens), dtype=tokens.dtype,
                          device=tokens.device)
        for i in range(max_new_tokens):
            tok = sample_logits(last, generator, temperature=temperature,
                                top_k=top_k, top_p=top_p).to(tokens.dtype)
            out[:, i] = tok
            if i + 1 == max_new_tokens:
                break
            logits, cache = forward(params, tok[:, None], cfg, cache=cache,
                                    pos_offset=S + i, attn_impl=attn_impl,
                                    layers_hook=layers_hook)
            last = logits[:, -1]
    return torch.cat([tokens, out], dim=1)
