"""Speculative decoding at the generate level: a draft LM proposes, the
target LM verifies. Counterpart of ``tpushare/models/speculative.py``.

A round: the draft proposes gamma x horizon tokens autoregressively
from the newest accepted token, one multi-token draft write of the
whole block fills its last position (a fully accepted round leaves no
hole in the draft's cache), and ONE target forward scores the block.
The verify/accept math is the seam's (``models/spec.py``:
``greedy_accept_core``, ``draft_sample_core``, ``spec_accept_core``) in
lockstep mode: every row cuts at the batch minimum, so shapes stay
uniform and every emitted token still matches the target's own
decoding.

No cache rewind: rejected positions leave stale KV behind, past the
offset; the causal ``q_offset`` mask never attends a position beyond a
query, and the next round's write at that position overwrites it.

The reference's ``lax.while_loop`` is a Python loop here. Its trip
count depends on acceptance, so each round reads its accepted count
back (one device-to-host read per round, as the slot servers' rounds
make); the tokens themselves stay on the device until the end.

``speculative_generate`` (greedy) is bit-identical to
``generate(..., temperature=0.0)`` for any draft: the draft changes
speed, never output. ``speculative_sample`` keeps the target's law at
``temperature`` for every emitted token (Leviathan/Chen rejection
rule). ``model="moe"`` runs both loops on ``moe.forward``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpushare_torch.models.generate import categorical
from tpushare_torch.models.spec import (draft_sample_core,
                                        greedy_accept_core, spec_accept_core)
from tpushare_torch.models.transformer import (TransformerConfig, forward,
                                               init_cache)


def _model_fns(model: str) -> Tuple[Callable, Callable]:
    """(forward_fn, init_cache_fn) of a model family: the only two points
    where the loops touch the model. "moe" adapts ``moe.forward``'s
    (logits, aux, cache) to (logits, cache); routing is recomputed per
    token, so every MoE routing speculates unchanged."""
    if model == "dense":
        return forward, init_cache
    if model == "moe":
        from tpushare_torch.models import moe as _moe

        def fwd(params, toks, cfg, **kw):
            logits, _aux, cache = _moe.forward(params, toks, cfg, **kw)
            return logits, cache
        return fwd, _moe.init_cache
    raise ValueError(f"unknown speculative model family {model!r}")


def _spec_setup(params, draft_params, tokens, cfg, draft_cfg,
                max_new_tokens: int, g: int, attn_impl: str, pick_first,
                draft_layers_hook=None, model: str = "dense"):
    """The loops' shared scaffolding: the vocabulary check, an output
    buffer with slack (a round's g + 1 block write must never clamp; g
    is the whole gamma x horizon block), both caches prefilled, and the
    first token from ``pick_first(last logits)``. Returns (first, out,
    cache, dcache, S)."""
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    B, S = tokens.shape
    fwd, icache = _model_fns(model)
    total = S + max_new_tokens + g + 1
    dev = tokens.device
    cache = icache(cfg, B, total, device=dev)
    dcache = icache(draft_cfg, B, total, device=dev)
    logits, cache = fwd(params, tokens, cfg, cache=cache, pos_offset=0,
                        attn_impl=attn_impl, last_logit_only=True)
    _, dcache = fwd(draft_params, tokens, draft_cfg, cache=dcache,
                    pos_offset=0, attn_impl=attn_impl, last_logit_only=True,
                    layers_hook=draft_layers_hook)
    first = pick_first(logits[:, -1]).to(tokens.dtype)
    out = torch.zeros((B, max_new_tokens + g + 1), dtype=tokens.dtype,
                      device=dev)
    out[:, 0] = first
    return first, out, cache, dcache, S


def _check_horizon(gamma: int, horizon: int) -> int:
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    return gamma * horizon


def _rounds(params, draft_params, tokens, cfg, draft_cfg, *,
            max_new_tokens, g, attn_impl, draft_layers_hook, model,
            pick_first, propose, accept):
    """The round loop both entry points share. ``propose(dl)`` turns the
    draft's [B, V] logits into ([B] token, its law [B, V] or None);
    ``accept(tl, drafts, qdists, base)`` is a lockstep accept core."""
    fwd, _ = _model_fns(model)
    last, out, cache, dcache, S = _spec_setup(
        params, draft_params, tokens, cfg, draft_cfg, max_new_tokens, g,
        attn_impl, pick_first, draft_layers_hook=draft_layers_hook,
        model=model)
    B = tokens.shape[0]
    n = 1
    while n < max_new_tokens:
        # Absolute position of `last`, the newest accepted token.
        p = S + n - 1
        drafts, qdists = [], []
        tok = last
        for j in range(g):
            dl, dcache = fwd(draft_params, tok[:, None], draft_cfg,
                             cache=dcache, pos_offset=p + j,
                             attn_impl=attn_impl,
                             layers_hook=draft_layers_hook)
            tok, q = propose(dl[:, -1])
            tok = tok.to(tokens.dtype)
            drafts.append(tok)
            qdists.append(q)
        drafts_t = torch.stack(drafts, dim=1)                # [B, g]
        block = torch.cat([last[:, None], drafts_t], dim=1)
        _, dcache = fwd(draft_params, block, draft_cfg, cache=dcache,
                        pos_offset=p, attn_impl=attn_impl,
                        last_logit_only=True, layers_hook=draft_layers_hook)
        tl, cache = fwd(params, block, cfg, cache=cache, pos_offset=p,
                        attn_impl=attn_impl)
        base = torch.full((B,), n, dtype=torch.int32, device=tokens.device)
        q_t = None if qdists[0] is None else torch.stack(qdists, dim=1)
        a_b, correction = accept(tl, drafts_t.long(), q_t, base)
        a = int(a_b[0])            # lockstep: every row agrees
        correction = correction[:, 0].to(tokens.dtype)
        # Emit a accepted drafts and the correction at the cut; the
        # positions past it are rewritten by the next round.
        out[:, n:n + a] = drafts_t[:, :a]
        out[:, n + a] = correction
        last = correction
        n += a + 1
    return torch.cat([tokens, out[:, :max_new_tokens]], dim=1)


def speculative_generate(params, draft_params, tokens: torch.Tensor,
                         cfg: TransformerConfig,
                         draft_cfg: Optional[TransformerConfig] = None, *,
                         max_new_tokens: int = 32, gamma: int = 4,
                         horizon: int = 1, attn_impl: str = "auto",
                         draft_layers_hook=None,
                         model: str = "dense") -> torch.Tensor:
    """tokens [B, S] -> [B, S + max_new_tokens], exactly greedy.

    ``draft_cfg`` defaults to ``cfg`` (self-speculation with other
    weights, e.g. ``quant.quantize_params`` of the target served through
    ``draft_layers_hook=quant.dequant_hook(cfg)``). ``horizon`` scales
    the drafted block to gamma x horizon tokens per round; the output is
    the same at every horizon. ``model="moe"``: cfg and draft_cfg are
    MoEConfigs."""
    draft_cfg = draft_cfg or cfg
    g = _check_horizon(gamma, horizon)

    def greedy(logits):
        return torch.argmax(logits, dim=-1)

    def accept(tl, drafts, _q, base):
        return greedy_accept_core(tl, drafts, base, cap=max_new_tokens,
                                  lockstep=True)

    with torch.no_grad():
        return _rounds(params, draft_params, tokens, cfg, draft_cfg,
                       max_new_tokens=max_new_tokens, g=g,
                       attn_impl=attn_impl,
                       draft_layers_hook=draft_layers_hook, model=model,
                       pick_first=greedy,
                       propose=lambda dl: (greedy(dl), None), accept=accept)


def speculative_sample(params, draft_params, tokens: torch.Tensor,
                       cfg: TransformerConfig,
                       draft_cfg: Optional[TransformerConfig] = None, *,
                       generator: Optional[torch.Generator],
                       max_new_tokens: int = 32, gamma: int = 4,
                       horizon: int = 1, temperature: float = 1.0,
                       attn_impl: str = "auto", draft_layers_hook=None,
                       model: str = "dense") -> torch.Tensor:
    """Stochastic speculative sampling (Leviathan/Chen): a draft token x
    of draft probability q(x) is accepted with probability
    min(1, p(x) / q(x)); on rejection the replacement is drawn from the
    normalized residual max(0, p - q). Every emitted token's marginal
    law is the target's softmax at ``temperature``; rows advance in
    lockstep at the batch minimum, which keeps each row's law. Draws
    come from ``generator`` (the reference's ``rng``)."""
    draft_cfg = draft_cfg or cfg
    if temperature <= 0.0:
        raise ValueError("use speculative_generate for greedy decoding")
    g = _check_horizon(gamma, horizon)

    def first(logits):
        return categorical(logits.float() / temperature, generator)

    def propose(dl):
        return draft_sample_core(dl, generator, temperature=temperature)

    def accept(tl, drafts, qdists, base):
        return spec_accept_core(tl, drafts, qdists, generator, base,
                                cap=max_new_tokens, temperature=temperature,
                                lockstep=True)

    with torch.no_grad():
        return _rounds(params, draft_params, tokens, cfg, draft_cfg,
                       max_new_tokens=max_new_tokens, g=g,
                       attn_impl=attn_impl,
                       draft_layers_hook=draft_layers_hook, model=model,
                       pick_first=first, propose=propose, accept=accept)
