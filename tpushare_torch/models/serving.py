"""Serving pieces the slot servers share. Counterpart of the sampler,
tick-contract and chunk-scheduling parts of ``tpushare/models/serving.py``:
``TokenSampler`` (with the NaN -> -1 guard), ``PendingStep``, and the
fused admission tick's ``bucket_len`` / ``fused_chunk_span`` /
``fused_token_batch``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from tpushare_torch.models.generate import TODO_SAMPLING, sample_logits


def bucket_len(n: int, floor: int = 16) -> int:
    """Next power of two >= n (floor 16): the one bucketing policy the
    slot servers share."""
    b = floor
    while b < n:
        b *= 2
    return b


def fused_chunk_span(done: int, S: int, chunk: int,
                     max_chunk_tokens: Optional[int] = None,
                     gran: int = 1) -> Tuple[int, int]:
    """This tick's fused-admission span [done, end) and the padded
    batch width. Mid chunks run at the fixed ``chunk`` width; the final
    chunk bucket-pads, capped at ``chunk``. ``max_chunk_tokens`` is the
    engine's per-tick token budget for the chunk, rounded down to
    ``gran`` (the pool's block size). Returns (end, width); width == 0
    means the budget leaves no room for one granule and the caller runs
    a plain tick."""
    eff = chunk
    if max_chunk_tokens is not None:
        eff = min(eff, (max_chunk_tokens // gran) * gran)
    if eff < max(1, gran):
        return done, 0
    end = min(S, done + eff)
    width = min(bucket_len(end - done), eff) if end >= S else eff
    return end, width


def fused_token_batch(last_token: torch.Tensor, prompt: torch.Tensor,
                      done: int, end: int, width: int,
                      slot: int) -> torch.Tensor:
    """The fused tick's [B, width] token batch: every row's column 0 is
    its pending last token (decode rows consume exactly that; their
    columns >= 1 are junk whose KV the length masks keep unattended
    until real writes overwrite it), and the admitting row carries
    prompt[done:end] zero-padded to ``width``."""
    B = last_token.shape[0]
    toks = torch.zeros((B, width), dtype=torch.int64,
                       device=last_token.device)
    toks[:, 0] = last_token[:, 0]
    toks[slot] = 0
    toks[slot, :end - done] = prompt[done:end].to(torch.int64)
    return toks


class TokenSampler:
    """Per-server sampling state. Greedy only in this slice;
    ``temperature > 0`` (and top-k/top-p) raise until ROADMAP A7."""

    def __init__(self, temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0):
        if temperature > 0.0 or top_k is not None or top_p is not None:
            raise NotImplementedError(f"stochastic sampling: "
                                      f"{TODO_SAMPLING}")
        self.temperature = temperature
        self.seed = seed

    def pick(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, V] logits -> [B] token ids, on the logits' device. A NaN
        logits row picks -1 (invalid by construction): bare argmax
        would launder a poisoned row into a plausible in-vocab id."""
        tok = sample_logits(logits, temperature=self.temperature)
        bad = torch.isnan(logits).any(dim=-1)
        return torch.where(bad, torch.full_like(tok, -1), tok)


class PendingStep:
    """A dispatched tick whose one device->host token fetch is still
    owed: ``step_async`` has enqueued all device work, ``finalize()``
    does the fetch and builds ``{slot: token}``.
    ``step() == step_async().finalize()``. ``finalize(invalid=...)``
    drops slots whose request changed while the tick was in flight.
    Finalize is one-shot."""

    __slots__ = ("_fn", "_ready", "slots")

    def __init__(self, finalize_fn=None, *, ready=None,
                 slots: Tuple[int, ...] = ()):
        self._fn = finalize_fn
        self._ready = ready
        self.slots = tuple(slots)

    @classmethod
    def done(cls, out: Dict[int, Any]) -> "PendingStep":
        """An already-finalized tick (e.g. an empty batch)."""
        return cls(ready=out, slots=tuple(out))

    def finalize(self, invalid=frozenset()) -> Dict[int, Any]:
        if self._fn is None:
            out = self._ready
            if invalid:
                out = {s: t for s, t in out.items() if s not in invalid}
            return out
        fn, self._fn = self._fn, None
        return fn(frozenset(invalid))
