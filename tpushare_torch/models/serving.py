"""Serving pieces the slot servers share. Counterpart of the sampler and
tick-contract parts of ``tpushare/models/serving.py``: ``TokenSampler``
(with the NaN -> -1 guard) and ``PendingStep``."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from tpushare_torch.models.generate import TODO_SAMPLING, sample_logits


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
