"""The speculation seam: greedy draft-propose / verify-accept cores and
the per-slot round loop. Counterpart of ``tpushare/models/spec.py``.

- **Pure cores** on logits and tokens: ``greedy_verify_tokens`` (the
  NaN -> -1 guard), ``accept_len``, ``_room_clamp`` and
  ``greedy_accept_core`` (longest matched prefix, clamped to the slot's
  room). The stochastic cores (``draft_sample_core``,
  ``spec_accept_core``) are not ported yet and raise.
- **The round loop** ``SpecDecodeMixin._spec_step_async``: h = gamma x
  horizon draft proposals, the draft-KV catch-up write, ONE multi-token
  target verify, the per-slot acceptance fold, the device-side commit
  and the round's single device-to-host transfer (drafts, correction
  and accepted counts packed into one tensor). A server supplies the
  hooks ``_spec_begin`` / ``_spec_draft_step`` / ``_spec_draft_catchup``
  / ``_spec_verify`` / ``_spec_commit`` / ``_spec_host_lengths`` /
  ``_spec_capacity`` (``models/paged.py`` does).

Greedy emission is exactly what non-speculative greedy decoding
produces, at any horizon: the draft changes speed, never output.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tpushare_torch.models.serving import PendingStep

TODO_STOCHASTIC = "ROADMAP A7 (stochastic speculation)"


def greedy_verify_tokens(tl: torch.Tensor) -> torch.Tensor:
    """NaN-guarded greedy verify argmax, [..., V] -> [...]: a NaN logits
    row picks -1, which never matches a draft, so acceptance cuts
    before the poisoned position and the emitted correction is the
    sentinel the engine quarantines."""
    return torch.where(torch.isnan(tl).any(dim=-1),
                       torch.full(tl.shape[:-1], -1, dtype=torch.int64,
                                  device=tl.device),
                       torch.argmax(tl, dim=-1))


def accept_len(accept: torch.Tensor) -> torch.Tensor:
    """Longest accepted prefix: [B, g] bool -> [B] counts."""
    return torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)


def _room_clamp(a_b: torch.Tensor, base: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Clamp accepted counts so a round's emit count (a + 1) never takes
    a slot past ``cap`` tokens: a_b <= max(cap - base - 1, 0)."""
    return torch.minimum(a_b, torch.clamp(cap - base.to(torch.int64) - 1,
                                          min=0))


def greedy_accept_core(tl: torch.Tensor, drafts: torch.Tensor,
                       base: torch.Tensor, *, cap: int):
    """Greedy verify-accept: the longest prefix of ``drafts`` [B, g]
    matching the NaN-guarded argmax of ``tl`` [B, g+1, V], clamped to
    the per-slot room. Returns (a_b [B], correction [B, 1]): the
    target's own pick at the cut (the bonus token when every draft
    accepted; -1 when the cut row is poisoned)."""
    g = drafts.shape[1]
    greedy = greedy_verify_tokens(tl)
    a_b = _room_clamp(accept_len(greedy[:, :g] == drafts), base, cap)
    return a_b, torch.gather(greedy, 1, a_b[:, None])


def draft_sample_core(*args, **kwargs):
    raise NotImplementedError(f"draft sampling: {TODO_STOCHASTIC}")


def spec_accept_core(*args, **kwargs):
    raise NotImplementedError(f"stochastic acceptance: {TODO_STOCHASTIC}")


class SpecDecodeMixin:
    """The speculative-round loop. A server calls ``_spec_init`` at
    construction and implements the hook surface:

    - ``_spec_begin(h)`` -> base [B] device lengths, after capacity
      prep (paged: blocks through length + h).
    - ``_spec_draft_step(tok, base, j)`` -> [B, V] draft logits for
      proposal j, writing the draft KV at ``base + j``.
    - ``_spec_draft_catchup(block, tok, base, h)``: write the last
      proposal's draft KV at ``base + h`` (without it a fully accepted
      round leaves a draft-KV hole every later proposal attends).
    - ``_spec_verify(block, base)`` -> [B, h+1, V] target logits; target
      KV written, lengths NOT advanced (rejected positions hold stale
      KV the length mask keeps unattended until overwritten).
    - ``_spec_commit(a_b, correction, active)``: advance the device
      lengths by a + 1 per active slot and fold the correction into
      ``last_token``.
    - ``_spec_host_lengths()`` -> the host lengths mirror;
      ``_spec_capacity()`` -> the per-slot token capacity.

    Requires ``active`` (host bool), ``_active_dev``, ``last_token``,
    ``device_fetches`` and ``_sync_active()``. No hook may read a device
    value back: the round's one transfer is in finalize.
    """

    def _spec_init(self, *, gamma: int, spec_horizon: int,
                   temperature: float) -> None:
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if spec_horizon < 1:
            raise ValueError(
                f"spec_horizon must be >= 1, got {spec_horizon}")
        if temperature > 0.0:
            raise NotImplementedError(
                f"speculation at temperature > 0: {TODO_STOCHASTIC}")
        self.gamma = gamma
        self.spec_horizon = spec_horizon
        # Rounds run, draft tokens proposed, draft tokens accepted
        # (corrections excluded: the accept rate is about the drafts).
        self.spec_rounds = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0

    @property
    def spec_block_len(self) -> int:
        """Drafted tokens per round: gamma x horizon (the verify block
        is this + 1)."""
        return self.gamma * self.spec_horizon

    def spec_accept_rate(self) -> Optional[float]:
        """Accepted / proposed draft tokens so far (None before the
        first round)."""
        if not self.spec_draft_tokens:
            return None
        return self.spec_accepted_tokens / self.spec_draft_tokens

    def _spec_step_async(self) -> PendingStep:
        """One speculative round, {slot: [tokens...]} with up to h + 1
        tokens per slot, its one fetch deferred to finalize. Dispatch:
        drafts, verify, the device-side commit. Finalize: the packed
        tokens + counts fetch, the host mirror advance it implies,
        acceptance accounting and capacity retirement."""
        if not self.active.any():
            return PendingStep.done({})
        h = self.spec_block_len
        base = self._spec_begin(h)
        active = self._active_dev
        tok = self.last_token
        drafts: List[torch.Tensor] = []
        for j in range(h):
            dl = self._spec_draft_step(tok, base, j)
            tok = torch.argmax(dl, dim=-1)[:, None]
            drafts.append(tok)
        drafts_arr = torch.cat(drafts, dim=1)                  # [B, h]
        block = torch.cat([self.last_token, drafts_arr], dim=1)
        self._spec_draft_catchup(block, tok, base, h)
        tl = self._spec_verify(block, base)
        a_b, correction = greedy_accept_core(tl, drafts_arr, base,
                                             cap=self._spec_capacity())
        self._spec_commit(a_b, correction, active)
        # One tensor carries the round's whole answer: one transfer.
        packed = torch.cat([drafts_arr, correction, a_b[:, None]], dim=1)
        cap = self._spec_capacity()
        slots = [int(s) for s in np.nonzero(self.active)[0]]
        self.spec_rounds += 1
        self.spec_draft_tokens += len(slots) * h

        def _finalize(invalid):
            self.device_fetches += 1
            rows = packed.tolist()
            lnp = self._spec_host_lengths()
            out: Dict[int, list] = {}
            retired = False
            for slot in slots:
                if slot in invalid:
                    continue
                row = rows[slot]
                a = row[h + 1]
                lnp[slot] += a + 1
                self.spec_accepted_tokens += a
                out[slot] = row[:a] + [row[h]]
                if int(lnp[slot]) >= cap:
                    self.active[slot] = False
                    retired = True
            if retired:
                self._sync_active()
            return out

        return PendingStep(_finalize, slots=slots)
