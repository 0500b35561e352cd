"""The speculation seam: greedy draft-propose / verify-accept cores and
the per-slot round loop. Counterpart of ``tpushare/models/spec.py``.

- **Pure cores** on logits and tokens: ``greedy_verify_tokens`` (the
  NaN -> -1 guard), ``accept_len``, ``_room_clamp``,
  ``greedy_accept_core`` (longest matched prefix, clamped to the slot's
  room), and the stochastic pair ``draft_sample_core`` /
  ``spec_accept_core`` (Leviathan/Chen rejection rule over the filtered
  laws, drawing from the server's ``torch.Generator``).
- **The round loop** ``SpecDecodeMixin._spec_step_async``: h = gamma x
  horizon draft proposals, the draft-KV catch-up write, ONE multi-token
  target verify, the per-slot acceptance fold, the device-side commit
  and the round's single device-to-host transfer (drafts, correction
  and accepted counts packed into one tensor). A server supplies the
  hooks ``_spec_begin`` / ``_spec_draft_step`` / ``_spec_draft_catchup``
  / ``_spec_verify`` / ``_spec_commit`` / ``_spec_host_lengths`` /
  ``_spec_capacity`` (``models/paged.py`` does).

Greedy emission is exactly what non-speculative greedy decoding
produces, at any horizon: the draft changes speed, never output;
stochastic emission keeps the target sampler's law per token.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from tpushare_torch.models.generate import categorical, filter_logits
from tpushare_torch.models.serving import PendingStep


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
                       base: torch.Tensor, *, cap: int,
                       lockstep: bool = False):
    """Greedy verify-accept: the longest prefix of ``drafts`` [B, g]
    matching the NaN-guarded argmax of ``tl`` [B, g+1, V], clamped to
    the per-slot room. Returns (a_b [B], correction [B, 1]): the
    target's own pick at the cut (the bonus token when every draft
    accepted; -1 when the cut row is poisoned). ``lockstep``: every row
    cuts at the batch minimum."""
    g = drafts.shape[1]
    greedy = greedy_verify_tokens(tl)
    a_b = _room_clamp(accept_len(greedy[:, :g] == drafts), base, cap)
    if lockstep:
        a_b = a_b.min().expand(a_b.shape)
    return a_b, torch.gather(greedy, 1, a_b[:, None])


def draft_sample_core(logits: torch.Tensor,
                      generator: Optional[torch.Generator], *,
                      temperature: float, top_k=None, top_p=None):
    """One draft proposal: [B] tokens drawn from the filtered draft law
    on [B, V] logits, and that law [B, V] f32 (the accept rule's q(x)
    and residual need it)."""
    f = filter_logits(logits, temperature, top_k=top_k, top_p=top_p)
    return categorical(f, generator), torch.softmax(f, dim=-1)


def spec_accept_core(tl: torch.Tensor, drafts: torch.Tensor,
                     qdists: torch.Tensor,
                     generator: Optional[torch.Generator],
                     base: torch.Tensor, *, cap: int, temperature: float,
                     top_k=None, top_p=None, lockstep: bool = False):
    """Stochastic acceptance (Leviathan/Chen rejection rule) over the
    verify logits, per slot (``lockstep``: the batch minimum).

    tl [B, g+1, V] target verify logits, drafts [B, g] drawn from the
    draft's filtered law, qdists [B, g, V] that law. Both sides run
    through the same ``filter_logits`` as the server's sampler, so each
    emitted token's marginal is the non-speculative sampler's law.
    Returns (a_b [B] accepted counts clamped to the room, correction
    [B, 1]): the accepted draft where the capacity clamp cut on an
    accepted position, else a residual max(0, p - q) resample (the bonus
    position has q = 0, so plain p; a residual of mass <= 1e-12 falls
    back to p).

    NaN rules: a poisoned verify row never accepts its draft
    (``accept &= ~bad``), and a cut ON a poisoned row emits -1 instead
    of resampling through a NaN law."""
    B, g = drafts.shape
    V = tl.shape[-1]
    bad = torch.isnan(tl).any(dim=-1)                          # [B, g+1]
    p = torch.softmax(filter_logits(tl, temperature, top_k=top_k,
                                    top_p=top_p), dim=-1)
    pxs = torch.gather(p[:, :g], 2, drafts[..., None])[..., 0]
    qxs = torch.gather(qdists, 2, drafts[..., None])[..., 0]
    u = torch.rand((B, g), generator=generator, device=tl.device,
                   dtype=torch.float32)
    accept = (u < torch.clamp(pxs / torch.clamp(qxs, min=1e-30),
                              max=1.0)) & ~bad[:, :g]
    a_b = _room_clamp(accept_len(accept), base, cap)
    if lockstep:
        a_b = a_b.min().expand(a_b.shape)
    at = a_b[:, None, None].expand(B, 1, V)
    p_at = torch.gather(p, 1, at)[:, 0]                        # [B, V]
    qpad = torch.cat([qdists, torch.zeros_like(qdists[:, :1])], dim=1)
    q_at = torch.gather(qpad, 1, at)[:, 0]
    resid = torch.clamp(p_at - q_at, min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(mass > 1e-12, resid / mass, p_at)
    resampled = categorical(torch.log(torch.clamp(resid, min=1e-30)),
                            generator)
    acc_pad = torch.cat([accept, torch.zeros_like(accept[:, :1])], dim=1)
    acc_at = torch.gather(acc_pad, 1, a_b[:, None])[:, 0]
    draft_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    draft_at = torch.gather(draft_pad, 1, a_b[:, None])[:, 0]
    correction = torch.where(acc_at, draft_at, resampled.to(drafts.dtype))
    cut_bad = torch.gather(bad, 1, a_b[:, None])[:, 0]
    correction = torch.where(cut_bad, torch.full_like(correction, -1),
                             correction)
    return a_b, correction[:, None]


def build_spec_cores(*, cap: int, temperature: float, top_k=None,
                     top_p=None, stochastic: bool):
    """(greedy_accept, draft_sample, stochastic_accept) with the
    server's capacity and sampler filters bound in; the latter two None
    when greedy. One constructor, so the cores' wiring cannot drift."""
    greedy = functools.partial(greedy_accept_core, cap=cap)
    if not stochastic:
        return greedy, None, None
    sample = functools.partial(draft_sample_core, temperature=temperature,
                               top_k=top_k, top_p=top_p)
    accept = functools.partial(spec_accept_core, cap=cap,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p)
    return greedy, sample, accept


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
    ``_sampler`` (its generator feeds the stochastic cores),
    ``device_fetches`` and ``_sync_active()``. No hook may read a device
    value back: the round's one transfer is in finalize.
    """

    def _spec_init(self, *, gamma: int, spec_horizon: int,
                   temperature: float, top_k=None, top_p=None) -> None:
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if spec_horizon < 1:
            raise ValueError(
                f"spec_horizon must be >= 1, got {spec_horizon}")
        self.gamma = gamma
        self.spec_horizon = spec_horizon
        self._spec_stochastic = temperature > 0.0
        # Rounds run, draft tokens proposed, draft tokens accepted
        # (corrections excluded: the accept rate is about the drafts).
        self.spec_rounds = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        (self._greedy_accept, self._draft_sample,
         self._spec_accept) = build_spec_cores(
            cap=self._spec_capacity(), temperature=temperature,
            top_k=top_k, top_p=top_p, stochastic=self._spec_stochastic)
        # The draft laws of a stochastic round, [B, h, V] f32: allocated
        # once per round shape (33 MB at Gemma-2B's vocabulary, 8 slots,
        # h = 4), never per draft step.
        self._spec_qdists: Optional[torch.Tensor] = None

    def _spec_qdists_buf(self, B: int, h: int, V: int,
                         device: torch.device) -> torch.Tensor:
        buf = self._spec_qdists
        if buf is None or buf.shape != (B, h, V) or buf.device != device:
            buf = torch.empty((B, h, V), dtype=torch.float32, device=device)
            self._spec_qdists = buf
        return buf

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
        stochastic = self._spec_stochastic
        gen = self._sampler.generator if stochastic else None
        qdists = None
        drafts: List[torch.Tensor] = []
        for j in range(h):
            dl = self._spec_draft_step(tok, base, j)
            if stochastic:
                if qdists is None:
                    qdists = self._spec_qdists_buf(dl.shape[0], h,
                                                   dl.shape[-1], dl.device)
                nxt, qdists[:, j] = self._draft_sample(dl, gen)
                tok = nxt[:, None]
            else:
                tok = torch.argmax(dl, dim=-1)[:, None]
            drafts.append(tok)
        drafts_arr = torch.cat(drafts, dim=1)                  # [B, h]
        block = torch.cat([self.last_token, drafts_arr], dim=1)
        self._spec_draft_catchup(block, tok, base, h)
        tl = self._spec_verify(block, base)
        if stochastic:
            a_b, correction = self._spec_accept(tl, drafts_arr, qdists,
                                                gen, base)
        else:
            a_b, correction = self._greedy_accept(tl, drafts_arr, base)
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
