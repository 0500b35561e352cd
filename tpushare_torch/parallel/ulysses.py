"""Ulysses all-to-all sequence parallelism (DeepSpeed-Ulysses).
Counterpart of ``tpushare/parallel/ulysses.py``.

The other long-context strategy beside ``ring_attention``: instead of
rotating K/V chunks around the ring for n - 1 hops, one all-to-all
re-shards the activations from sequence-sharded [B, S/n, H, D] to
head-sharded [B, S, H/n, D], each rank runs ordinary causal attention
over the whole sequence for its head slice (``ops.attention.attention``:
the flash kernel on the card, its plain version on the CPU), and a
second all-to-all restores sequence sharding. The exchanges go through
``torch.distributed.all_to_all_single``; their gradient is the inverse
exchange (``_AllToAll``), so the layer is differentiable and every rank
of the group must run its backward. A group of one does no collective.

Trade-offs against the ring, as in the reference: the group size must
divide the query heads; kv heads that it does not divide are repeated
up to the query heads before the exchange (GQA bytes inflate toward
MHA, so the ring suits Hkv < n better). Windows and softcaps need no
cross-chunk merge: each rank's attention is whole.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from tpushare_torch.ops.attention import attention
from tpushare_torch.parallel.ring_attention import _GatherSeq

IMPLS = ("auto", "reference")


def _exchange(x: torch.Tensor, group, split: int, concat: int
              ) -> torch.Tensor:
    """Split ``x`` into n pieces along ``split``, send piece j to rank j
    of ``group``, and concatenate the pieces received along ``concat``
    in rank order (the reference's tiled ``all_to_all``)."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    """``_exchange`` with its gradient: the exchange the other way."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _exchange(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g.contiguous(), ctx.group, ctx.concat, ctx.split),
                None, None, None)


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Repeat each kv head for its group of query heads: [B, S, Hkv, D]
    -> [B, S, num_heads, D] (query head j reads kv head j // G)."""
    num_kv = k.shape[2]
    if num_kv == num_heads:
        return k
    if num_heads % num_kv:
        raise ValueError(f"q heads {num_heads} not a multiple of kv heads "
                         f"{num_kv}")
    return torch.repeat_interleave(k, num_heads // num_kv, dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      group, causal: bool = True,
                      scale: Optional[float] = None,
                      window: Optional[int] = None,
                      attn_softcap: Optional[float] = None,
                      impl: str = "auto") -> torch.Tensor:
    """Per-rank all-to-all attention over the process group ``group``.

    q [B, S_local, H, D]; k, v [B, S_local, Hkv, D]: contiguous sequence
    shards (rank i holds positions [i*S_local, (i+1)*S_local)), as for
    ``ring_attention``. ``impl`` is ``attention``'s: "auto" (the flash
    kernel wrapper) or "reference". Requires H % n == 0. Returns this
    rank's output [B, S_local, H, D] in q's type."""
    if impl not in IMPLS:
        raise ValueError(f"unknown ulysses impl {impl!r}; one of {IMPLS}")
    kw = dict(causal=causal, scale=scale, window=window,
              attn_softcap=attn_softcap, impl=impl)
    n = dist.get_world_size(group)
    if n == 1:
        return attention(q, k, v, **kw)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs sp ({n}) to divide heads ({H})")
    if k.shape[2] % n:
        k, v = _expand_kv(k, H), _expand_kv(v, H)

    def seq_to_heads(x):          # [B, S/n, h, D] -> [B, S, h/n, D]
        return _AllToAll.apply(x, group, 2, 1)

    out = attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), **kw)
    return _AllToAll.apply(out.to(q.dtype), group, 1, 2)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, mesh,
                              axis_name: str = "sp", causal: bool = True,
                              scale: Optional[float] = None,
                              window: Optional[int] = None,
                              attn_softcap: Optional[float] = None,
                              impl: str = "auto") -> torch.Tensor:
    """Convenience wrapper for callers holding whole sequences (the
    counterpart of ``ring_attention_sharded``): every rank passes the
    same q [B, S, H, D], k, v [B, S, Hkv, D]; each runs
    ``ulysses_attention`` on its shard along ``axis_name`` of ``mesh``
    and the outputs are gathered back to [B, S, H, D] on every rank.
    Under autograd a rank's gradients cover the positions it owns;
    summed over the group they are the gradient of the whole."""
    group = mesh.get_group(axis_name)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    S = q.shape[1]
    if S % n or k.shape[1] != S:
        raise ValueError(f"sequence {S} (k {k.shape[1]}) does not shard "
                         f"over {n} ranks")
    part = slice(idx * S // n, (idx + 1) * S // n)
    out = ulysses_attention(q[:, part], k[:, part], v[:, part], group=group,
                            causal=causal, scale=scale, window=window,
                            attn_softcap=attn_softcap, impl=impl)
    return _GatherSeq.apply(out, group)
