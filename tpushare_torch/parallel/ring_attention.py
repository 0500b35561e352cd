"""Ring attention: exact causal attention over a sequence-sharded process
group. Counterpart of ``tpushare/parallel/ring_attention.py``.

Rank i of the ``sp`` group holds positions [i*S, (i+1)*S) of q, k and v.
K/V rotate around the ring unexpanded (Hkv-sized, GQA heads are never
broadcast) by ``torch.distributed`` point-to-point sends; at each hop a
rank runs ``flash_attention_partial`` of its queries against the chunk
in hand, at ``q_offset = rank*S`` and ``k_offset = owner*S``, and folds
the chunk's unnormalized (acc, m, l) into its running state in f32
(``merge_partial``). A chunk wholly in a rank's future costs its kernel
no tile: the partial kernel's causal frontier leaves it m = NEG_INF,
l = 0, acc = 0, which the merge absorbs.

The gradient is written out (``RingAttentionFn``), since a
point-to-point send is not differentiable: the ring backward walks the
same hops, each rank computing its queries' (dq, dk, dv) against the
chunk in hand with ``flash_attention_bwd`` from the final log-sum-exp,
and rotates (k, v, dk_acc, dv_acc) together, so after n hops each chunk's
dk/dv — summed over every rank's queries, in f32 — is back at its owner,
which casts it once. This is the explicit form of the transposed
``ppermute`` JAX derives. A group of one does no point-to-point work.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from tpushare_torch.ops.attention import NEG_INF
from tpushare_torch.parallel.mesh import host_staged
from tpushare_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_partial,
    flash_attention_partial_plain, softmax_dsum,
)

IMPLS = ("auto", "dense")


def _rotate(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's, all in one batch; a group of one keeps its own."""
    n = dist.get_world_size(group)
    if n == 1:
        return tensors
    r = dist.get_rank(group)
    staged = host_staged(tensors[0], group)
    dev = tensors[0].device
    if staged:
        tensors = [t.cpu() for t in tensors]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, buf in zip(tensors, bufs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), group=group,
                              group_peer=(r + 1) % n))
        ops.append(dist.P2POp(dist.irecv, buf, group=group,
                              group_peer=(r - 1) % n))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(dev) for b in bufs] if staged else bufs


def _bshd(stat: torch.Tensor) -> torch.Tensor:
    """[B, H, Sq] softmax stats broadcast against a [B, Sq, H, D] tensor."""
    return stat.transpose(1, 2)[..., None]


def merge_partial(state, part):
    """Fold one chunk's (acc, m, l) into a running (acc, m, l) — the
    reference's cross-hop merge (``ring_attention.py:131-142``). acc
    [B, Sq, H, D] f32, m and l [B, H, Sq] f32; start from zeros, NEG_INF
    and zeros."""
    acc, m, l = state
    acc_c, m_c, l_c = part
    m_new = torch.maximum(m, m_c)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_c - m_new)
    return (acc * _bshd(alpha) + acc_c * _bshd(beta), m_new,
            l * alpha + l_c * beta)


def empty_state(q: torch.Tensor):
    """The merge's starting (acc, m, l) for queries q [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros((B, Sq, H, D), **f32),
            torch.full((B, H, Sq), NEG_INF, **f32),
            torch.zeros((B, H, Sq), **f32))


def finish(state):
    """(out [B, Sq, H, D] f32, lse [B, H, Sq] f32) of a merged state: the
    reference's final division (``ring_attention.py:164``) and the
    log-sum-exp the gradient needs."""
    acc, m, l = state
    return acc / _bshd(l.clamp(min=1e-30)), m + torch.log(l)


class RingAttentionFn(torch.autograd.Function):
    """Ring attention over ``group`` with its ring backward. ``dense``
    selects the plain chunk math (``flash_attention_partial_plain`` /
    ``flash_attention_bwd_plain``) on any device; otherwise the kernel
    wrappers run (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale, window, attn_softcap, dense):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        Sq, Sk = q.shape[1], k.shape[1]
        kw = dict(scale=scale, window=window, attn_softcap=attn_softcap)
        chunk = flash_attention_partial_plain if dense \
            else flash_attention_partial
        state = empty_state(q)
        ks, vs = k, v
        for s in range(n):
            src = (idx - s) % n          # original owner of the chunk in hand
            state = merge_partial(state, chunk(q, ks, vs, q_offset=idx * Sq,
                                               k_offset=src * Sk, **kw))
            if s < n - 1:
                ks, vs = _rotate([ks, vs], group)
        out, lse = finish(state)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.kw, ctx.dense = group, kw, dense
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        Sq, Sk = q.shape[1], k.shape[1]
        bwd = flash_attention_bwd_plain if ctx.dense else flash_attention_bwd
        dout = dout.contiguous()
        dsum = softmax_dsum(dout, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        ks, vs = k, v
        for s in range(n):
            src = (idx - s) % n
            dq_c, dk_c, dv_c = bwd(q, ks, vs, dout, lse, dsum,
                                   q_offset=idx * Sq, k_offset=src * Sk,
                                   **ctx.kw)
            dq += dq_c
            dk += dk_c
            dv += dv_c
            # The accumulators travel with their chunk; the n-th rotation
            # brings each home to its owner.
            if s < n - 1:
                ks, vs, dk, dv = _rotate([ks, vs, dk, dv], group)
            else:
                dk, dv = _rotate([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, scale: Optional[float] = None,
                   window: Optional[int] = None,
                   attn_softcap: Optional[float] = None,
                   impl: str = "auto") -> torch.Tensor:
    """Per-rank causal ring attention over the process group ``group``.

    q [B, Sq, H, D]; k, v [B, Sk, Hkv, D]: this rank's contiguous shards
    (rank i holds positions [i*Sq, (i+1)*Sq)). ``window`` (a Python int,
    None or <= 0 = global) and ``attn_softcap`` are exact. ``impl``:
    "auto" runs ``flash_attention_partial`` / ``flash_attention_bwd`` (the
    kernels on CUDA tensors, their plain versions on CPU tensors);
    "dense" runs the plain chunk math (the reference's ``chunk_dense``)
    on any device. Differentiable: every rank of the group must run its
    backward, in the same order (the ring backward exchanges chunks).
    Returns this rank's output [B, Sq, H, D] in q's type.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown ring attention impl {impl!r}; one of "
                         f"{IMPLS}")
    return RingAttentionFn.apply(q, k.contiguous(), v.contiguous(), group,
                                 scale, window, attn_softcap,
                                 impl == "dense")


class _GatherSeq(torch.autograd.Function):
    """All-gather sequence shards [B, S/n, ...] into [B, S, ...]. Every
    rank computes the same function of the gathered tensor, so the
    gradient of its own shard is its slice of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, group):
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rank, ctx.S = dist.get_rank(group), x.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        i, S = ctx.rank, ctx.S
        return g[:, i * S:(i + 1) * S], None


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, mesh, axis_name: str = "sp",
                           scale: Optional[float] = None,
                           window: Optional[int] = None,
                           attn_softcap: Optional[float] = None,
                           impl: str = "auto") -> torch.Tensor:
    """Convenience wrapper for callers holding whole sequences: every rank
    passes the same q [B, S, H, D], k, v [B, S, Hkv, D]; each runs
    ``ring_attention`` on its shard along ``axis_name`` of ``mesh`` and
    the outputs are gathered back to [B, S, H, D] on every rank. Under
    autograd a rank's q/k/v gradients cover the positions it owns (and
    every chunk's dk/dv reaches its owner): summed over the group they
    are the gradient of the whole."""
    group = mesh.get_group(axis_name)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    S = q.shape[1]
    if S % n or k.shape[1] != S:
        raise ValueError(f"sequence {S} (k {k.shape[1]}) does not shard "
                         f"over {n} ranks")
    part = slice(idx * S // n, (idx + 1) * S // n)
    out = ring_attention(q[:, part].contiguous(), k[:, part], v[:, part],
                         group=group, scale=scale, window=window,
                         attn_softcap=attn_softcap, impl=impl)
    return _GatherSeq.apply(out, group)
