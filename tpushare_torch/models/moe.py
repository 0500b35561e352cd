"""Mixture-of-Experts decoder LM in PyTorch, and its slot servers.
Counterpart of ``tpushare/models/moe.py``.

Params keep the JAX package's layout (stacked ``[L, ...]`` leaves; the
expert stacks ``w_gate``/``w_up`` [L, E, Dm, F] and ``w_down``
[L, E, F, Dm]; a full-precision ``router`` [L, Dm, E]), so weights
bridge across unchanged (``models/bridge.py``).

Ported: every routing on one device — ``"psum"`` (and ``"a2a"``, which
without an ep axis is the same math) with dense dispatch (every expert
runs every token; ``capacity_factor=None``) or grouped capacity
dispatch (Switch/GShard drop semantics), ``"dropless"`` (assignments
sorted by expert, three grouped products, nothing dropped) and
``"expert_choice"`` (each expert takes its top-C tokens; no aux loss);
``forward``'s cache branches (no cache, dense scalar offset, ragged
rows at S = 1 and S > 1, paged S = 1 and S > 1) with ``layers_hook``,
``last_logit_only`` and ``phase_timer`` (measurement mode: a drain at
every phase mark); ``generate`` (one prefill, then ragged S = 1 decodes
in a Python loop, one device-to-host read at the end); training:
``lm_loss`` (nll + ``aux_loss_weight`` x aux), ``sgd_train_step``,
``adamw_train_step`` and their SPMD forms over a ``("dp", "sp")`` mesh
(``make_spmd_train_step``, ``make_adamw_spmd_train_step``: rows over
dp, the sequence over sp through ring attention, ``cfg.remat``
checkpointing each layer), with a gradient through every routing
(dropless's grouped products carry their own backward,
``_GroupedProducts``); ``paged_forward`` (the ``forward_fn`` of
``paged.PagedSlotServer``, its drafts' too); ``MoESlotServer`` (admit
with the row prefix cache, chunked admission, the fused tick, one fetch
per tick or round, evict, and per-slot speculation through
``spec.SpecDecodeMixin``: greedy and stochastic, the draft in its own
row cache). Int8 expert trees served with ``quant.fused_expert_hook
(cfg)`` run their expert products through the hand-written kernel
(``ops/q8_expert.py``); dropless widens them in-graph, warning once.
Serving over ep x tp (reference ``moe.py:144-164, 287-424, 554``):
``param_specs`` puts the experts over ep and each expert's hidden axis
over tp (the router and embeddings replicated; attention as the dense
model's). ``forward(ep_axis=<group>, pctx=ParallelCtx(tp=<group>))``
runs this rank's experts: every routing computes its local experts'
part of the combine, reduces the expert products over tp and the
combined output over ep; ``"a2a"`` ships the per-expert queues to the
experts' owners with ``all_to_all_single`` over ep and back, with the
tp reduction between. ``MoESlotServer(mesh=)`` serves over such a
``ServingMesh``.

Training over ep x tp (reference ``moe.py:1718-1830``): under psum,
dropless and expert_choice the batch is replicated over ep, each rank
computes its experts' part and the ep sum (f32, rounded once) is a "g"
whose gradient is the identity, while the expert input and the combine
weights enter the ep- (and tp-) split work through "f"
(``transformer.copy_to``: the backward sums their gradients over the
group), so the replicated leaves' gradients are whole and equal on
every rank. Under a2a ep is a data axis (``ep_data``, its group among
``data_axes``): the batch shards over (dp, ep) and sp (``shard_tokens``), each
rank routes all of its own tokens into queues at its own capacity, and
the two exchanges are an autograd pair (``_Exchange``: the backward is
the reverse exchange), the reference's layout, not the serving one.

Dense-row decode attends through ``mha_reference`` with the ragged mask,
exactly as the reference does (its masked read never reaches a flash
kernel); the paged branches go through ``paged_flash_decode`` /
``paged_flash_verify``. Caches are updated IN PLACE.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.models.generate import sample_logits
from tpushare_torch.models.quant import dequant_expert_leaves
from tpushare_torch.models.serving import (PendingStep, SlotServer,
                                           bucket_len, fused_chunk_span,
                                           fused_token_batch, make_placement,
                                           pad_tokens, prompt_host,
                                           prompt_tensor)
from tpushare_torch.models.spec import SpecDecodeMixin
from tpushare_torch.models import training as _training
from tpushare_torch.models.training import adamw_init
from tpushare_torch.models.transformer import (ParallelCtx, _act,
                                               _paged_attn, copy_to,
                                               drop_write, reduce_from,
                                               tp_matmul)
from tpushare_torch.ops.attention import attention
from tpushare_torch.ops.norms import rms_norm
from tpushare_torch.ops.q8_expert import q8_expert_dispatch
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding
from tpushare_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                          data_axes, data_groups)
from tpushare_torch.parallel.ring_attention import ring_attention

ROUTINGS = ("psum", "a2a", "dropless", "expert_choice")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32_000
    d_model: int = 2048
    n_layers: int = 12
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 256
    d_ff: int = 8192               # per-expert hidden dim
    n_experts: int = 8
    top_k: int = 2
    # None = dense dispatch; a float = grouped capacity dispatch.
    capacity_factor: Optional[float] = None
    routing: str = "psum"
    rope_base: float = 10_000.0
    rope_scaling: Optional[Tuple[float, float, float, float]] = None
    norm_eps: float = 1e-6
    act: str = "silu"
    aux_loss_weight: float = 0.01
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True             # checkpoint each layer when training
    # The attention the MoE LM runs is the plain softmax(q.k / sqrt(D))
    # one; the shared paged branch (transformer._paged_attn) reads these.
    attn_scale = None
    attn_softcap = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def num_params(self) -> int:
        E, Dm, Fd = self.n_experts, self.d_model, self.d_ff
        per_layer = (2 * Dm + Dm * (self.q_dim + 2 * self.kv_dim)
                     + self.q_dim * Dm + Dm * E + 3 * E * Dm * Fd)
        embed = self.vocab_size * Dm
        return (embed * (1 if self.tie_embeddings else 2)
                + self.n_layers * per_layer + Dm)


def tiny(vocab_size: int = 256, d_model: int = 64, n_layers: int = 2,
         n_heads: int = 4, n_kv_heads: int = 2, head_dim: int = 16,
         d_ff: int = 128, n_experts: int = 4, top_k: int = 2,
         **kw) -> MoEConfig:
    """Hardware-free test geometry (f32)."""
    return MoEConfig(vocab_size=vocab_size, d_model=d_model,
                     n_layers=n_layers, n_heads=n_heads,
                     n_kv_heads=n_kv_heads, head_dim=head_dim, d_ff=d_ff,
                     n_experts=n_experts, top_k=top_k, dtype=torch.float32,
                     **kw)


def init_params(gen, cfg: MoEConfig, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Truncated-normal init (in [-2, 2], divided by sqrt(fan_in)),
    stacked over layers; ``gen`` a ``torch.Generator`` on the target
    device or an int seed. Values differ from the JAX package's for the
    same seed; bridge JAX weights where parity matters."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    L, Dm, Fd, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    out = {
        "embed": dense((cfg.vocab_size, Dm), Dm),
        "layers": {
            "ln1": torch.ones((L, Dm), dtype=cfg.dtype, device=dev),
            "ln2": torch.ones((L, Dm), dtype=cfg.dtype, device=dev),
            "wq": dense((L, Dm, cfg.q_dim), Dm),
            "wk": dense((L, Dm, cfg.kv_dim), Dm),
            "wv": dense((L, Dm, cfg.kv_dim), Dm),
            "wo": dense((L, cfg.q_dim, Dm), cfg.q_dim),
            "router": dense((L, Dm, E), Dm),
            "w_gate": dense((L, E, Dm, Fd), Dm),
            "w_up": dense((L, E, Dm, Fd), Dm),
            "w_down": dense((L, E, Fd, Dm), Fd),
        },
        "final_norm": torch.ones((Dm,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = dense((Dm, cfg.vocab_size), Dm)
    return out


def param_specs(cfg: MoEConfig, *, tp: str = "tp",
                ep: str = "ep") -> Dict[str, Any]:
    """Spec tree matching ``init_params`` (reference ``:144-164``):
    experts over ep, each expert's hidden axis over tp, attention like
    the dense model; the router is replicated (every rank routes every
    token, so routing decisions agree)."""
    from tpushare_torch.parallel.sharding import P
    specs = {
        "embed": P(None, None),
        "layers": {
            "ln1": P(None, None), "ln2": P(None, None),
            "wq": P(None, None, tp), "wk": P(None, None, tp),
            "wv": P(None, None, tp), "wo": P(None, tp, None),
            "router": P(None, None, None),
            "w_gate": P(None, ep, None, tp),
            "w_up": P(None, ep, None, tp),
            "w_down": P(None, ep, tp, None),
        },
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P(None, None)
    return specs


def _local_experts(layer: Dict[str, torch.Tensor]) -> int:
    """Experts on this ep rank, off the (full or int8) expert stack."""
    return layer.get("w_gate", layer.get("w_gate#q8")).shape[0]


def init_cache(cfg: MoEConfig, batch: int, max_len: int, *,
               n_kv_heads: Optional[int] = None,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Dense KV rows {"k", "v"} [L, B, max_len, Hkv, Dh] (the
    transformer's row layout; routing keeps no decode state).
    ``n_kv_heads`` overrides the head count for tp-local rows."""
    dev = resolve_device(device)
    hkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
    shape = (cfg.n_layers, batch, max_len, hkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def expert_capacity(n_tokens: int, cfg: MoEConfig,
                    default_factor: Optional[float] = None) -> int:
    """Per-expert token capacity C = min(T, ceil(T*K/E * factor))."""
    factor = (cfg.capacity_factor if cfg.capacity_factor is not None
              else default_factor)
    if factor is None:
        raise ValueError("expert_capacity needs a capacity factor")
    return min(n_tokens, max(1, math.ceil(n_tokens * cfg.top_k
                                          / cfg.n_experts * factor)))


def top_k_lower_index(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    broken toward the LOWER index as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order among equal values): a stable
    descending sort keeps equal entries in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_buffers(top_w: torch.Tensor, top_i: torch.Tensor, T: int, E: int,
                   C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape routing queues: assignment token ids and combine
    weights scattered into [E, C] in token order (first come wins);
    overflow lands in a sacrificial row/column that is sliced off.
    Returns (buf token ids, sentinel T for empty; wbuf f32 weights)."""
    K = top_i.shape[-1]
    dev = top_i.device
    eid = top_i.reshape(T * K)
    w = top_w.reshape(T * K).float()
    tok = torch.arange(T * K, device=dev) // K
    onehot = torch.nn.functional.one_hot(eid, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos_in_e = torch.gather(pos, 1, eid[:, None])[:, 0]
    keep = pos_in_e < C
    safe_e = torch.where(keep, eid, E)
    safe_c = torch.where(keep, pos_in_e, C)
    buf = torch.full((E + 1, C + 1), T, dtype=torch.int64, device=dev)
    buf[safe_e, safe_c] = tok
    wbuf = torch.zeros((E + 1, C + 1), dtype=torch.float32, device=dev)
    wbuf[safe_e, safe_c] = w
    return buf[:E, :C], wbuf[:E, :C]


def _q8_expert_mlps(x_e: torch.Tensor, layer: Dict[str, torch.Tensor],
                    cfg: MoEConfig) -> torch.Tensor:
    """The three expert products on [E, C, Dm] queues (or one shared
    [C, Dm] block) straight off the int8 leaves: the seam where the
    fused kernel replaces the wide einsums."""
    return q8_expert_dispatch(
        x_e, layer["w_gate#q8"], layer["w_gate#scale"],
        layer["w_up#q8"], layer["w_up#scale"],
        layer["w_down#q8"], layer["w_down#scale"], act=cfg.act)


def _expert_mlps(x_e: torch.Tensor, layer, cfg: MoEConfig) -> torch.Tensor:
    """Full-precision expert products on [E, C, Dm] queues."""
    gate = torch.einsum("ecd,edf->ecf", x_e, layer["w_gate"])
    up = torch.einsum("ecd,edf->ecf", x_e, layer["w_up"])
    return torch.einsum("ecf,efd->ecd", _act(cfg.act, gate) * up,
                        layer["w_down"])


_Q8_ROUTING_WARNED = set()


def _q8_routing_warn(routing: str) -> None:
    """Warn once per routing that int8 expert leaves widen in-graph
    (``dequant_hook`` math) because the fused kernel does not cover its
    dispatch."""
    if routing in _Q8_ROUTING_WARNED:
        return
    _Q8_ROUTING_WARNED.add(routing)
    warnings.warn(
        f"fused int8 expert path does not cover routing={routing!r}; "
        f"expert weights widen in-graph (dequant_hook semantics) for "
        f"this dispatch", RuntimeWarning, stacklevel=3)


def _ep_sum_dtype(y: torch.Tensor, ep) -> torch.dtype:
    """The accumulator of a combined output: under ep, f32, so the ep
    sum rounds once, where one card's scatter-add rounds each of a
    token's (at most top-k) bf16 contributions into its sum — the same
    value (f32 holds a sum of two bf16 terms exactly)."""
    return torch.float32 if ep is not None else y.dtype


def _expert_input(h: torch.Tensor, tp, ep) -> torch.Tensor:
    """The expert products' input, replicated over tp and (but under
    a2a) ep, entering work split over both: "f" over each group, so its
    gradient, each rank's part, is summed back into a whole one."""
    return copy_to(copy_to(h, tp), ep)


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` over the group of a tensor whose dim 0 is
    the destination rank (after it: the source rank). The exchange is
    its own inverse, so the backward sends each gradient block back to
    where its rows came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def _ep_slice(t: torch.Tensor, ep, E_local: int, dim: int = 0
              ) -> torch.Tensor:
    """This ep rank's expert block of ``t`` along ``dim`` (all of it
    without an ep group)."""
    if ep is None:
        return t
    return t.narrow(dim, dist.get_rank(ep) * E_local, E_local)


def _grouped_dispatch(h, layer, cfg: MoEConfig, top_w, top_i,
                      q8: bool, phase_timer=None, tp=None,
                      ep=None) -> torch.Tensor:
    """Capacity-bounded grouped expert compute: each expert runs its
    products on at most C routed tokens; results scatter-add back.
    Under ep each rank runs its own experts' queues; the products
    reduce over tp, the scattered output over ep."""
    B, S, Dm = h.shape
    E = cfg.n_experts
    T = B * S
    C = expert_capacity(T, cfg)
    pt = phase_timer
    buf, wbuf = _route_buffers(copy_to(top_w, ep), top_i, T, E, C)
    E_local = _local_experts(layer)
    buf, wbuf = _ep_slice(buf, ep, E_local), _ep_slice(wbuf, ep, E_local)
    hc = _expert_input(h.reshape(T, Dm).to(cfg.dtype), tp, ep)
    hpad = torch.cat([hc, hc.new_zeros((1, Dm))], dim=0)
    x_e = hpad[buf]                                    # [E, C, Dm]
    if pt is not None:
        pt.mark("dispatch", block_on=x_e)
    y_e = reduce_from(_q8_expert_mlps(x_e.contiguous(), layer, cfg) if q8
                      else _expert_mlps(x_e, layer, cfg), tp)
    if pt is not None:
        pt.mark("expert_gemm", block_on=y_e)
    contrib = wbuf[..., None].to(y_e.dtype) * y_e
    out = y_e.new_zeros((T + 1, Dm), dtype=_ep_sum_dtype(y_e, ep))
    out.index_add_(0, buf.reshape(-1), contrib.reshape(-1, Dm).to(out.dtype))
    out = reduce_from(out[:T].contiguous(), ep).to(y_e.dtype)
    if pt is not None:
        pt.mark("dispatch", block_on=out)
    return out.reshape(B, S, Dm)


def _a2a_dispatch(h, layer, cfg: MoEConfig, top_w, top_i, q8: bool,
                  tp, ep) -> torch.Tensor:
    """GShard token routing over the ep group, ep a data axis as in the
    reference (``:375-424``): this rank routes its own contiguous share
    of the T tokens (ceil(T / ep) rows; a server hands every ep rank all
    T) into per-expert queues [E, C], C the capacity of one share (per
    source rank and expert: drops are decided within a share, in token
    order, as the reference's). One ``all_to_all_single`` ships each
    queue to the rank owning its expert, the experts run on [E_local,
    ep * C] received tokens (their products reduced over tp), a second
    exchange returns the outputs for the share's scatter-add, and one
    all-gather over ep hands every rank all T rows. No ep reduction:
    both top-k contributions of a token come back through its own
    queues."""
    B, S, Dm = h.shape
    E = cfg.n_experts
    E_local = _local_experts(layer)
    n_ep = E // E_local
    T = B * S
    share = -(-T // n_ep)
    lo = min(dist.get_rank(ep) * share, T)
    n = min(lo + share, T) - lo                 # this share's tokens
    K = top_i.shape[-1]
    C = expert_capacity(share, cfg)
    buf, wbuf = _route_buffers(top_w.reshape(T, K)[lo:lo + n],
                               top_i.reshape(T, K)[lo:lo + n], n, E, C)
    hc = h.reshape(T, Dm)[lo:lo + n].to(cfg.dtype)
    hpad = torch.cat([hc, hc.new_zeros((1, Dm))], dim=0)
    # dim 0 = destination rank; after the exchange dim 0 = source rank.
    x_send = hpad[buf].reshape(n_ep, E_local, C, Dm).contiguous()
    x_recv = torch.empty_like(x_send)
    dist.all_to_all_single(x_recv, x_send, group=ep)
    xe = x_recv.transpose(0, 1).reshape(E_local, n_ep * C, Dm).contiguous()
    y = reduce_from(_q8_expert_mlps(xe, layer, cfg) if q8
                    else _expert_mlps(xe, layer, cfg), tp)
    # Inverse exchange: outputs return to their source rank, arriving
    # rank-major over expert owners == the [E, C] queue order.
    y = y.reshape(E_local, n_ep, C, Dm).transpose(0, 1).contiguous()
    y_ret = torch.empty_like(y)
    dist.all_to_all_single(y_ret, y, group=ep)
    y_ret = y_ret.reshape(E, C, Dm)
    # Empty queue slots (token n, a zero row, weight 0) add zeros at row
    # n; the rows past this share's tokens stay zero.
    out = y_ret.new_zeros((share + 1, Dm))
    out.index_add_(0, buf.reshape(-1),
                   (wbuf[..., None].to(y_ret.dtype) * y_ret).reshape(-1, Dm))
    rows = [torch.empty_like(out[:share]) for _ in range(n_ep)]
    dist.all_gather(rows, out[:share].contiguous(), group=ep)
    return torch.cat(rows)[:T].reshape(B, S, Dm)


def _a2a_train_dispatch(h, layer, cfg: MoEConfig, top_w, top_i, q8: bool,
                        tp, ep) -> torch.Tensor:
    """GShard token routing with ep a data axis, the reference's layout
    (``moe.py:375-424``): h holds this rank's own tokens, all T of them
    routed into per-expert queues [E, C] at C = capacity(T); an exchange
    ships each queue to its expert's owner, the experts run on [E_local,
    ep * C] received rows (the expert hidden split over tp: "f" on the
    rows, "g" on the products), the reverse exchange returns the
    outputs for the local scatter-add. Both exchanges are differentiable
    (``_Exchange``), so an expert's gradient holds every ep rank's
    tokens' part."""
    B, S, Dm = h.shape
    E = cfg.n_experts
    E_local = _local_experts(layer)
    n_ep = E // E_local
    T = B * S
    C = expert_capacity(T, cfg)
    buf, wbuf = _route_buffers(top_w, top_i, T, E, C)
    hc = h.reshape(T, Dm).to(cfg.dtype)
    hpad = torch.cat([hc, hc.new_zeros((1, Dm))], dim=0)
    x_recv = _Exchange.apply(hpad[buf].reshape(n_ep, E_local, C, Dm), ep)
    xe = x_recv.transpose(0, 1).reshape(E_local, n_ep * C, Dm)
    xe = copy_to(xe.contiguous(), tp)
    y = reduce_from(_q8_expert_mlps(xe, layer, cfg) if q8
                    else _expert_mlps(xe, layer, cfg), tp)
    y = y.reshape(E_local, n_ep, C, Dm).transpose(0, 1)
    y_ret = _Exchange.apply(y, ep).reshape(E, C, Dm)
    out = y_ret.new_zeros((T + 1, Dm))
    out.index_add_(0, buf.reshape(-1),
                   (wbuf[..., None].to(y_ret.dtype) * y_ret).reshape(-1, Dm))
    return out[:T].reshape(B, S, Dm)


def _grouped_mm_fits(x: torch.Tensor, w: torch.Tensor) -> bool:
    """``torch._grouped_mm`` takes these operands: bf16 on the card (any
    dtype on the CPU), and rows of both 16-byte aligned."""
    return (not x.is_cuda or x.dtype == torch.bfloat16) and all(
        n * x.element_size() % 16 == 0 for n in (x.shape[-1], w.shape[-1]))


def _per_expert_products(x: torch.Tensor, w: torch.Tensor,
                         e_s: torch.Tensor) -> torch.Tensor:
    """The grouped product as one product per expert, kept only on that
    expert's rows: E times the work, but no group boundary reaches the
    host. Its one purpose is the operands ``torch._grouped_mm`` does not
    take (``_grouped_mm_fits``); it is also the grouped GEMM's plain
    version."""
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    for e in range(w.shape[0]):
        out = torch.where((e_s == e)[:, None], x @ w[e], out)
    return out


class _GroupedProducts(torch.autograd.Function):
    """``torch._grouped_mm(x, w, offs)`` with its gradient as grouped
    GEMMs too: dx = g @ w[e]^T per group, and dw[e] = x_e^T @ g_e, the
    contraction over each group's rows (an empty group's dw is zero)."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return torch._grouped_mm(x, w, offs=offs)

    @staticmethod
    def backward(ctx, g):
        x, w, offs = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch._grouped_mm(g, w.transpose(-2, -1), offs=offs)
        if ctx.needs_input_grad[1]:
            dw = torch._grouped_mm(x.t(), g, offs=offs)
        return dx, dw, None


def _grouped_products(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                      e_s: torch.Tensor) -> torch.Tensor:
    """[A, K] rows sorted by expert (group g ends at ``offs[g]``; ``e_s``
    each row's expert) times the expert stack ``w`` [E, K, N] -> [A, N]:
    each row multiplies its own expert's matrix, once. One grouped GEMM
    (``torch._grouped_mm``, differentiable through
    ``_GroupedProducts``) where it takes the operands, else
    ``_per_expert_products``."""
    if _grouped_mm_fits(x, w):
        return _GroupedProducts.apply(x, w, offs)
    return _per_expert_products(x, w, e_s)


def _dropless_dispatch(h, layer, cfg: MoEConfig, top_w,
                       top_i, tp=None, ep=None) -> torch.Tensor:
    """Exact MoE over grouped products: the (token, expert) assignments
    sorted by expert (stable, so token order holds within an expert),
    the three expert products as grouped GEMMs over the per-expert
    groups, a weighted scatter-add back. Every pair computes exactly
    once; nothing is dropped. The group ends come from a device-side
    ``searchsorted`` over the sorted expert ids: no size is read on the
    host (the tick keeps its one fetch). Under ep a rank runs the
    assignments of its own experts: the others keep their place in the
    sort with a zero row and a zero weight (their products are zero,
    bias-free), so no count reaches the host either; the products
    reduce over tp, the output over ep."""
    B, S, Dm = h.shape
    E = _local_experts(layer)
    T = B * S
    K = top_i.shape[-1]
    A = T * K
    dev = h.device
    eid = top_i.reshape(A)
    w = copy_to(top_w, ep).reshape(A).float()
    tok = torch.arange(A, device=dev) // K
    keep = None
    if ep is not None:
        eid = eid - dist.get_rank(ep) * E
        keep = (eid >= 0) & (eid < E)
        eid = torch.clamp(eid, 0, E - 1)
        w = torch.where(keep, w, torch.zeros_like(w))
    order = torch.argsort(eid, stable=True)
    tok_s, w_s, e_s = tok[order], w[order], eid[order]
    offs = torch.searchsorted(e_s, torch.arange(1, E + 1, device=dev)
                              ).to(torch.int32)
    x = _expert_input(h.reshape(T, Dm).to(cfg.dtype), tp, ep)[tok_s]
    if keep is not None:
        x = torch.where(keep[order][:, None], x, torch.zeros_like(x))
    gate = _grouped_products(x, layer["w_gate"], offs, e_s)
    up = _grouped_products(x, layer["w_up"], offs, e_s)
    y = _grouped_products(_act(cfg.act, gate) * up, layer["w_down"], offs,
                          e_s)                            # [A, Dm]
    y = reduce_from(y, tp)
    out = y.new_zeros((T, Dm), dtype=_ep_sum_dtype(y, ep))
    out.index_add_(0, tok_s, (w_s[:, None].to(y.dtype) * y).to(out.dtype))
    return reduce_from(out, ep).to(y.dtype).reshape(B, S, Dm)


def _expert_choice_dispatch(h, layer, cfg: MoEConfig, probs: torch.Tensor,
                            q8: bool, tp=None, ep=None) -> torch.Tensor:
    """Expert-choice routing (Zhou et al.): each expert takes the C =
    ceil(T K / E) tokens (factor 1.0 unless the config sets one) with
    its highest router scores, ties to the lower token index as
    ``lax.top_k`` breaks them; a token can be picked by zero or many
    experts. The same expert products as the capacity path on [E, C]
    queues (the int8 kernel with ``#q8`` leaves), weighted by the score,
    scatter-added back."""
    B, S, Dm = h.shape
    E = cfg.n_experts
    T = B * S
    C = expert_capacity(T, cfg, default_factor=1.0)
    w_e, idx_e = top_k_lower_index(probs.reshape(T, E).T, C)   # [E, C]
    E_local = _local_experts(layer)
    w_e = _ep_slice(copy_to(w_e, ep), ep, E_local)
    idx_e = _ep_slice(idx_e, ep, E_local)
    x_e = _expert_input(h.reshape(T, Dm).to(cfg.dtype), tp, ep)[idx_e]
    y_e = reduce_from(_q8_expert_mlps(x_e.contiguous(), layer, cfg) if q8
                      else _expert_mlps(x_e, layer, cfg), tp)
    contrib = w_e[..., None].to(y_e.dtype) * y_e
    out = y_e.new_zeros((T, Dm), dtype=_ep_sum_dtype(y_e, ep))
    out.index_add_(0, idx_e.reshape(-1), contrib.reshape(-1, Dm).to(out.dtype))
    return reduce_from(out, ep).to(y_e.dtype).reshape(B, S, Dm)


def _group_mean(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` averaged over each process group in ``groups`` in turn (the
    reference's pmean over each data axis); no gradient flows through
    the exchange."""
    for g in groups:
        t = t.clone()
        dist.all_reduce(t, group=g)
        t = t / dist.get_world_size(g)
    return t


def _moe_ffn(h: torch.Tensor, layer: Dict[str, torch.Tensor],
             cfg: MoEConfig, phase_timer=None, data_axes=(), tp=None,
             ep=None, ep_data: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert MLP. h [B, S, Dm] -> (out [B, S, Dm], aux scalar).
    A layer carrying raw ``w_gate#q8`` leaves (``fused_expert_hook``)
    runs its expert products through the int8 kernel, except under
    dropless, whose grouped products take wide weights (widened here,
    with a warning). ``phase_timer`` marks router / dispatch /
    expert_gemm at the reference's points (measurement mode only).

    ``data_axes`` (process groups the batch is sharded over): the Switch
    aux loss E * sum_e frac(e) * mean_prob(e) is nonlinear in the data,
    so the reference averages both statistics over the data axes before
    the product. Here the routed fractions (no gradient) are averaged
    over the groups and multiply this rank's mean probabilities: the
    mean of the ranks' aux values is the global aux, and the mean of
    their gradients (what the SPMD steps take) is its gradient.

    ``tp`` / ``ep``: the tensor- and expert-parallel process groups this
    rank's expert slices (``param_specs``) are split over. ``ep_data``:
    ep is a data axis (a2a training): each ep rank routes its own
    tokens, the reference's layout; else a server's, every ep rank
    holding all T tokens."""
    B, S, Dm = h.shape
    E = cfg.n_experts
    pt = phase_timer
    q8 = "w_gate#q8" in layer
    if q8 and cfg.routing == "dropless":
        _q8_routing_warn(cfg.routing)
        layer = dequant_expert_leaves(layer, cfg.dtype)
        q8 = False
    logits = (h @ layer["router"]).float()                   # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    if cfg.routing == "expert_choice":
        # Experts pick their tokens: balanced by construction, so the
        # Switch aux loss does not exist for this routing.
        if pt is not None:
            pt.mark("router", block_on=probs)
        out = _expert_choice_dispatch(h, layer, cfg, probs, q8, tp, ep)
        if pt is not None:
            pt.mark("expert_gemm", block_on=out)
        return out.to(h.dtype), torch.zeros((), dtype=torch.float32,
                                            device=h.device)
    top_w, top_i = top_k_lower_index(probs, cfg.top_k)       # [B, S, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    combine = torch.zeros_like(probs).scatter(-1, top_i, top_w)
    frac = (combine > 0).float().mean(dim=(0, 1))
    if data_axes:
        frac = _group_mean(frac.detach(), data_axes)
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))
    if pt is not None:
        pt.mark("router", block_on=(combine, top_w, top_i, aux))
    if cfg.routing not in ROUTINGS:
        raise ValueError(
            f"unknown routing {cfg.routing!r}; expected 'psum', 'a2a', "
            "'dropless', or 'expert_choice'")
    if cfg.routing == "dropless":
        out = _dropless_dispatch(h, layer, cfg, top_w, top_i, tp, ep)
        if pt is not None:
            pt.mark("expert_gemm", block_on=out)
        return out.to(h.dtype), aux
    if cfg.routing == "a2a" and ep is not None:
        if cfg.capacity_factor is None:
            raise ValueError("routing='a2a' requires capacity_factor")
        dispatch = _a2a_train_dispatch if ep_data else _a2a_dispatch
        out = dispatch(h, layer, cfg, top_w, top_i, q8, tp, ep)
        if pt is not None:
            pt.mark("expert_gemm", block_on=out)
        return out.to(h.dtype), aux
    # "psum", and "a2a" on one card (no ep axis: the same math).
    if cfg.capacity_factor is not None:
        out = _grouped_dispatch(h, layer, cfg, top_w, top_i, q8,
                                phase_timer=pt, tp=tp, ep=ep)
        return out.to(h.dtype), aux
    E_local = _local_experts(layer)
    combine = _ep_slice(copy_to(combine, ep), ep, E_local, dim=2)
    hc = _expert_input(h.to(cfg.dtype), tp, ep)
    if q8:
        # Every expert runs the whole token block: ONE shared [T, Dm]
        # block goes to the kernel, never an [E, T, Dm] broadcast.
        y = _q8_expert_mlps(hc.reshape(B * S, Dm).contiguous(), layer, cfg)
        out_e = y.reshape(E_local, B, S, Dm).permute(1, 0, 2, 3)
    else:
        gate = torch.einsum("bsd,edf->besf", hc, layer["w_gate"])
        up = torch.einsum("bsd,edf->besf", hc, layer["w_up"])
        out_e = torch.einsum("besf,efd->besd", _act(cfg.act, gate) * up,
                             layer["w_down"])
    out_e = reduce_from(out_e.contiguous(), tp) if tp is not None \
        else out_e
    if pt is not None:
        pt.mark("expert_gemm", block_on=out_e)
    # Under ep the local experts' combine sums in f32 and the ep sum
    # rounds once, as one card's single product over every expert does.
    acc = _ep_sum_dtype(out_e, ep)
    out = reduce_from(torch.einsum(
        "bse,besd->bsd", combine.to(out_e.dtype).to(acc), out_e.to(acc)),
        ep).to(out_e.dtype)
    if pt is not None:
        pt.mark("dispatch", block_on=out)
    return out.to(h.dtype), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig, *,
            pctx=None, ep_axis=None, data_axes=(), ep_data: bool = False,
            attn_impl: str = "auto",
            cache: Optional[Dict[str, torch.Tensor]] = None, pos_offset=0,
            layers_hook=None, last_logit_only: bool = False,
            phase_timer=None):
    """tokens [B, S] -> (logits [B, S, V] f32, aux scalar), plus the
    cache as a third element when ``cache`` is given.

    Cache branches (the transformer's contract): dense rows with an int
    ``pos_offset`` (prefill continuation, start clamped as
    ``dynamic_update_slice`` clamps; attention through the flash kernel
    wrapper); dense rows with a [B] int32 ``pos_offset`` (ragged: token
    j of row b at pos[b] + j, writes past max_len dropped; attention
    through ``mha_reference`` with the ragged mask, as in the
    reference); a paged cache {"pool_k", "pool_v", "table", "active"}
    with [B] offsets (writes routed to the trash block when inactive,
    unallocated or past capacity; ``paged_flash_decode`` for S = 1,
    ``paged_flash_verify`` for S > 1).

    ``phase_timer`` (``utils.profiling.PhaseTimer``) is MEASUREMENT
    MODE ONLY: each phase — embed / dequant (hook) / attn / router /
    dispatch / expert_gemm / kv_stack / unembed, the reference's marks —
    closes with a drain of the card, exactly the syncs the serving tick
    must never make. None (the default) adds nothing to any path.

    Training (no cache): under ``pctx.sp`` (a process group) tokens are
    this rank's sequence shard, positions start at rank * S and
    attention is ring attention over the group (its dense chunk math
    with attn_impl "reference"); ``data_axes`` names the process groups
    the batch is sharded over (``_moe_ffn``'s aux statistics). With
    ``cfg.remat``, grad mode on, no cache and no timer, each layer runs
    under ``torch.utils.checkpoint``.

    Over a mesh: ``ep_axis`` (the ep process group) and ``pctx.tp`` (the
    tp group) with this rank's ``param_specs`` slices, serving or, with
    grad mode on, training (the module docstring); ``ep_data`` makes ep
    a data axis (a2a training), its group then among ``data_axes``."""
    pctx = pctx or ParallelCtx()
    data_axes = tuple(data_axes or ())
    pt = phase_timer
    B, S = tokens.shape
    Dh = cfg.head_dim
    dev = tokens.device
    use_cache = cache is not None
    paged = use_cache and "pool_k" in cache
    ragged = use_cache and isinstance(pos_offset, torch.Tensor)
    if paged and not ragged:
        raise ValueError("paged cache requires ragged decode (pos [B])")
    if use_cache and "k_scale" in cache or paged and "pool_k_scale" in cache:
        raise ValueError("MoE caches hold no int8 KV (a dense-LM feature)")
    if ragged:
        pos = pos_offset
        positions = pos[:, None] + torch.arange(S, device=dev)[None, :]
    else:
        if not isinstance(pos_offset, int):
            raise TypeError("scalar pos_offset must be a Python int")
        positions = (pos_offset + torch.arange(S, device=dev))[None, :]
        if pctx.sp is not None:
            positions = positions + dist.get_rank(pctx.sp) * S
    positions = positions.expand(B, S)
    cos, sin = rotary_embedding(positions, Dh, base=cfg.rope_base,
                                scaling=cfg.rope_scaling)
    active = None
    if paged:
        active = cache.get("active")
        if active is None:
            active = torch.ones((B,), dtype=torch.bool, device=dev)

    x = params["embed"][tokens.long()].to(cfg.dtype)
    if pt is not None:
        pt.mark("embed", block_on=(x, cos, sin))
    aux_l = []
    layers = params["layers"]

    def block(x, li):
        layer = {name: leaf[li] for name, leaf in layers.items()}
        if layers_hook is not None:
            layer = layers_hook(layer)
            if pt is not None:
                pt.mark("dequant", block_on=layer)
        h = copy_to(rms_norm(x, layer["ln1"], eps=cfg.norm_eps), pctx.tp)
        H = layer["wq"].shape[-1] // Dh
        Hkv = layer["wk"].shape[-1] // Dh
        q = apply_rotary((h @ layer["wq"]).reshape(B, S, H, Dh), cos, sin)
        k = apply_rotary((h @ layer["wk"]).reshape(B, S, Hkv, Dh), cos, sin)
        v = (h @ layer["wv"]).reshape(B, S, Hkv, Dh)
        if paged:
            attn = _paged_attn(q, k, v, cache["pool_k"][li],
                               cache["pool_v"][li], None, None, cache, pos,
                               active, None, cfg, attn_impl)
        elif ragged:
            lk, lv = cache["k"][li], cache["v"][li]
            drop_write(lk, positions, k)
            drop_write(lv, positions, v)
            k_pos = torch.arange(lk.shape[1], device=dev)[None, None, :]
            attn = attention(q, lk, lv, causal=False,
                             kv_mask=k_pos <= positions[..., None],
                             impl="reference")
        elif use_cache:
            lk, lv = cache["k"][li], cache["v"][li]
            start = min(max(pos_offset, 0), lk.shape[1] - S)
            lk[:, start:start + S] = k.to(lk.dtype)
            lv[:, start:start + S] = v.to(lv.dtype)
            attn = attention(q, lk, lv, causal=True, q_offset=pos_offset,
                             impl=attn_impl)
        elif pctx.sp is not None:
            attn = ring_attention(
                q, k, v, group=pctx.sp,
                impl="dense" if attn_impl == "reference" else "auto")
        else:
            attn = attention(q, k, v, causal=True, impl=attn_impl)
        x = x + tp_matmul(attn.reshape(B, S, H * Dh), layer["wo"], pctx.tp)
        if pt is not None:
            pt.mark("attn", block_on=x)
        h = rms_norm(x, layer["ln2"], eps=cfg.norm_eps)
        ff, aux = _moe_ffn(h, layer, cfg, phase_timer=pt,
                           data_axes=data_axes, tp=pctx.tp, ep=ep_axis,
                           ep_data=ep_data)
        return x + ff, aux

    # The model has no randomness, so the recompute needs no RNG state.
    remat = (cfg.remat and not use_cache and pt is None
             and torch.is_grad_enabled())
    for li in range(cfg.n_layers):
        if remat:
            x, aux = checkpoint(block, x, li, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = block(x, li)
        aux_l.append(aux)
    if pt is not None and use_cache:
        # The reference re-stacks its per-layer caches here; the port
        # writes them in place, so the span holds only their drain.
        pt.mark("kv_stack", block_on=cache)
    if last_logit_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"]).to(cfg.dtype)
    logits = x @ unembed
    if pt is not None:
        pt.mark("unembed", block_on=logits)
    out = (logits.float(), torch.stack(aux_l).mean())
    return out + (cache,) if use_cache else out


def paged_forward(params, tokens: torch.Tensor, cfg: MoEConfig, *,
                  pctx=None, ep_axis=None, cache=None, pos_offset=0,
                  attn_impl: str = "auto", layers_hook=None,
                  last_logit_only: bool = False, mlora_idx=None,
                  mlora_scale: float = 1.0, phase_timer=None):
    """``transformer.forward``-shaped adapter over the MoE LM, returning
    (logits, cache) — the ``forward_fn`` through which
    ``paged.PagedSlotServer`` serves the MoE family (its drafts too).
    Multi-LoRA is a dense-LM feature and raises. ``phase_timer`` passes
    through to ``forward`` (``MoESlotServer``'s measurement mode), and
    so do ``pctx`` and ``ep_axis`` (a sharded server's groups)."""
    del mlora_scale
    if mlora_idx is not None:
        raise ValueError("MoE serving has no adapter bank "
                         "(multi-LoRA is a dense-server feature)")
    out = forward(params, tokens, cfg, pctx=pctx, ep_axis=ep_axis,
                  cache=cache, pos_offset=pos_offset, attn_impl=attn_impl,
                  layers_hook=layers_hook, last_logit_only=last_logit_only,
                  phase_timer=phase_timer)
    return (out[0], None) if cache is None else (out[0], out[2])


def decode_phase_bytes(cfg: MoEConfig, params: Dict[str, Any],
                       kv_tokens: int) -> Dict[str, int]:
    """Per-phase bytes that MUST move between HBM and the SMs for one
    decode step — the phase-level roofline denominators that
    ``utils.profiling.phase_roofline`` pairs with a ``PhaseTimer``
    snapshot (keys: the phases ``forward``'s ``phase_timer`` marks:
    embed, dequant, attn, router, dispatch, expert_gemm, kv_stack,
    unembed). Splits the same total the
    aggregate share uses (params streamed once + live KV read): weights
    are charged to the phase that streams them AT THEIR STORED WIDTH
    (``k#q8`` + ``k#scale`` when quantized: a phase running far below
    the int8 floor pays for a wide copy the floor does not include).
    Pure-overhead phases (embed, dequant, dispatch, kv_stack — no
    mandatory weight traffic at decode activation sizes) carry 0.

    ``kv_tokens`` = total live KV positions across the batch (sum of
    lengths); a KV row is K and V of one position, one layer, at
    ``cfg.dtype``'s width."""
    layers = params["layers"]

    def _stored(keys) -> int:
        total = 0
        for k in keys:
            for kk in (k, k + "#q8", k + "#scale"):
                if kk in layers:
                    t = layers[kk]
                    total += t.numel() * t.element_size()
        return total

    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * cfg.dtype.itemsize
    unembed = (params["embed"] if cfg.tie_embeddings
               else params["unembed"])
    norm = params["final_norm"]
    return {
        "embed": 0,
        "dequant": 0,
        "attn": (_stored(("ln1", "wq", "wk", "wv", "wo"))
                 + kv_tokens * cfg.n_layers * kv_row),
        "router": _stored(("ln2", "router")),
        "dispatch": 0,
        "expert_gemm": _stored(("w_gate", "w_up", "w_down")),
        "kv_stack": 0,
        "unembed": (unembed.numel() * unembed.element_size()
                    + norm.numel() * norm.element_size()),
    }


def generate(params, tokens: torch.Tensor, cfg: MoEConfig, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             attn_impl: str = "auto", layers_hook=None) -> torch.Tensor:
    """tokens [B, S] -> [B, S + max_new_tokens]: one prefill into a row
    cache of S + max_new_tokens (``last_logit_only``), then ragged S = 1
    decodes at each row's offset, as the reference's scan does (the
    routing is recomputed per token; KV rows are the whole cache). The
    picks stay on the device: nothing is read back until the caller
    reads the result. Temperature 0 is greedy; otherwise
    ``sample_logits``' filters apply, drawing from ``generator``."""
    B, S = tokens.shape
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    with torch.no_grad():
        cache = init_cache(cfg, B, S + max_new_tokens, device=tokens.device)
        logits, _, cache = forward(params, tokens, cfg, cache=cache,
                                   pos_offset=0, attn_impl=attn_impl,
                                   layers_hook=layers_hook,
                                   last_logit_only=True)

        def pick(lg):
            return sample_logits(lg, generator, temperature=temperature,
                                 top_k=top_k, top_p=top_p).to(tokens.dtype)

        out = torch.empty((B, max_new_tokens), dtype=tokens.dtype,
                          device=tokens.device)
        last = pick(logits[:, -1])
        for i in range(max_new_tokens):
            out[:, i] = last
            if i + 1 == max_new_tokens:
                break
            pos = torch.full((B,), S + i, dtype=torch.int32,
                             device=tokens.device)
            lg, _, cache = forward(params, last[:, None], cfg, cache=cache,
                                   pos_offset=pos, attn_impl=attn_impl,
                                   layers_hook=layers_hook)
            last = pick(lg[:, 0])
    return torch.cat([tokens, out], dim=1)


def xent_loss(params, inputs: torch.Tensor, targets: torch.Tensor,
              cfg: MoEConfig, *, pctx=None, ep_axis=None, data_axes=(),
              ep_data: bool = False, attn_impl: str = "auto"
              ) -> torch.Tensor:
    """Mean cross-entropy of forward(inputs) against aligned ``targets``
    (both [B, S]) plus ``aux_loss_weight`` x the mean aux loss over
    layers. Under ``data_axes`` this is this rank's term; the SPMD steps
    average the ranks' terms (and gradients) into the global loss
    (``_moe_ffn``)."""
    logits, aux = forward(params, inputs, cfg, pctx=pctx, ep_axis=ep_axis,
                          data_axes=data_axes, ep_data=ep_data,
                          attn_impl=attn_impl)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])
    return nll.mean() + cfg.aux_loss_weight * aux


def lm_loss(params, tokens: torch.Tensor, cfg: MoEConfig, *, pctx=None,
            ep_axis=None, data_axes=(), ep_data: bool = False,
            attn_impl: str = "auto") -> torch.Tensor:
    """``xent_loss`` over the next-token shift of tokens [B, S+1]."""
    return xent_loss(params, tokens[:, :-1], tokens[:, 1:], cfg, pctx=pctx,
                     ep_axis=ep_axis, data_axes=data_axes, ep_data=ep_data,
                     attn_impl=attn_impl)


def _ep_data(cfg: MoEConfig) -> bool:
    """ep is a data axis under a2a (reference ``moe.py:1769-1771``)."""
    return cfg.routing == "a2a"


def shard_tokens(tokens: torch.Tensor, mesh, ep: bool = False
                 ) -> torch.Tensor:
    """This rank's block of tokens [B, S+1]: rows over ``dp`` (over
    (dp, ep) jointly with ``ep``, dp outermost), columns over ``sp``, as
    the reference's MoE steps shard them (``P("dp", "sp")``, or
    ``P(("dp", "ep"), "sp")`` under a2a, on the tokens themselves). Each
    shard then takes its own next-token shift, so the pair across a
    shard boundary is not trained, as in the reference (the dense steps
    shift first, ``training.shard_batch``)."""
    B, S1 = tokens.shape
    n_ep = axis_size(mesh, "ep") if ep else 1
    dp, sp = axis_size(mesh, "dp") * n_ep, axis_size(mesh, "sp")
    if B % dp or S1 % sp:
        raise ValueError(f"tokens [{B}, {S1}] do not shard over dp={dp}, "
                         f"sp={sp}")
    i = axis_rank(mesh, "dp") * n_ep + (axis_rank(mesh, "ep") if ep else 0)
    j = axis_rank(mesh, "sp")
    return tokens[i * B // dp:(i + 1) * B // dp,
                  j * S1 // sp:(j + 1) * S1 // sp].contiguous()


def shard_pairs(tokens: torch.Tensor, mesh, ep: bool = False):
    """(inputs, targets) of this rank's ``shard_tokens`` block: the
    ``shard_fn`` of the MoE SPMD steps."""
    local = shard_tokens(tokens, mesh, ep)
    return local[:, :-1], local[:, 1:]


# The single-device steps are training.py's with this module's loss;
# the SPMD steps its ``SpmdStep`` with this module's loss, specs and
# sharding over a dp x sp x ep x tp mesh.
sgd_train_step = functools.partial(_training.sgd_train_step,
                                   loss_fn=xent_loss)
adamw_train_step = functools.partial(_training.adamw_train_step,
                                     loss_fn=xent_loss)


def _spmd_step(cfg: MoEConfig, mesh, **kw):
    """The MoE SpmdStep over ``mesh`` (reference ``moe.py:1755-1830``):
    experts over ep, expert hidden and attention over tp
    (``param_specs``); the batch over (dp, sp), or ((dp, ep), sp) under
    a2a, whose aux statistics, loss and gradients average over those
    data axes."""
    if cfg.n_experts % axis_size(mesh, "ep"):
        raise ValueError(f"ep={axis_size(mesh, 'ep')} must divide "
                         f"n_experts={cfg.n_experts}")
    if axis_size(mesh, "fsdp") > 1:
        raise NotImplementedError(
            "use make_fsdp_train_step for the manual-fsdp schedule, or "
            "pjit auto sharding with param_specs(fsdp='fsdp')")
    _training._reject_axes(mesh, ("pp",))
    ep = _ep_data(cfg)
    return _training.SpmdStep(
        cfg, mesh, pctx=ParallelCtx(tp=axis_group(mesh, "tp"),
                                    sp=axis_group(mesh, "sp")),
        specs=param_specs(cfg), axes=data_axes(ep), loss_fn=xent_loss,
        shard_fn=functools.partial(shard_pairs, ep=ep),
        loss_kw={"ep_axis": axis_group(mesh, "ep"), "ep_data": ep,
                 "data_axes": data_groups(mesh, ep)}, **kw)


def make_spmd_train_step(cfg: MoEConfig, mesh, *, lr: float = 1e-3):
    """The SGD step over ``mesh``: step(params, tokens [B, S+1]) ->
    (params, global loss), params this rank's slices
    (``step.shard``)."""
    return _spmd_step(cfg, mesh, lr=lr)


def make_adamw_spmd_train_step(cfg: MoEConfig, mesh, *, lr: float = 1e-3,
                               weight_decay: float = 0.0):
    """(step, opt_init): AdamW over ``mesh``, laid out as
    ``make_spmd_train_step``, and ``training.adamw_init`` (of a rank's
    slices: the moments shard like the params), as the reference
    returns its sharded initializer beside the step."""
    return _spmd_step(cfg, mesh, lr=lr, adamw=True,
                      weight_decay=weight_decay), adamw_init


class MoESlotServer(SpecDecodeMixin, SlotServer):
    """Continuous batching for the MoE LM over one static row cache
    (``init_cache``): ``serving.SlotServer``'s admit / step / evict with
    ragged decode, the fused tick and one device-to-host transfer per
    tick, over the MoE forward.

    ``prefix_cache`` is the row-level variant: ONE retained (prompt,
    row) from the most recent admission; a new admit copies the longest
    common prefix's KV and prefills only the suffix (whole and chunked
    admits both consult it). The retained row is never written in place
    (a hit prefills into a copy), the port's form of the reference's
    immutable rows. ``layers_hook=quant.fused_expert_hook(cfg)`` serves
    an int8 ``quantize_params`` tree through the fused expert kernel;
    ``quant.dequant_hook(cfg)`` widens every leaf instead (the reference
    A/B oracle).

    ``speculative_draft=(params, cfg)``: per-slot speculation on the
    shared seam (``spec.SpecDecodeMixin``): the draft (its own
    ``draft_layers_hook``; ``(quantize_params(p), cfg)`` with
    ``fused_expert_hook`` is int8-self) proposes gamma x horizon tokens
    from its own row cache, ONE ragged multi-token verify scores every
    slot's block, each slot accepts its own prefix (greedy, or the
    stochastic rule at temperature > 0). Whole admissions prefill the
    draft's row whole (``last_logit_only``), chunked ones chunk it
    beside the target's, fused ticks write it in one draft forward;
    the draft's KV never rides the prefix registry. Near ``max_len``
    the server falls back to plain ticks that still write the draft's
    row. ``phase_timer``: measurement mode (``forward``'s marks; each
    tick opens the chain). ``mesh`` (a bound ``ServingMesh``, reference
    ``moe.py:1040-1090``): the target per ``param_specs`` (default
    ``param_specs(cfg)``; int8 trees ``quant.quant_moe_param_specs``),
    the draft per ``draft_param_specs`` with its own placement, rows of
    this rank's kv heads."""

    def __init__(self, params, cfg: MoEConfig, *, n_slots: int,
                 max_len: int, temperature: float = 0.0, top_k=None,
                 top_p=None, seed: int = 0, attn_impl: str = "auto",
                 layers_hook=None, prefix_cache: bool = False,
                 speculative_draft=None, gamma: int = 4,
                 spec_horizon: int = 1, draft_layers_hook=None, mesh=None,
                 param_specs=None, draft_param_specs=None,
                 phase_timer=None, device: DeviceLike = None):
        super().__init__(params, cfg, n_slots=n_slots, max_len=max_len,
                         attn_impl=attn_impl, layers_hook=layers_hook,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         seed=seed, mesh=mesh, param_specs=param_specs,
                         device=device)
        cfg = self.cfg
        self._draft_forward = paged_forward
        self.phase_timer = phase_timer
        self.prefix_cache = prefix_cache
        self._prefix: Optional[Tuple[np.ndarray, Dict[str, Any]]] = None
        self.last_cached_len = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0
        self.speculative = speculative_draft is not None
        self.gamma = gamma
        self.spec_horizon = spec_horizon
        if self.speculative:
            self._spec_init(gamma=gamma, spec_horizon=spec_horizon,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p)
            self.draft_params, self.draft_cfg = speculative_draft
            if self.draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a "
                                 "vocabulary")
            dplace = make_placement(mesh, self.draft_cfg,
                                    draft_param_specs, role="draft")
            if dplace is not None:
                self.draft_params = dplace.place_params(self.draft_params)
                self.draft_cfg = dplace.local_cfg(self.draft_cfg)
                self._draft_forward = dplace.forward_fn(paged_forward)
            self.draft_layers_hook = draft_layers_hook
            self.dcache = init_cache(self.draft_cfg, n_slots, max_len,
                                     device=self.device)

    def _family(self, kv_quant: bool):
        return paged_forward, init_cache

    def _fwd(self, tokens, **kw):
        if self.phase_timer is not None:
            kw["phase_timer"] = self.phase_timer
        return super()._fwd(tokens, **kw)

    def _dfwd(self, tokens, **kw):
        """The draft's forward; draft calls that need no logits pass
        ``last_logit_only`` (the [B, S, V] unembed is the prefill's
        largest tensor)."""
        return self._draft_forward(self.draft_params, tokens,
                                   self.draft_cfg, attn_impl=self.attn_impl,
                                   layers_hook=self.draft_layers_hook, **kw)

    def _retain(self, prompt_np: np.ndarray, row) -> None:
        """Keep (prompt, row) as the prefix registry's one entry; a
        view of the shared cache is copied first, so later ticks on
        that slot cannot change it."""
        self._prefix = (prompt_np, {kk: v.clone() for kk, v in row.items()})

    def _admitted(self, slot: int, st: Dict[str, Any], row) -> None:
        if not self.prefix_cache:
            return
        if st["in_cache"]:
            self._retain(st["prompt_np"], self._slot_row(slot))
        else:
            self._prefix = (st["prompt_np"], row)   # private: kept as is

    def _install_draft(self, slot: int, drow) -> None:
        for kk in self.dcache:
            self.dcache[kk][:, slot] = drow[kk][:, 0]

    def _slot_drow(self, slot: int) -> Dict[str, torch.Tensor]:
        return {kk: v[:, slot:slot + 1] for kk, v in self.dcache.items()}

    def _cached_prefix_len(self, prompt_np: np.ndarray) -> int:
        """Longest common prefix with the retained prompt, capped at S-1
        (the admit must still forward the final token)."""
        if not self.prefix_cache or self._prefix is None:
            return 0
        cp, _ = self._prefix
        m = min(len(cp), len(prompt_np) - 1)
        if m <= 0:
            return 0
        neq = np.nonzero(cp[:m] != prompt_np[:m])[0]
        return int(neq[0]) if neq.size else m

    def _prefix_row(self):
        """A private copy of the retained row (the registry's row is
        never written)."""
        return {kk: v.clone() for kk, v in self._prefix[1].items()}

    def _count_prefix(self, p: int, S: int) -> None:
        self.last_cached_len = p
        if self.prefix_cache:
            self.prefix_hit_tokens += p
            self.prefix_prompt_tokens += S

    def admit(self, prompt) -> int:
        """Prefill ``prompt`` [S] into a free slot; returns the slot.
        The prompt zero-pads to its power-of-two bucket; with
        ``prefix_cache`` the longest common prefix with the retained row
        is reused and only the suffix prefills (its width keeps its
        bucket: the reuse shrinks when the padded end would pass
        max_len). A speculative server prefills the draft's row whole."""
        prompt_np = prompt_host(prompt)
        prompt = prompt_tensor(prompt_np, self.device)
        slot = self._claim_slot(prompt)
        S = int(prompt.shape[0])
        p = self._cached_prefix_len(prompt_np)
        if p > 0:
            width = bucket_len(S - p)
            if p + width > self.max_len:
                p = max(0, self.max_len - width)
        if p > 0:
            row = self._prefix_row()
        else:
            row = self._new_rows(1)
            width = min(bucket_len(S), self.max_len)
        logits, _ = self._fwd(pad_tokens(prompt, p, S, width), cache=row,
                              pos_offset=p)
        self._count_prefix(p, S)
        if self.prefix_cache:
            self._prefix = (prompt_np, row)     # private: kept as is
        self._install(slot, row)
        if self.speculative:
            drow = init_cache(self.draft_cfg, 1, self.max_len,
                              device=self.device)
            self._dfwd(pad_tokens(prompt, 0, S, min(bucket_len(S),
                                                    self.max_len)),
                       cache=drow, pos_offset=0, last_logit_only=True)
            self._install_draft(slot, drow)
        self._activate(slot, self._sampler.pick(logits[:1, S - 1 - p])[0],
                       S)
        return slot

    def admit_start(self, prompt, chunk_tokens: int = 256) -> int:
        """Begin a chunked admission: reserve a slot, prefill nothing;
        drive with admit_step() (one chunk per call) or fused ticks.
        Each chunk is a prefill continuation into the slot's row, so
        chunked and whole admission write the same KV; a prefix hit
        starts the chunks at its end. A speculative server chunks the
        draft's row beside it, from position 0."""
        prompt_np = prompt_host(prompt)
        prompt = prompt_tensor(prompt_np, self.device)
        slot = self._claim_slot(prompt)
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        S = int(prompt.shape[0])
        p = self._cached_prefix_len(prompt_np)
        self._count_prefix(p, S)
        st = {"prompt": prompt, "prompt_np": prompt_np, "S": S, "done": p,
              "chunk": int(chunk_tokens),
              "row": self._prefix_row() if p > 0 else self._new_rows(1),
              "in_cache": False}
        if self.speculative:
            st.update(drow=init_cache(self.draft_cfg, 1, self.max_len,
                                      device=self.device),
                      ddone=0, din_cache=False)
        self._admissions[slot] = st
        return slot

    def _draft_chunk(self, st, row, max_chunk_tokens=None) -> int:
        """One draft prefill chunk [ddone, end) into ``row`` (no
        logits); returns end."""
        done = st["ddone"]
        end, width = self._chunk_span(st["S"], done, st["chunk"],
                                      max_chunk_tokens)
        self._dfwd(pad_tokens(st["prompt"], done, end, width), cache=row,
                   pos_offset=done, last_logit_only=True)
        return end

    def admit_step(self, slot: int,
                   max_chunk_tokens: Optional[int] = None) -> Optional[int]:
        """Prefill the next chunk of a started admission: one target
        chunk and, when speculating, one draft chunk per call (capped at
        ``max_chunk_tokens``). Returns None while either side has chunks
        left; the final call installs the rows, samples the first token
        (one fetch), activates the slot and returns that token."""
        if not self.speculative:
            return super().admit_step(slot, max_chunk_tokens)
        st = self._admissions.get(slot)
        if st is None:
            raise ValueError(f"slot {slot} has no in-flight admission "
                             f"(already completed, evicted, or admitted "
                             f"whole)")
        S = st["S"]
        if st["done"] < S:
            row = self._slot_row(slot) if st["in_cache"] else st["row"]
            last, st["done"] = self._chunk_forward(st, row,
                                                   max_chunk_tokens)
            if st["in_cache"]:
                # The in-cache admission's length tracks its write
                # frontier (a tick's junk write lands where the next
                # chunk overwrites it).
                self._set_length(slot, st["done"])
            if last is not None:
                st["last"] = last
        if st["ddone"] < S:
            drow = self._slot_drow(slot) if st["din_cache"] else st["drow"]
            st["ddone"] = self._draft_chunk(st, drow, max_chunk_tokens)
        if st["done"] < S or st["ddone"] < S:
            return None
        del self._admissions[slot]
        self._admitted(slot, st, None if st["in_cache"] else st["row"])
        if not st["in_cache"]:
            self._install(slot, st["row"])
        if not st["din_cache"]:
            self._install_draft(slot, st["drow"])
        nxt = self._sampler.pick(st["last"])[0]
        self._activate(slot, nxt, S)
        self.device_fetches += 1
        return int(nxt.item())  # tpushare: ignore[TS103] the one token fetch

    def step_async(self, prefill_work: Optional[int] = None,
                   max_chunk_tokens: Optional[int] = None) -> PendingStep:
        """One tick with its fetch deferred. A speculative server runs a
        round whenever every active slot has room for the whole
        gamma x horizon block (read off the host lengths); near max_len
        it runs a plain tick that first writes the pending tokens' KV
        into the draft's row (a skipped write would leave a hole every
        later draft step attends). Ticks carrying a fused chunk are
        plain."""
        if self.phase_timer is not None:
            self.phase_timer.start()
        if prefill_work is None and self.speculative and self.active.any():
            if (self._lengths_np[self.active] + self.spec_block_len + 1
                    <= self.max_len).all():
                return self._spec_step_async()
            self._dfwd(self.last_token, cache=self.dcache,
                       pos_offset=self.lengths, last_logit_only=True)
        return super().step_async(prefill_work, max_chunk_tokens)

    def _fused_tick_async(self, slot: int,
                          max_chunk_tokens: Optional[int]) -> PendingStep:
        """The fused tick. Speculating, the target's chunk and the
        draft's run separately sized (a prefix hit leaves the draft
        behind): one target forward (decode rows + the target's chunk,
        or plain decode once the target is done) and one draft forward
        (decode rows' mirror + the draft's chunk), one fetch."""
        if not self.speculative:
            return super()._fused_tick_async(slot, max_chunk_tokens)
        st = self._admissions.get(slot)
        if st is None:
            raise ValueError(f"slot {slot} has no in-flight admission")
        if not self.active.any():
            tok = self.admit_step(slot, max_chunk_tokens=max_chunk_tokens)
            return PendingStep.done({} if tok is None else {slot: tok})
        S, chunk, done = st["S"], st["chunk"], st["done"]
        t_end = t_width = d_end = d_width = 0
        if done < S:
            t_end, t_width = fused_chunk_span(done, S, chunk,
                                              max_chunk_tokens)
        if st["ddone"] < S:
            d_end, d_width = fused_chunk_span(st["ddone"], S, chunk,
                                              max_chunk_tokens)
        if t_width == 0 and d_width == 0:
            return self.step_async()    # budget left no chunk room
        if t_width:
            if not st["in_cache"]:
                # First fused chunk: the admission's [0, done) KV moves
                # from its serial row into the shared cache row.
                self._install(slot, st["row"])
                st["row"], st["in_cache"] = None, True
            toks = fused_token_batch(self.last_token, st["prompt"], done,
                                     t_end, t_width, slot)
            pos = self.lengths.clone()
            pos[slot] = done
            logits, _ = self._fwd(toks, cache=self.cache, pos_offset=pos)
            st["done"] = t_end
            if t_end >= S:
                st["last"] = logits[slot:slot + 1, S - 1 - done]
        else:
            logits, _ = self._fwd(self.last_token, cache=self.cache,
                                  pos_offset=self.lengths)
        if d_width:
            if not st["din_cache"]:
                self._install_draft(slot, st["drow"])
                st["drow"], st["din_cache"] = None, True
            dtoks = fused_token_batch(self.last_token, st["prompt"],
                                      st["ddone"], d_end, d_width, slot)
            dpos = self.lengths.clone()
            dpos[slot] = st["ddone"]
            self._dfwd(dtoks, cache=self.dcache, pos_offset=dpos,
                       last_logit_only=True)
            st["ddone"] = d_end
        else:
            self._dfwd(self.last_token, cache=self.dcache,
                       pos_offset=self.lengths, last_logit_only=True)
        final = st["done"] >= S and st["ddone"] >= S
        if final:
            # Admission pick before the decode pick, as the reference.
            first = self._sampler.pick(st["last"])
        nxt = self._sampler.pick(logits[:, 0])
        self._advance(nxt)
        self._lengths_np[self.active] += 1
        decode_slots = [int(s) for s in np.nonzero(self.active)[0]]
        self._retire(decode_slots)
        fetch = nxt
        if final:
            del self._admissions[slot]
            # A side that never ran a fused chunk still holds its KV in
            # the admission row.
            if not st["in_cache"]:
                self._install(slot, st["row"])
            if not st["din_cache"]:
                self._install_draft(slot, st["drow"])
            if self.prefix_cache:
                self._retain(st["prompt_np"], self._slot_row(slot))
            self._set_length(slot, S)
            self.last_token[slot, 0] = first[0]
            self.active[slot] = True
            fetch = torch.cat([nxt, first])            # one transfer
        elif st["in_cache"]:
            self._set_length(slot, st["done"])
        self._sync_active()
        out_slots = decode_slots + ([slot] if final else [])

        def _finalize(invalid):
            self.device_fetches += 1
            toks_h = fetch.tolist()  # tpushare: ignore[TS103] the one token fetch
            out: Dict[int, int] = {s: toks_h[s] for s in decode_slots
                                   if s not in invalid}
            if final and slot not in invalid:
                out[slot] = toks_h[-1]
            return out

        return PendingStep(_finalize, slots=out_slots)

    # -- speculation hooks (spec.SpecDecodeMixin owns the round loop;
    # these supply the dense-row mechanics) ------------------------------

    def _spec_begin(self, h: int) -> torch.Tensor:
        """Rows need no capacity prep: step_async's room check already
        holds every active slot's whole block below max_len."""
        return self.lengths

    def _spec_draft_step(self, tok, base, j: int) -> torch.Tensor:
        """One draft decode, every slot batched, at base + j."""
        dl, _ = self._dfwd(tok, cache=self.dcache, pos_offset=base + j)
        return dl[:, 0]

    def _spec_draft_catchup(self, block, tok, base, h: int) -> None:
        """One multi-token draft write of the round's block fills
        position base + h (the proposal loop wrote only its inputs);
        its rewrites of [base, base + h) are the same values."""
        self._dfwd(block, cache=self.dcache, pos_offset=base,
                   last_logit_only=True)

    def _spec_verify(self, block, base) -> torch.Tensor:
        """ONE ragged multi-token verify for the whole batch."""
        tl, _ = self._fwd(block, cache=self.cache, pos_offset=base)
        return tl

    def _spec_commit(self, a_b, correction, active) -> None:
        self.lengths = self.lengths + ((a_b + 1) * active).to(
            self.lengths.dtype)
        self.last_token = torch.where(active[:, None], correction,
                                      self.last_token)

    def _spec_host_lengths(self) -> np.ndarray:
        return self._lengths_np

    def _spec_capacity(self) -> int:
        return self.max_len
