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
every phase mark); ``paged_forward`` (the ``forward_fn`` of
``paged.PagedSlotServer``, its drafts' too); ``MoESlotServer`` (admit
with the row prefix cache, chunked admission, the fused tick, one fetch
per tick or round, evict, and per-slot speculation through
``spec.SpecDecodeMixin``: greedy and stochastic, the draft in its own
row cache). Int8 expert trees served with ``quant.fused_expert_hook
(cfg)`` run their expert products through the hand-written kernel
(``ops/q8_expert.py``); dropless widens them in-graph, warning once.
Left out, each raising ``NotImplementedError`` naming its ROADMAP item:
``ep_axis`` / ``pctx`` / meshes (a2a over an ep axis among them),
``generate`` and training.

Dense-row decode attends through ``mha_reference`` with the ragged mask,
exactly as the reference does (its masked read never reaches a flash
kernel); the paged branches go through ``paged_flash_decode`` /
``paged_flash_verify``. Caches are updated IN PLACE.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.models.quant import dequant_expert_leaves
from tpushare_torch.models.serving import (PendingStep, SlotServer,
                                           bucket_len, fused_chunk_span,
                                           fused_token_batch, pad_tokens,
                                           prompt_host, prompt_tensor)
from tpushare_torch.models.spec import SpecDecodeMixin
from tpushare_torch.models.transformer import (TODO_MESH, _act, _paged_attn,
                                               drop_write)
from tpushare_torch.ops.attention import attention
from tpushare_torch.ops.norms import rms_norm
from tpushare_torch.ops.q8_expert import q8_expert_dispatch
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding

# ROADMAP items that port what the MoE family still leaves out.
TODO_GENERATE = "ROADMAP A12 (the scanned generate loop, training)"
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
    remat: bool = True             # kept for config parity; no training
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


def init_cache(cfg: MoEConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Dense KV rows {"k", "v"} [L, B, max_len, Hkv, Dh] (the
    transformer's row layout; routing keeps no decode state)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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


def _grouped_dispatch(h, layer, cfg: MoEConfig, top_w, top_i,
                      q8: bool, phase_timer=None) -> torch.Tensor:
    """Capacity-bounded grouped expert compute: each expert runs its
    products on at most C routed tokens; results scatter-add back."""
    B, S, Dm = h.shape
    E = cfg.n_experts
    T = B * S
    C = expert_capacity(T, cfg)
    pt = phase_timer
    buf, wbuf = _route_buffers(top_w, top_i, T, E, C)
    hc = h.reshape(T, Dm).to(cfg.dtype)
    hpad = torch.cat([hc, hc.new_zeros((1, Dm))], dim=0)
    x_e = hpad[buf]                                    # [E, C, Dm]
    if pt is not None:
        pt.mark("dispatch", block_on=x_e)
    y_e = (_q8_expert_mlps(x_e.contiguous(), layer, cfg) if q8
           else _expert_mlps(x_e, layer, cfg))
    if pt is not None:
        pt.mark("expert_gemm", block_on=y_e)
    contrib = wbuf[..., None].to(y_e.dtype) * y_e
    out = y_e.new_zeros((T + 1, Dm))
    out.index_add_(0, buf.reshape(-1), contrib.reshape(-1, Dm))
    if pt is not None:
        pt.mark("dispatch", block_on=out)
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


def _grouped_products(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                      e_s: torch.Tensor) -> torch.Tensor:
    """[A, K] rows sorted by expert (group g ends at ``offs[g]``; ``e_s``
    each row's expert) times the expert stack ``w`` [E, K, N] -> [A, N]:
    each row multiplies its own expert's matrix, once. One grouped GEMM
    (``torch._grouped_mm``) where it takes the operands, else
    ``_per_expert_products``."""
    if _grouped_mm_fits(x, w):
        return torch._grouped_mm(x, w, offs=offs)
    return _per_expert_products(x, w, e_s)


def _dropless_dispatch(h, layer, cfg: MoEConfig, top_w,
                       top_i) -> torch.Tensor:
    """Exact MoE over grouped products: the (token, expert) assignments
    sorted by expert (stable, so token order holds within an expert),
    the three expert products as grouped GEMMs over the per-expert
    groups, a weighted scatter-add back. Every pair computes exactly
    once; nothing is dropped. The group ends come from a device-side
    ``searchsorted`` over the sorted expert ids: no size is read on the
    host (the tick keeps its one fetch)."""
    B, S, Dm = h.shape
    E = cfg.n_experts
    T = B * S
    K = top_i.shape[-1]
    A = T * K
    dev = h.device
    eid = top_i.reshape(A)
    w = top_w.reshape(A).float()
    tok = torch.arange(A, device=dev) // K
    order = torch.argsort(eid, stable=True)
    tok_s, w_s, e_s = tok[order], w[order], eid[order]
    offs = torch.searchsorted(e_s, torch.arange(1, E + 1, device=dev)
                              ).to(torch.int32)
    x = h.reshape(T, Dm).to(cfg.dtype)[tok_s]            # [A, Dm] sorted
    gate = _grouped_products(x, layer["w_gate"], offs, e_s)
    up = _grouped_products(x, layer["w_up"], offs, e_s)
    y = _grouped_products(_act(cfg.act, gate) * up, layer["w_down"], offs,
                          e_s)                            # [A, Dm]
    out = y.new_zeros((T, Dm))
    out.index_add_(0, tok_s, w_s[:, None].to(y.dtype) * y)
    return out.reshape(B, S, Dm)


def _expert_choice_dispatch(h, layer, cfg: MoEConfig, probs: torch.Tensor,
                            q8: bool) -> torch.Tensor:
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
    x_e = h.reshape(T, Dm).to(cfg.dtype)[idx_e]                 # [E, C, Dm]
    y_e = (_q8_expert_mlps(x_e.contiguous(), layer, cfg) if q8
           else _expert_mlps(x_e, layer, cfg))
    contrib = w_e[..., None].to(y_e.dtype) * y_e
    out = y_e.new_zeros((T, Dm))
    out.index_add_(0, idx_e.reshape(-1), contrib.reshape(-1, Dm))
    return out.reshape(B, S, Dm)


def _moe_ffn(h: torch.Tensor, layer: Dict[str, torch.Tensor],
             cfg: MoEConfig, phase_timer=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert MLP. h [B, S, Dm] -> (out [B, S, Dm], aux scalar).
    A layer carrying raw ``w_gate#q8`` leaves (``fused_expert_hook``)
    runs its expert products through the int8 kernel, except under
    dropless, whose grouped products take wide weights (widened here,
    with a warning). ``phase_timer`` marks router / dispatch /
    expert_gemm at the reference's points (measurement mode only)."""
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
        out = _expert_choice_dispatch(h, layer, cfg, probs, q8)
        if pt is not None:
            pt.mark("expert_gemm", block_on=out)
        return out.to(h.dtype), torch.zeros((), dtype=torch.float32,
                                            device=h.device)
    top_w, top_i = top_k_lower_index(probs, cfg.top_k)       # [B, S, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    combine = torch.zeros_like(probs).scatter_(-1, top_i, top_w)
    frac = (combine > 0).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))
    if pt is not None:
        pt.mark("router", block_on=(combine, top_w, top_i, aux))
    if cfg.routing not in ROUTINGS:
        raise ValueError(
            f"unknown routing {cfg.routing!r}; expected 'psum', 'a2a', "
            "'dropless', or 'expert_choice'")
    if cfg.routing == "dropless":
        out = _dropless_dispatch(h, layer, cfg, top_w, top_i)
        if pt is not None:
            pt.mark("expert_gemm", block_on=out)
        return out.to(h.dtype), aux
    # "psum", and "a2a" on one card (no ep axis: the same math).
    if cfg.capacity_factor is not None:
        out = _grouped_dispatch(h, layer, cfg, top_w, top_i, q8,
                                phase_timer=pt)
        return out.to(h.dtype), aux
    hc = h.to(cfg.dtype)
    if q8:
        # Every expert runs the whole token block: ONE shared [T, Dm]
        # block goes to the kernel, never an [E, T, Dm] broadcast.
        y = _q8_expert_mlps(hc.reshape(B * S, Dm).contiguous(), layer, cfg)
        out_e = y.reshape(E, B, S, Dm).permute(1, 0, 2, 3)
    else:
        gate = torch.einsum("bsd,edf->besf", hc, layer["w_gate"])
        up = torch.einsum("bsd,edf->besf", hc, layer["w_up"])
        out_e = torch.einsum("besf,efd->besd", _act(cfg.act, gate) * up,
                             layer["w_down"])
    if pt is not None:
        pt.mark("expert_gemm", block_on=out_e)
    out = torch.einsum("bse,besd->bsd", combine.to(out_e.dtype), out_e)
    if pt is not None:
        pt.mark("dispatch", block_on=out)
    return out.to(h.dtype), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig, *,
            pctx=None, ep_axis=None, data_axes=(), attn_impl: str = "auto",
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
    must never make. None (the default) adds nothing to any path."""
    for name, val in (("pctx", pctx), ("ep_axis", ep_axis),
                      ("data_axes", data_axes or None)):
        if val is not None:
            raise NotImplementedError(f"{name}: {TODO_MESH}")
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
    for li in range(cfg.n_layers):
        layer = {name: leaf[li] for name, leaf in layers.items()}
        if layers_hook is not None:
            layer = layers_hook(layer)
            if pt is not None:
                pt.mark("dequant", block_on=layer)
        h = rms_norm(x, layer["ln1"], eps=cfg.norm_eps)
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
        else:
            attn = attention(q, k, v, causal=True, impl=attn_impl)
        x = x + attn.reshape(B, S, H * Dh) @ layer["wo"]
        if pt is not None:
            pt.mark("attn", block_on=x)
        h = rms_norm(x, layer["ln2"], eps=cfg.norm_eps)
        ff, aux = _moe_ffn(h, layer, cfg, phase_timer=pt)
        x = x + ff
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
                  pctx=None, cache=None, pos_offset=0,
                  attn_impl: str = "auto", layers_hook=None,
                  last_logit_only: bool = False, mlora_idx=None,
                  mlora_scale: float = 1.0, phase_timer=None):
    """``transformer.forward``-shaped adapter over the MoE LM, returning
    (logits, cache) — the ``forward_fn`` through which
    ``paged.PagedSlotServer`` serves the MoE family (its drafts too).
    Multi-LoRA is a dense-LM feature and raises. ``phase_timer`` passes
    through to ``forward`` (``MoESlotServer``'s measurement mode)."""
    del mlora_scale
    if mlora_idx is not None:
        raise ValueError("MoE serving has no adapter bank "
                         "(multi-LoRA is a dense-server feature)")
    out = forward(params, tokens, cfg, pctx=pctx, cache=cache,
                  pos_offset=pos_offset, attn_impl=attn_impl,
                  layers_hook=layers_hook, last_logit_only=last_logit_only,
                  phase_timer=phase_timer)
    return (out[0], None) if cache is None else (out[0], out[2])


def generate(*a, **kw):
    raise NotImplementedError(f"moe.generate: {TODO_GENERATE}")


def lm_loss(*a, **kw):
    raise NotImplementedError(f"moe.lm_loss: {TODO_GENERATE}")


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
    tick opens the chain). Meshes raise, naming their ROADMAP item."""

    def __init__(self, params, cfg: MoEConfig, *, n_slots: int,
                 max_len: int, temperature: float = 0.0, top_k=None,
                 top_p=None, seed: int = 0, attn_impl: str = "auto",
                 layers_hook=None, prefix_cache: bool = False,
                 speculative_draft=None, gamma: int = 4,
                 spec_horizon: int = 1, draft_layers_hook=None, mesh=None,
                 param_specs=None, draft_param_specs=None,
                 phase_timer=None, device: DeviceLike = None):
        for name, val in (("mesh", mesh), ("param_specs", param_specs),
                          ("draft_param_specs", draft_param_specs)):
            if val is not None:
                raise NotImplementedError(f"{name}: {TODO_MESH}")
        super().__init__(params, cfg, n_slots=n_slots, max_len=max_len,
                         attn_impl=attn_impl, layers_hook=layers_hook,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         seed=seed, device=device)
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
        return paged_forward(self.draft_params, tokens, self.draft_cfg,
                             attn_impl=self.attn_impl,
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
        return int(nxt.item())

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
            toks_h = fetch.tolist()
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
