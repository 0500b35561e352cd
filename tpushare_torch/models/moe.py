"""Mixture-of-Experts decoder LM in PyTorch, and its slot servers.
Counterpart of ``tpushare/models/moe.py``.

Params keep the JAX package's layout (stacked ``[L, ...]`` leaves; the
expert stacks ``w_gate``/``w_up`` [L, E, Dm, F] and ``w_down``
[L, E, F, Dm]; a full-precision ``router`` [L, Dm, E]), so weights
bridge across unchanged (``models/bridge.py``).

Ported: routing ``"psum"`` on one device, with dense dispatch (every
expert runs every token; ``capacity_factor=None``) and grouped capacity
dispatch (Switch/GShard drop semantics); ``forward``'s cache branches
(no cache, dense scalar offset, ragged rows at S = 1 and S > 1, paged
S = 1 and S > 1) with ``layers_hook`` and ``last_logit_only``;
``paged_forward`` (the ``forward_fn`` of ``paged.PagedSlotServer``);
``MoESlotServer`` (admit with the row prefix cache, chunked admission,
the fused tick, one fetch per tick, evict). Int8 expert trees served
with ``quant.fused_expert_hook(cfg)`` run their expert products through
the hand-written kernel (``ops/q8_expert.py``). Left out, each raising
``NotImplementedError`` naming its ROADMAP item: the a2a, dropless and
expert_choice routings, ``ep_axis`` / ``pctx`` / meshes, MoE
speculation, ``phase_timer``, ``generate`` and training.

Dense-row decode attends through ``mha_reference`` with the ragged mask,
exactly as the reference does (its masked read never reaches a flash
kernel); the paged branches go through ``paged_flash_decode`` /
``paged_flash_verify``. Caches are updated IN PLACE.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.models.serving import (SlotServer, bucket_len,
                                           pad_tokens, prompt_host,
                                           prompt_tensor)
from tpushare_torch.models.transformer import (TODO_MESH, _act, _paged_attn,
                                               drop_write)
from tpushare_torch.ops.attention import attention
from tpushare_torch.ops.norms import rms_norm
from tpushare_torch.ops.q8_expert import q8_expert_dispatch
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding

# ROADMAP items that port what the MoE family still leaves out.
TODO_ROUTING = "ROADMAP A8 (a2a / dropless / expert_choice routing)"
TODO_SPEC = "ROADMAP A8 (MoE speculation)"
TODO_TIMER = "ROADMAP A8 (PhaseTimer)"
TODO_GENERATE = "ROADMAP A12 (the scanned generate loop, training)"


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


def _grouped_dispatch(h, layer, cfg: MoEConfig, top_w, top_i,
                      q8: bool) -> torch.Tensor:
    """Capacity-bounded grouped expert compute: each expert runs its
    products on at most C routed tokens; results scatter-add back."""
    B, S, Dm = h.shape
    E = cfg.n_experts
    T = B * S
    C = expert_capacity(T, cfg)
    buf, wbuf = _route_buffers(top_w, top_i, T, E, C)
    hc = h.reshape(T, Dm).to(cfg.dtype)
    hpad = torch.cat([hc, hc.new_zeros((1, Dm))], dim=0)
    x_e = hpad[buf]                                    # [E, C, Dm]
    y_e = (_q8_expert_mlps(x_e.contiguous(), layer, cfg) if q8
           else _expert_mlps(x_e, layer, cfg))
    contrib = wbuf[..., None].to(y_e.dtype) * y_e
    out = y_e.new_zeros((T + 1, Dm))
    out.index_add_(0, buf.reshape(-1), contrib.reshape(-1, Dm))
    return out[:T].reshape(B, S, Dm)


def _moe_ffn(h: torch.Tensor, layer: Dict[str, torch.Tensor],
             cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert MLP. h [B, S, Dm] -> (out [B, S, Dm], aux scalar).
    A layer carrying raw ``w_gate#q8`` leaves (``fused_expert_hook``)
    runs its expert products through the int8 kernel."""
    if cfg.routing != "psum":
        raise NotImplementedError(f"routing={cfg.routing!r}: {TODO_ROUTING}")
    B, S, Dm = h.shape
    E = cfg.n_experts
    q8 = "w_gate#q8" in layer
    logits = (h @ layer["router"]).float()                   # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k_lower_index(probs, cfg.top_k)       # [B, S, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    combine = torch.zeros_like(probs).scatter_(-1, top_i, top_w)
    frac = (combine > 0).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))
    if cfg.capacity_factor is not None:
        out = _grouped_dispatch(h, layer, cfg, top_w, top_i, q8)
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
    out = torch.einsum("bse,besd->bsd", combine.to(out_e.dtype), out_e)
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
    ``paged_flash_verify`` for S > 1)."""
    for name, val, todo in (("pctx", pctx, TODO_MESH),
                            ("ep_axis", ep_axis, TODO_MESH),
                            ("data_axes", data_axes or None, TODO_MESH),
                            ("phase_timer", phase_timer, TODO_TIMER)):
        if val is not None:
            raise NotImplementedError(f"{name}: {todo}")
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
    aux_l = []
    layers = params["layers"]
    for li in range(cfg.n_layers):
        layer = {name: leaf[li] for name, leaf in layers.items()}
        if layers_hook is not None:
            layer = layers_hook(layer)
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
        h = rms_norm(x, layer["ln2"], eps=cfg.norm_eps)
        ff, aux = _moe_ffn(h, layer, cfg)
        x = x + ff
        aux_l.append(aux)
    if last_logit_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"]).to(cfg.dtype)
    logits = (x @ unembed).float()
    out = (logits, torch.stack(aux_l).mean())
    return out + (cache,) if use_cache else out


def paged_forward(params, tokens: torch.Tensor, cfg: MoEConfig, *,
                  pctx=None, cache=None, pos_offset=0,
                  attn_impl: str = "auto", layers_hook=None,
                  last_logit_only: bool = False, mlora_idx=None,
                  mlora_scale: float = 1.0):
    """``transformer.forward``-shaped adapter over the MoE LM, returning
    (logits, cache) — the ``forward_fn`` through which
    ``paged.PagedSlotServer`` serves the MoE family. Multi-LoRA is a
    dense-LM feature and raises."""
    del mlora_scale
    if mlora_idx is not None:
        raise ValueError("MoE serving has no adapter bank "
                         "(multi-LoRA is a dense-server feature)")
    out = forward(params, tokens, cfg, pctx=pctx, cache=cache,
                  pos_offset=pos_offset, attn_impl=attn_impl,
                  layers_hook=layers_hook, last_logit_only=last_logit_only)
    return (out[0], None) if cache is None else (out[0], out[2])


def generate(*a, **kw):
    raise NotImplementedError(f"moe.generate: {TODO_GENERATE}")


def lm_loss(*a, **kw):
    raise NotImplementedError(f"moe.lm_loss: {TODO_GENERATE}")


class MoESlotServer(SlotServer):
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
    A/B oracle). Speculation, meshes and ``phase_timer`` raise, naming
    their ROADMAP item."""

    def __init__(self, params, cfg: MoEConfig, *, n_slots: int,
                 max_len: int, temperature: float = 0.0, top_k=None,
                 top_p=None, seed: int = 0, attn_impl: str = "auto",
                 layers_hook=None, prefix_cache: bool = False,
                 speculative_draft=None, gamma: int = 4,
                 spec_horizon: int = 1, draft_layers_hook=None, mesh=None,
                 param_specs=None, draft_param_specs=None,
                 phase_timer=None, device: DeviceLike = None):
        del gamma, spec_horizon, draft_layers_hook
        for name, val, todo in (
                ("speculative_draft", speculative_draft, TODO_SPEC),
                ("mesh", mesh, TODO_MESH),
                ("param_specs", param_specs, TODO_MESH),
                ("draft_param_specs", draft_param_specs, TODO_MESH),
                ("phase_timer", phase_timer, TODO_TIMER)):
            if val is not None:
                raise NotImplementedError(f"{name}: {todo}")
        super().__init__(params, cfg, n_slots=n_slots, max_len=max_len,
                         attn_impl=attn_impl, layers_hook=layers_hook,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         seed=seed, device=device)
        self.speculative = False
        self.prefix_cache = prefix_cache
        self._prefix: Optional[Tuple[np.ndarray, Dict[str, Any]]] = None
        self.last_cached_len = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0

    def _family(self, kv_quant: bool):
        return paged_forward, init_cache

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
        max_len)."""
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
        self._activate(slot, self._sampler.pick(logits[:1, S - 1 - p])[0],
                       S)
        return slot

    def admit_start(self, prompt, chunk_tokens: int = 256) -> int:
        """Begin a chunked admission: reserve a slot, prefill nothing;
        drive with admit_step() (one chunk per call) or fused ticks.
        Each chunk is a prefill continuation into the slot's row, so
        chunked and whole admission write the same KV; a prefix hit
        starts the chunks at its end."""
        prompt_np = prompt_host(prompt)
        prompt = prompt_tensor(prompt_np, self.device)
        slot = self._claim_slot(prompt)
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        S = int(prompt.shape[0])
        p = self._cached_prefix_len(prompt_np)
        self._count_prefix(p, S)
        self._admissions[slot] = {
            "prompt": prompt, "prompt_np": prompt_np, "S": S, "done": p,
            "chunk": int(chunk_tokens),
            "row": self._prefix_row() if p > 0 else self._new_rows(1),
            "in_cache": False}
        return slot
