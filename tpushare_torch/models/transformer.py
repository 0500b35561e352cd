"""Decoder-only transformer LM — the flagship workload family, in PyTorch.
Counterpart of ``tpushare/models/transformer.py``.

Params keep the JAX package's layout so weights bridge across
unchanged (``models/bridge.py``): a dict of stacked per-layer tensors
([L, ...]), matmuls as ``x @ W`` with W [in, out]. The JAX ``lax.scan``
over layers is a Python loop over the stacked leaves; there is no jit —
PyTorch runs eagerly.

``forward`` ports three cache branches of the reference: no cache
(training / plain prefill), the dense scalar-offset branch (admission
prefill into a row cache, reference ``transformer.py:608-633``) and the
paged S=1 decode branch (reference ``:459-533``). The other branches
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
Caches are updated IN PLACE (the JAX version returns new arrays and
donates the old pools); ``forward`` returns the same cache dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.ops.attention import attention, window_keep
from tpushare_torch.ops.flash_attention import paged_flash_decode
from tpushare_torch.ops.norms import rms_norm
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding

# ROADMAP items that port what this slice leaves out.
TODO_BRANCHES = "ROADMAP A3 (forward: every cache branch)"
TODO_INT8_KV = "ROADMAP A3 (int8 KV helpers)"
TODO_INT8_WEIGHTS = "ROADMAP A6 (int8 weights / layers_hook)"
TODO_LORA = "ROADMAP A9 (multi-LoRA)"
TODO_MESH = "ROADMAP A10 (multi-GPU serving)"


def layer_windows(cfg: "TransformerConfig") -> Optional[List[int]]:
    """Per-layer sliding-window spans (0 = global), or None when the
    config has none — the Gemma-2 alternation rule (every other layer
    local). Python ints: the kernels take the window as a launch
    argument, so no device value is ever read back."""
    if cfg.sliding_window is None:
        return None
    return [cfg.sliding_window if (not cfg.alternate_sliding or l % 2 == 0)
            else 0 for l in range(cfg.n_layers)]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 2048
    n_layers: int = 18
    n_heads: int = 8
    n_kv_heads: int = 1
    head_dim: int = 256
    d_ff: int = 16_384
    rope_base: float = 10_000.0
    # Llama-3 long-context rope scaling: (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings) or None.
    rope_scaling: Optional[Tuple[float, float, float, float]] = None
    norm_eps: float = 1e-6
    norm_offset: float = 0.0      # 1.0 = Gemma's (1+w) RMSNorm
    act: str = "silu"             # "silu" (Llama) | "gelu" (Gemma)
    tie_embeddings: bool = True
    embed_scale: bool = False     # Gemma multiplies embeddings by sqrt(d_model)
    attn_scale: Optional[float] = None  # None -> 1/sqrt(head_dim)
    sliding_window: Optional[int] = None   # local-attention span
    alternate_sliding: bool = False        # Gemma-2: every other layer local
    attn_softcap: Optional[float] = None   # cap*tanh(logits/cap) in attention
    final_softcap: Optional[float] = None  # same on the LM-head logits
    post_norms: bool = False      # Gemma-2 sandwich norms on sublayer outputs
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True            # kept for config parity; no training yet

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def num_params(self) -> int:
        per_layer = (2 * self.d_model
                     + self.d_model * (self.q_dim + 2 * self.kv_dim)
                     + self.q_dim * self.d_model
                     + 3 * self.d_model * self.d_ff)
        embed = self.vocab_size * self.d_model
        return (embed * (1 if self.tie_embeddings else 2)
                + self.n_layers * per_layer + self.d_model)


def gemma_2b() -> TransformerConfig:
    """Gemma-2B geometry (the BASELINE.md whole-chip workload)."""
    return TransformerConfig(
        vocab_size=256_128, d_model=2048, n_layers=18, n_heads=8,
        n_kv_heads=1, head_dim=256, d_ff=16_384, act="gelu",
        norm_offset=1.0, embed_scale=True, tie_embeddings=True)


def gemma2_2b() -> TransformerConfig:
    """Gemma-2-2B geometry: alternating local/global attention with
    logit softcaps."""
    return TransformerConfig(
        vocab_size=256_128, d_model=2304, n_layers=26, n_heads=8,
        n_kv_heads=4, head_dim=256, d_ff=9216, act="gelu",
        norm_offset=1.0, embed_scale=True, tie_embeddings=True,
        attn_scale=256 ** -0.5, sliding_window=4096,
        alternate_sliding=True, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True)


def llama3_8b() -> TransformerConfig:
    """Llama-3-8B geometry (the BASELINE.md multi-chip serving workload)."""
    return TransformerConfig(
        vocab_size=128_256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14_336, act="silu",
        rope_base=500_000.0, tie_embeddings=False)


def tiny(vocab_size: int = 512, d_model: int = 128, n_layers: int = 2,
         n_heads: int = 4, n_kv_heads: int = 2, head_dim: int = 32,
         d_ff: int = 256, **kw) -> TransformerConfig:
    """Hardware-free test geometry (f32)."""
    return TransformerConfig(
        vocab_size=vocab_size, d_model=d_model, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        d_ff=d_ff, dtype=torch.float32, **kw)


def init_params(gen, cfg: TransformerConfig, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Truncated-normal init (in [-2, 2], divided by sqrt(fan_in)),
    stacked over layers. ``gen`` is a ``torch.Generator`` on the target
    device, or an int seed for one. The values differ from the JAX
    package's for the same seed (different generators); load JAX
    weights with ``bridge.params_from_jax`` where parity matters."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    L, Dm, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff

    def dense(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    def norm(shape):
        fill = 0.0 if cfg.norm_offset else 1.0
        return torch.full(shape, fill, dtype=cfg.dtype, device=dev)

    params = {
        "embed": dense((cfg.vocab_size, Dm), Dm),
        "layers": {
            "ln1": norm((L, Dm)),
            "ln2": norm((L, Dm)),
            "wq": dense((L, Dm, cfg.q_dim), Dm),
            "wk": dense((L, Dm, cfg.kv_dim), Dm),
            "wv": dense((L, Dm, cfg.kv_dim), Dm),
            "wo": dense((L, cfg.q_dim, Dm), cfg.q_dim),
            "w_gate": dense((L, Dm, Fd), Dm),
            "w_up": dense((L, Dm, Fd), Dm),
            "w_down": dense((L, Fd, Dm), Fd),
        },
        "final_norm": norm((Dm,)),
    }
    if cfg.post_norms:
        params["layers"]["ln_post_attn"] = norm((L, Dm))
        params["layers"]["ln_post_ffw"] = norm((L, Dm))
    if not cfg.tie_embeddings:
        params["unembed"] = dense((Dm, cfg.vocab_size), Dm)
    return params


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
               n_kv_heads: Optional[int] = None,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Static-shaped dense KV cache [L, B, max_len, Hkv, Dh] per K/V."""
    dev = resolve_device(device)
    hkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
    shape = (cfg.n_layers, batch, max_len, hkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def _paged_decode_attn(q, k, v, lk, lv, cache, pos, active, w, cfg,
                       attn_impl):
    """Paged S=1 branch (reference transformer.py:459-533): write each
    slot's new KV into its current block — in place, the port's form of
    the donated-pool scatter — then attend straight off the pool.

    Routing is explicit, as in the reference: row b writes to
    table[b, min(pos // bs, mb - 1)] only when it is active, the entry
    is allocated and pos < mb * bs; every other row writes to the trash
    block (the pool's last). PyTorch raises on an out-of-range index and
    wraps -1 to the last element, so nothing here leans on either
    framework's default."""
    B = q.shape[0]
    bs = lk.shape[1]
    table = cache["table"]
    mb = table.shape[1]
    trash = lk.shape[0] - 1
    bi = torch.clamp(pos // bs, max=mb - 1).long()
    entry = torch.gather(table, 1, bi[:, None])[:, 0]
    blk = torch.where(active & (entry >= 0) & (pos < mb * bs),
                      entry, trash).long()
    off = (pos % bs).long()
    lk[blk, off] = k[:, 0].to(lk.dtype)
    lv[blk, off] = v[:, 0].to(lv.dtype)
    if attn_impl != "reference":
        return paged_flash_decode(q, lk, lv, table, pos,
                                  scale=cfg.attn_scale, window=w,
                                  attn_softcap=cfg.attn_softcap)
    # The reference's gathered view: unallocated entries read the trash
    # block and the length mask keeps them unattended.
    Hkv, Dh = lk.shape[2], lk.shape[3]
    safe = torch.where(table >= 0, table, trash).long()
    kd = lk[safe].reshape(B, mb * bs, Hkv, Dh)
    vd = lv[safe].reshape(B, mb * bs, Hkv, Dh)
    k_pos = torch.arange(mb * bs, device=q.device)[None, :]
    kv_mask = k_pos <= pos[:, None]
    if w is not None:
        kv_mask &= window_keep(pos[:, None], k_pos, w)
    return attention(q, kd, vd, causal=False, kv_mask=kv_mask,
                     scale=cfg.attn_scale, attn_softcap=cfg.attn_softcap,
                     impl=attn_impl)


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig, *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            pos_offset=0,
            attn_impl: str = "auto",
            last_logit_only: bool = False,
            pctx=None,
            layers_hook=None,
            mlora_idx: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """LM forward. tokens [B, S] -> (logits [B, S, V] f32, cache).

    cache=None: plain causal forward. A dense cache {"k", "v"} with an
    int ``pos_offset``: the new K/V are written at [pos_offset,
    pos_offset+S) — the start clamped so the write fits, as
    ``dynamic_update_slice`` does in the reference — and attention runs
    over the whole cache with a causal ``q_offset``. A paged cache
    {"pool_k", "pool_v", "table", "active"} with a [B] int32 tensor
    ``pos_offset`` and S == 1: one ragged decode step over the pool.
    ``attn_impl``: "auto" (the kernels) or "reference" (plain PyTorch).
    """
    if pctx is not None:
        raise NotImplementedError(f"ParallelCtx: {TODO_MESH}")
    if layers_hook is not None:
        raise NotImplementedError(f"layers_hook: {TODO_INT8_WEIGHTS}")
    if mlora_idx is not None or "_mlora" in params["layers"]:
        raise NotImplementedError(f"multi-LoRA rows: {TODO_LORA}")
    B, S = tokens.shape
    Dh = cfg.head_dim
    dev = tokens.device
    ragged = isinstance(pos_offset, torch.Tensor)
    paged = cache is not None and "pool_k" in cache
    if cache is not None and (
            "k_scale" in cache or "pool_k_scale" in cache
            or cache["pool_k" if paged else "k"].dtype == torch.int8):
        raise NotImplementedError(f"int8 KV caches: {TODO_INT8_KV}")
    if paged and not ragged:
        raise ValueError("paged cache requires ragged decode (pos [B])")
    if paged and S > 1:
        raise NotImplementedError(
            f"paged multi-token forward (speculative verify, fused tick): "
            f"{TODO_BRANCHES}")
    if cache is not None and not paged and ragged:
        raise NotImplementedError(
            f"dense ragged decode (per-row offsets): {TODO_BRANCHES}")
    if ragged and pos_offset.ndim != 1:
        raise ValueError("tensor pos_offset must be [B] (ragged decode)")
    if not ragged and not isinstance(pos_offset, int):
        raise TypeError("scalar pos_offset must be a Python int")

    if ragged:
        pos = pos_offset
        positions = pos[:, None] + torch.arange(S, device=dev)[None, :]
        active = cache.get("active")
        if active is None:
            active = torch.ones((B,), dtype=torch.bool, device=dev)
    else:
        positions = (pos_offset + torch.arange(S, device=dev))[None, :]
    positions = positions.expand(B, S)
    cos, sin = rotary_embedding(positions, Dh, base=cfg.rope_base,
                                scaling=cfg.rope_scaling,
                                dtype=torch.float32)

    x = params["embed"][tokens.long()].to(cfg.dtype)           # [B, S, Dm]
    if cfg.embed_scale:
        # Rounded to the model dtype BEFORE the multiply, as the
        # reference does (jnp.asarray(sqrt(d_model), dtype)).
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                             device=dev)
    wls = layer_windows(cfg)
    layers = params["layers"]

    for li in range(cfg.n_layers):
        layer = {name: leaf[li] for name, leaf in layers.items()}
        w = None if wls is None else wls[li]
        h = rms_norm(x, layer["ln1"], eps=cfg.norm_eps,
                     offset=cfg.norm_offset)
        H = layer["wq"].shape[-1] // Dh
        Hkv = layer["wk"].shape[-1] // Dh
        q = (h @ layer["wq"]).reshape(B, S, H, Dh)
        k = (h @ layer["wk"]).reshape(B, S, Hkv, Dh)
        v = (h @ layer["wv"]).reshape(B, S, Hkv, Dh)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

        if paged:
            attn = _paged_decode_attn(
                q, k, v, cache["pool_k"][li], cache["pool_v"][li], cache,
                pos, active, w, cfg, attn_impl)
        elif cache is not None:
            # Write the new kv at pos_offset (clamped like
            # dynamic_update_slice, in place); attend over the full
            # static row — positions past the write are zeros the
            # causal q_offset mask removes.
            lk, lv = cache["k"][li], cache["v"][li]
            start = min(max(pos_offset, 0), lk.shape[1] - S)
            lk[:, start:start + S] = k.to(lk.dtype)
            lv[:, start:start + S] = v.to(lv.dtype)
            attn = attention(q, lk, lv, causal=True, q_offset=pos_offset,
                             scale=cfg.attn_scale, window=w,
                             attn_softcap=cfg.attn_softcap, impl=attn_impl)
        else:
            attn = attention(q, k, v, causal=True, scale=cfg.attn_scale,
                             window=w, attn_softcap=cfg.attn_softcap,
                             impl=attn_impl)

        o = attn.reshape(B, S, H * Dh) @ layer["wo"]
        if cfg.post_norms:
            o = rms_norm(o, layer["ln_post_attn"], eps=cfg.norm_eps,
                         offset=cfg.norm_offset)
        x = x + o
        h = rms_norm(x, layer["ln2"], eps=cfg.norm_eps,
                     offset=cfg.norm_offset)
        ff = _act(cfg.act, h @ layer["w_gate"]) * (h @ layer["w_up"])
        ff = ff @ layer["w_down"]
        if cfg.post_norms:
            ff = rms_norm(ff, layer["ln_post_ffw"], eps=cfg.norm_eps,
                          offset=cfg.norm_offset)
        x = x + ff

    if last_logit_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                 offset=cfg.norm_offset)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"]).to(cfg.dtype)
    logits = (x @ unembed).float()                             # [B, S, V]
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits, cache
