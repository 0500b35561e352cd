"""Decoder-only transformer LM — the flagship workload family, in PyTorch.
Counterpart of ``tpushare/models/transformer.py``.

Params keep the JAX package's layout so weights bridge across
unchanged (``models/bridge.py``): a dict of stacked per-layer tensors
([L, ...]), matmuls as ``x @ W`` with W [in, out]. The JAX ``lax.scan``
over layers is a Python loop over the stacked leaves; there is no jit —
PyTorch runs eagerly.

``forward`` ports every single-device cache branch of the reference:
no cache (training / plain prefill), the dense scalar-offset branch
(admission prefill into a row cache, reference ``transformer.py:608-
633``), the dense ragged branches over per-row offsets, S = 1 decode
(``:574-607``, through ``flash_decode``) and S > 1 (the fused tick,
``:534-573``), and the paged branches, S = 1 decode (``:459-533``) and
S > 1 (speculative verify and the fused admission tick, ``:383-458``)
— each over bf16/f32 or int8 KV (``models/quant.py``) — plus the
``layers_hook`` seam (int8 weights). Caches are updated IN PLACE (the
JAX version returns new arrays and donates the old pools); ``forward``
returns the same cache dict.

Training (no cache) is differentiable through the kernels: single
device through ``flash_attention``'s autograd Function, and sequence
parallel under ``ParallelCtx(sp=<process group>)`` through
``parallel.ring_attention`` or, with ``sp_impl="a2a"``,
``parallel.ulysses`` (reference ``transformer.py:634-643``), positions
offset by the rank's shard (``:325-326``). ``cfg.remat``
checkpoints each layer (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of the block, ``:670-671``).

Tensor parallelism: ``ParallelCtx(tp=<process group>)`` with this
rank's Megatron slices of the weights (``param_specs``: q/k/v/gate/up
columns and o/down rows over tp) and, serving, of the KV cache (kv
heads over tp). Head counts are read off the weight shapes, and the two
partial sums of each block, after ``wo`` and after ``w_down``, are
all-reduced over the group (reference ``transformer.py:651-652,
663-664``). With grad mode on the block runs Megatron's two operators:
"f" (``copy_to``) on the input of every column-parallel product, the
identity forward whose backward sums the input's gradient over tp, and
"g" (``tp_matmul``'s ``_RowParallel``), the row-parallel product whose
f32 partials are summed once and whose backward is each rank's own
product gradient, with no collective. The reference gets the same
gradients from the shard_map transpose of its psums. Without grad mode
the serving forward is untouched.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.models.quant import (kv_dequantize, kv_quantize,
                                         pool_scales_to_rows)
from tpushare_torch.ops.attention import attention, window_keep
from tpushare_torch.ops.flash_attention import (flash_decode,
                                                paged_flash_decode,
                                                paged_flash_verify)
from tpushare_torch.ops.norms import rms_norm
from tpushare_torch.ops.q8_expert import _apply_act as _act
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding
from tpushare_torch.parallel.ring_attention import ring_attention
from tpushare_torch.parallel.ulysses import ulysses_attention


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
class ParallelCtx:
    """What the forward pass is manually parallel over (reference
    ``transformer.py:55-67``, whose fields name mesh axes). ``sp`` holds
    the ``torch.distributed`` process group the sequence is sharded over
    (``mesh.get_group("sp")``): attention runs as ring attention across
    it, or as Ulysses all-to-all attention with ``sp_impl="a2a"``. ``tp``
    holds the tensor-parallel process group (``ServingMesh.axis_group(
    "tp")``): the forward all-reduces each block's two partial sums
    over it, differentiably with grad mode on."""
    tp: Any = None
    sp: Any = None
    sp_impl: str = "ring"


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
    remat: bool = True            # checkpoint each layer when training

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
    weights with ``bridge.params_from_jax`` where parity matters.
    ``device="meta"`` gives the shapes and dtypes alone (the
    reference's ``jax.eval_shape`` of this function)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None
    elif isinstance(gen, int):
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


def param_specs(cfg: TransformerConfig, *, tp: str = "tp",
                fsdp: Optional[str] = None) -> Dict[str, Any]:
    """Spec tree matching ``init_params`` (reference ``:193-218``):
    the Megatron layout, q/kv/gate/up columns over tp and o/down rows
    over tp, so each block needs one all-reduce per half. ``fsdp``
    additionally names the d_model (row) axis of the column-parallel
    weights and the embedding's vocab axis."""
    from tpushare_torch.parallel.sharding import P
    specs = {
        "embed": P(fsdp, None),
        "layers": {
            "ln1": P(None, None), "ln2": P(None, None),
            "wq": P(None, fsdp, tp), "wk": P(None, fsdp, tp),
            "wv": P(None, fsdp, tp), "wo": P(None, tp, fsdp),
            "w_gate": P(None, fsdp, tp), "w_up": P(None, fsdp, tp),
            "w_down": P(None, tp, fsdp),
        },
        "final_norm": P(None),
    }
    if cfg.post_norms:
        specs["layers"]["ln_post_attn"] = P(None, None)
        specs["layers"]["ln_post_ffw"] = P(None, None)
    if not cfg.tie_embeddings:
        specs["unembed"] = P(fsdp, None)
    return specs


def tp_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum a tensor-parallel partial over ``group`` (in place; the
    reference's ``psum``). No group: ``x`` unchanged."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _row_parallel(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        part = x2 @ w
    elif x.is_cuda:
        part = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        part = x2.float() @ w.float()
    dist.all_reduce(part, group=group)
    return part.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _RowParallel(torch.autograd.Function):
    """Megatron's "g" over a row-parallel product: the forward is
    ``tp_matmul``'s (f32 partials summed once); the sum's gradient is
    the identity (the loss is the same on every rank of the group), so
    the backward is this rank's own product gradient, computed here
    (``mm`` with ``out_dtype`` has no derivative): dx = g w^T,
    dw = x^T g, in the operands' dtypes."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        return _row_parallel(x, w, group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ w.t()).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ g2
        return dx, dw, None


class _CopyTo(torch.autograd.Function):
    """Megatron's "f": the identity forward; the backward sums the
    input's gradient over the group (in f32, rounded once), since each
    rank's slice of the following product sees only its part of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        acc = g.float() if g.dtype != torch.float32 else g.clone()
        dist.all_reduce(acc, group=ctx.group)
        return acc.to(g.dtype), None


class _SumOver(torch.autograd.Function):
    """A partial summed over the group (out of place), the "g" of a
    partial computed elsewhere (an expert product's tp part, an ep
    rank's experts' share): the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """"f" on the input of a product split over ``group``: ``x`` itself
    without a group or without a gradient to carry."""
    if group is None or not _needs_grad(x):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of a partial over ``group`` ("g"): ``tp_all_reduce`` (in
    place) where no gradient flows, else out of place with the identity
    as its gradient. No group: ``x``."""
    if group is None:
        return x
    if not _needs_grad(x):
        return tp_all_reduce(x, group)
    return _SumOver.apply(x, group)


def tp_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` for a row-parallel weight (``wo``, ``w_down``: its
    input axis split over ``group``), summed over the group. Each rank's
    partial leaves its product in f32 (``out_dtype`` on the card), the
    sum runs in f32 and rounds once to ``x``'s dtype, as one card's
    single product rounds its f32 accumulator once. With a gradient to
    carry it is "g" (``_RowParallel``). No group: ``x @ w``."""
    if group is None:
        return x @ w
    if _needs_grad(x, w):
        return _RowParallel.apply(x, w, group)
    return _row_parallel(x, w, group)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
               n_kv_heads: Optional[int] = None,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Static-shaped dense KV cache [L, B, max_len, Hkv, Dh] per K/V.
    ``n_kv_heads`` overrides the head count for tp-local caches
    (cfg.n_kv_heads // tp)."""
    dev = resolve_device(device)
    hkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
    shape = (cfg.n_layers, batch, max_len, hkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def drop_write(rows: torch.Tensor, positions: torch.Tensor,
               vals: torch.Tensor) -> None:
    """rows[b, positions[b, j]] = vals[b, j] in place, with writes at
    positions >= rows.shape[1] DROPPED — the reference's scatter
    ``mode="drop"`` (a fused tick's junk columns near max_len must
    vanish, not clamp onto live rows). rows [B, M, ...]; positions
    [B, S] (increasing along S). A dropped write is redirected onto a
    write that happens anyway with the same value — the row's column 0
    when that one lands, else a rewrite of position M-1 with its old
    value — so the index_put never holds two values for one place and
    no data-dependent shape (a device sync) is needed."""
    B, M = rows.shape[:2]
    pos = positions.long()
    valid = pos < M
    b_idx = torch.arange(B, device=rows.device)[:, None].expand_as(pos)
    col0 = valid[:, :1]
    tgt = torch.where(col0, pos[:, :1], M - 1)                   # [B, 1]
    keep_val = torch.where(col0.reshape(B, *([1] * (vals.ndim - 2))),
                           vals[:, 0].to(rows.dtype), rows[:, M - 1])
    sel = valid.reshape(*valid.shape, *([1] * (vals.ndim - 2)))
    v = torch.where(sel, vals.to(rows.dtype), keep_val[:, None])
    rows[b_idx, torch.where(valid, pos, tgt)] = v


def _layer_slice(tree, li: int):
    """Layer ``li`` of a stacked layer tree; nested trees (a
    ``lora.lora_params`` pack) slice leaf by leaf, as the reference's
    layer scan does."""
    return {name: (_layer_slice(leaf, li) if isinstance(leaf, dict)
                   else leaf[li]) for name, leaf in tree.items()}


def _lora_delta(inp: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                idx: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-row low-rank delta ``scale * inp @ A[idx] @ B[idx]`` of one
    layer's bank (a [NA, d, r], b [NA, r, o]) in f32, zero for rows
    with idx < 0 (the base model), cast to ``inp``'s dtype. Plain
    torch, as the reference's is plain jnp outside any kernel."""
    safe = torch.clamp(idx.long(), min=0)
    t = torch.einsum("bsd,bdr->bsr", inp.float(), a[safe].float())
    d = torch.einsum("bsr,bro->bso", t, b[safe].float()) * scale
    d = torch.where((idx >= 0)[:, None, None], d, torch.zeros_like(d))
    return d.to(inp.dtype)


def _ragged_attn(q, k, v, lk, lv, lks, lvs, pos, positions, w, cfg,
                 attn_impl):
    """Dense ragged branches of the reference (transformer.py:534-607):
    token j of row b is written at positions[b, j] = pos[b] + j of the
    row cache, in place, writes past max_len dropped; int8 rows
    quantize on write and the whole row view dequantizes to cfg.dtype
    first. S = 1 attends through ``flash_decode`` (the plain masked
    reference on CPU or with attn_impl "reference"); S > 1 (the fused
    tick) through ``mha_reference`` with the per-(row, query) mask, as
    the reference does."""
    S = q.shape[1]
    if lks is not None:
        qk, sk = kv_quantize(k)
        qv, sv = kv_quantize(v)
        drop_write(lk, positions, qk)
        drop_write(lv, positions, qv)
        drop_write(lks, positions, sk)
        drop_write(lvs, positions, sv)
        kd = kv_dequantize(lk, lks, cfg.dtype)
        vd = kv_dequantize(lv, lvs, cfg.dtype)
    else:
        drop_write(lk, positions, k)
        drop_write(lv, positions, v)
        kd, vd = lk, lv
    kw = dict(scale=cfg.attn_scale, attn_softcap=cfg.attn_softcap)
    if S == 1 and attn_impl != "reference":
        return flash_decode(q, kd, vd, pos, window=w, **kw)
    M = kd.shape[1]
    k_pos = torch.arange(M, device=q.device)[None, None, :]
    kv_mask = k_pos <= positions[..., None]                    # [B, S, M]
    if w is not None:
        kv_mask &= window_keep(positions[..., None], k_pos, w)
    return attention(q, kd, vd, causal=False, kv_mask=kv_mask,
                     impl="reference", **kw)


def _paged_attn(q, k, v, lk, lv, lks, lvs, cache, pos, active, w, cfg,
                attn_impl):
    """Paged branches of the reference (transformer.py:383-533): write
    token j of slot b at position pos[b] + j — in place, the port's form
    of the donated-pool scatter; int8 pools quantize on write — then
    attend straight off the pool: ``paged_flash_decode`` for S = 1,
    ``paged_flash_verify`` for S > 1 (speculative verify, fused tick).

    Routing is explicit, as in the reference: a row writes to
    table[b, min(p // bs, mb - 1)] only when its slot is active, the
    entry is allocated and p < mb * bs; every other row (inactive
    slots, -1 entries, positions past capacity) writes to the trash
    block (the pool's last). PyTorch raises on an out-of-range index
    and wraps -1 to the last element, so nothing here leans on either
    framework's default. Every write lands before this layer's
    attention reads the pool."""
    B, S = q.shape[:2]
    bs = lk.shape[1]
    table = cache["table"]
    mb = table.shape[1]
    trash = lk.shape[0] - 1
    pos_grid = pos.long()[:, None] + torch.arange(S, device=q.device)
    bi = torch.clamp(pos_grid // bs, max=mb - 1)
    entry = torch.gather(table, 1, bi)
    blk = torch.where(active[:, None] & (entry >= 0) & (pos_grid < mb * bs),
                      entry, trash).long()
    off = pos_grid % bs
    if lks is not None:
        qk, sk = kv_quantize(k)
        qv, sv = kv_quantize(v)
        lk[blk, off] = qk
        lv[blk, off] = qv
        lks[blk, :, off] = sk           # page layout [nb, Hkv, bs]
        lvs[blk, :, off] = sv
    else:
        lk[blk, off] = k.to(lk.dtype)
        lv[blk, off] = v.to(lv.dtype)
    if attn_impl != "reference":
        kern = paged_flash_decode if S == 1 else paged_flash_verify
        kw = {} if lks is None else {"k_scale": lks, "v_scale": lvs}
        return kern(q, lk, lv, table, pos, scale=cfg.attn_scale, window=w,
                    attn_softcap=cfg.attn_softcap, **kw)
    # The reference's gathered view: unallocated entries read the trash
    # block and the per-row length mask keeps them unattended; int8
    # pages dequantize to cfg.dtype first, as the reference does.
    Hkv, Dh = lk.shape[2], lk.shape[3]
    safe = torch.where(table >= 0, table, trash).long()
    kd, vd = lk[safe], lv[safe]
    if lks is not None:
        kd = kv_dequantize(kd, pool_scales_to_rows(lks[safe]), cfg.dtype)
        vd = kv_dequantize(vd, pool_scales_to_rows(lvs[safe]), cfg.dtype)
    kd = kd.reshape(B, mb * bs, Hkv, Dh)
    vd = vd.reshape(B, mb * bs, Hkv, Dh)
    k_pos = torch.arange(mb * bs, device=q.device)[None, None, :]
    kv_mask = k_pos <= pos_grid[..., None]                 # [B, S, K]
    if w is not None:
        kv_mask &= window_keep(pos_grid[..., None], k_pos, w)
    return attention(q, kd, vd, causal=False, kv_mask=kv_mask,
                     scale=cfg.attn_scale, attn_softcap=cfg.attn_softcap,
                     impl=attn_impl)


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig, *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            pos_offset=0,
            attn_impl: str = "auto",
            last_logit_only: bool = False,
            pctx: Optional[ParallelCtx] = None,
            layers_hook=None,
            mlora_idx: Optional[torch.Tensor] = None,
            mlora_scale: float = 1.0,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """LM forward. tokens [B, S] -> (logits [B, S, V] f32, cache).

    cache=None: plain causal forward. A dense cache {"k", "v"} (plus
    {"k_scale", "v_scale"} for int8 rows) with an int ``pos_offset``:
    the new K/V are written at [pos_offset, pos_offset+S) — the start
    clamped so the write fits, as ``dynamic_update_slice`` does in the
    reference — and attention runs over the whole cache with a causal
    ``q_offset``. A paged cache {"pool_k", "pool_v", "table", "active"}
    (plus {"pool_k_scale", "pool_v_scale"} for int8 pools) with a [B]
    int32 tensor ``pos_offset``: token j of slot b at position
    pos[b] + j, attending through the block table. ``layers_hook`` maps
    each layer's leaves before use (``quant.dequant_hook``).
    Multi-LoRA: when ``params["layers"]`` carries the ``_mlora`` bank
    (``lora.multi_lora_params``), ``mlora_idx`` [B] picks each row's
    adapter and every bank target adds ``mlora_scale * x @ A[i] @ B[i]``
    (f32, cast to the activation dtype) on the activation path, zero
    for rows with idx < 0 (the base model); on every cache branch.
    A dense cache with a [B] int32 tensor ``pos_offset``: ragged rows,
    token j of row b at pos[b] + j (writes past max_len dropped).
    ``attn_impl``: "auto" (the kernels) or "reference" (plain PyTorch).
    Under ``pctx.sp`` (a process group) tokens are this rank's sequence
    shard: positions start at rank * S and, with no cache, attention is
    ring attention over the group (its dense chunk math with
    attn_impl "reference"), or Ulysses under ``pctx.sp_impl == "a2a"``. With ``cfg.remat``, grad mode on and no
    cache, each layer runs under ``torch.utils.checkpoint``.
    """
    pctx = pctx or ParallelCtx()
    if pctx.sp_impl not in ("ring", "a2a"):
        raise ValueError(f"unknown sp_impl {pctx.sp_impl!r}; 'ring' or "
                         f"'a2a'")
    B, S = tokens.shape
    Dh = cfg.head_dim
    dev = tokens.device
    ragged = isinstance(pos_offset, torch.Tensor)
    paged = cache is not None and "pool_k" in cache
    # Int8 KV (quant.init_cache_q8 rows / kv_quant pools): int8 rows
    # plus per-(position, head) scales; rows quantize on write.
    kvq = cache is not None and ("k_scale" in cache
                                 or "pool_k_scale" in cache)
    if not kvq and cache is not None and (
            cache["pool_k" if paged else "k"].dtype == torch.int8):
        raise ValueError(
            "int8 KV cache reached forward() without its scale leaves "
            "(k_scale/v_scale or pool_*_scale)")
    if paged and not ragged:
        raise ValueError("paged cache requires ragged decode (pos [B])")
    if ragged and pos_offset.ndim != 1:
        raise ValueError("tensor pos_offset must be [B] (ragged decode)")
    if not ragged and not isinstance(pos_offset, int):
        raise TypeError("scalar pos_offset must be a Python int")

    if ragged:
        pos = pos_offset
        positions = pos[:, None] + torch.arange(S, device=dev)[None, :]
        active = cache.get("active") if paged else None
        if paged and active is None:
            active = torch.ones((B,), dtype=torch.bool, device=dev)
    else:
        positions = (pos_offset + torch.arange(S, device=dev))[None, :]
    if pctx.sp is not None:
        positions = positions + dist.get_rank(pctx.sp) * S
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
    layers = dict(params["layers"])
    bank = layers.pop("_mlora", None)

    def block(x, li):
        layer = _layer_slice(layers, li)
        if layers_hook is not None:
            layer = layers_hook(layer)
        ml = None
        if bank is not None and mlora_idx is not None:
            ml = {n: (ab["a"][li], ab["b"][li]) for n, ab in bank.items()}

        def lin(name, inp):
            out = inp @ layer[name]
            if ml is None or name not in ml:
                return out
            return out + _lora_delta(inp, *ml[name], mlora_idx, mlora_scale)

        def tp_lin(name, inp):
            # The servers refuse multi-LoRA on a mesh, so under tp
            # no adapter delta joins the row-parallel products.
            if pctx.tp is None:
                return lin(name, inp)
            return tp_matmul(inp, layer[name], pctx.tp)

        w = None if wls is None else wls[li]
        h = copy_to(rms_norm(x, layer["ln1"], eps=cfg.norm_eps,
                             offset=cfg.norm_offset), pctx.tp)
        H = layer["wq"].shape[-1] // Dh
        Hkv = layer["wk"].shape[-1] // Dh
        q = lin("wq", h).reshape(B, S, H, Dh)
        k = lin("wk", h).reshape(B, S, Hkv, Dh)
        v = lin("wv", h).reshape(B, S, Hkv, Dh)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

        if paged:
            attn = _paged_attn(
                q, k, v, cache["pool_k"][li], cache["pool_v"][li],
                cache["pool_k_scale"][li] if kvq else None,
                cache["pool_v_scale"][li] if kvq else None,
                cache, pos, active, w, cfg, attn_impl)
        elif cache is not None and ragged:
            attn = _ragged_attn(
                q, k, v, cache["k"][li], cache["v"][li],
                cache["k_scale"][li] if kvq else None,
                cache["v_scale"][li] if kvq else None,
                pos, positions, w, cfg, attn_impl)
        elif cache is not None:
            # Write the new kv at pos_offset (clamped like
            # dynamic_update_slice, in place); attend over the full
            # static row — positions past the write are zeros the
            # causal q_offset mask removes. Int8 rows quantize on write
            # and the whole row dequantizes to cfg.dtype before
            # attention (reference transformer.py:612-621).
            lk, lv = cache["k"][li], cache["v"][li]
            start = min(max(pos_offset, 0), lk.shape[1] - S)
            end = start + S
            if kvq:
                lks, lvs = cache["k_scale"][li], cache["v_scale"][li]
                lk[:, start:end], lks[:, start:end] = kv_quantize(k)
                lv[:, start:end], lvs[:, start:end] = kv_quantize(v)
                kd = kv_dequantize(lk, lks, cfg.dtype)
                vd = kv_dequantize(lv, lvs, cfg.dtype)
            else:
                lk[:, start:end] = k.to(lk.dtype)
                lv[:, start:end] = v.to(lv.dtype)
                kd, vd = lk, lv
            attn = attention(q, kd, vd, causal=True, q_offset=pos_offset,
                             scale=cfg.attn_scale, window=w,
                             attn_softcap=cfg.attn_softcap, impl=attn_impl)
        elif pctx.sp is not None and pctx.sp_impl == "a2a":
            attn = ulysses_attention(
                q, k, v, group=pctx.sp, scale=cfg.attn_scale, window=w,
                attn_softcap=cfg.attn_softcap, impl=attn_impl)
        elif pctx.sp is not None:
            attn = ring_attention(
                q, k, v, group=pctx.sp, scale=cfg.attn_scale, window=w,
                attn_softcap=cfg.attn_softcap,
                impl="dense" if attn_impl == "reference" else "auto")
        else:
            attn = attention(q, k, v, causal=True, scale=cfg.attn_scale,
                             window=w, attn_softcap=cfg.attn_softcap,
                             impl=attn_impl)

        o = tp_lin("wo", attn.reshape(B, S, H * Dh))
        if cfg.post_norms:
            o = rms_norm(o, layer["ln_post_attn"], eps=cfg.norm_eps,
                         offset=cfg.norm_offset)
        x = x + o
        h = copy_to(rms_norm(x, layer["ln2"], eps=cfg.norm_eps,
                             offset=cfg.norm_offset), pctx.tp)
        ff = _act(cfg.act, lin("w_gate", h)) * lin("w_up", h)
        ff = tp_lin("w_down", ff)
        if cfg.post_norms:
            ff = rms_norm(ff, layer["ln_post_ffw"], eps=cfg.norm_eps,
                          offset=cfg.norm_offset)
        return x + ff

    # The model has no randomness, so the recompute needs no RNG state.
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for li in range(cfg.n_layers):
        if remat:
            x = checkpoint(block, x, li, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, li)

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


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig, *,
            max_len: int, attn_impl: str = "auto"):
    """Run the prompt through the model into a fresh row cache:
    (logits, cache)."""
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    return forward(params, tokens, cfg, cache=cache, pos_offset=0,
                   attn_impl=attn_impl)


def chunked_prefill_loop(fwd, params, tokens: torch.Tensor, cache,
                         chunk: int, last_pos: int):
    """THE chunked-prefill loop (``serving.SlotServer.admit`` shares
    it): ``tokens`` [B, S] through fixed ``chunk`` slices into
    ``cache``; returns (the logits row at ``last_pos`` [B, V], cache).
    Only the piece holding ``last_pos`` computes per-position logits;
    the others run with ``last_logit_only``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    out = None
    for i in range(0, tokens.shape[1], chunk):
        piece = tokens[:, i:i + chunk]
        if i <= last_pos < i + piece.shape[1]:
            logits, cache = fwd(params, piece, cache=cache, pos_offset=i)
            out = logits[:, last_pos - i]
        else:
            _, cache = fwd(params, piece, cache=cache, pos_offset=i,
                           last_logit_only=True)
    return out, cache


def chunked_prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
                    *, max_len: int, chunk: int = 2048,
                    attn_impl: str = "auto"):
    """Prefill a long prompt in fixed-size chunks: (last logits [B, 1, V],
    cache); the same cache writes and logits as the one-shot prefill."""
    B, S = tokens.shape
    if S == 0:
        raise ValueError("cannot prefill an empty prompt")

    def fwd(p, t, **kw):
        return forward(p, t, cfg, attn_impl=attn_impl, **kw)

    last, cache = chunked_prefill_loop(
        fwd, params, tokens,
        init_cache(cfg, B, max_len, device=tokens.device), chunk, S - 1)
    return last[:, None], cache


def decode_step(params, token: torch.Tensor, cfg: TransformerConfig, cache,
                offset: int, *, attn_impl: str = "auto"):
    """One autoregressive step: token [B, 1] at position ``offset``."""
    return forward(params, token, cfg, cache=cache, pos_offset=offset,
                   attn_impl=attn_impl)
