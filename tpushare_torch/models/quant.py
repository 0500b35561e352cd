"""Int8 weights and int8 KV for the decoder LM (serving). Counterpart of
``tpushare/models/quant.py``.

- Weights: ``quantize_layers`` / ``quantize_params`` store each layer
  matrix ``k`` [L, ..., In, Out] as ``k#q8`` int8 plus ``k#scale`` f32
  [L, ..., 1, Out] (symmetric, per output channel: ``s = max(absmax /
  127, 1e-12)``; an MoE expert stack [L, E, In, Out] gets [L, E, 1, Out]
  scales); ``dequant_hook(cfg)`` is the ``layers_hook`` that widens one
  layer back to ``cfg.dtype`` inside ``forward`` (a bf16 copy of the
  layer per call, as in the reference). ``fused_expert_hook(cfg)`` is
  the MoE variant that leaves the expert stacks int8 for the fused
  kernel (``ops/q8_expert.py``). Norms, the router and the embeddings
  stay full precision and are shared with the source tree.
  ``quantized_forward`` is ``forward`` over such a tree with
  ``dequant_hook``; ``param_bytes`` counts a tree's stored bytes.
- KV: ``kv_quantize`` / ``kv_dequantize`` with per-(position, head)
  scales over the head dim (``s = max(absmax, 1e-12) / 127``) and
  ``init_cache_q8`` for a dense row cache.

Both formulas keep the reference's order exactly: f32 absmax, the
divide, ``round`` half to even, clip to +-127.

Pool scale layout. The JAX pools store scale pages as
``[L, nb, Hkv_pad, bs]`` with heads padded to 8: a Mosaic tiling rule
of the TPU (block_size on the lane dim, heads on a sublane multiple).
The port stores ``[L, nb, Hkv, bs]``, unpadded: the paged kernels read
one (page, head) as ``bs`` contiguous floats, and nothing on the card
asks for the padding. ``scales_to_pool_layout`` / ``pool_scales_to_rows``
convert between the row-major ``[..., bs, Hkv]`` view the row caches
use and that page layout.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.utils import profiling

if TYPE_CHECKING:     # transformer imports this module for the KV helpers
    from tpushare_torch.models.transformer import TransformerConfig

# Layer leaves that get quantized ([L, In, Out]); the rest (norms) pass
# through.
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# The MoE expert stacks the fused kernel consumes as raw int8.
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
_SUFFIX_Q = "#q8"
_SUFFIX_S = "#scale"


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., In, Out] -> (int8 [..., In, Out], f32 scale [..., 1, Out])."""
    x = w.float()
    s = torch.clamp(x.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def quantize_layers(layers: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Stacked layer tree -> quantized storage tree (``k#q8`` int8 +
    ``k#scale`` f32 ``w.shape[:-2] + (1, Out)`` per quantized leaf, any
    rank). Quantizes one layer at a time so a full-width leaf never has
    more than one layer's f32 copy alive."""
    out: Dict[str, torch.Tensor] = {}
    for k, w in layers.items():
        if k not in _QUANT_KEYS:
            out[k] = w
            continue
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:-2] + (1, w.shape[-1]),
                        dtype=torch.float32, device=w.device)
        for li in range(w.shape[0]):
            q[li], s[li] = quantize_weight(w[li])
        out[k + _SUFFIX_Q] = q
        out[k + _SUFFIX_S] = s
    return out


def quantize_params(params: Dict[str, Any],
                    cfg: TransformerConfig) -> Dict[str, Any]:
    """Full param tree with the layer stack quantized; embed, unembed
    and norms are the source tree's own tensors. Serve it with
    ``layers_hook=dequant_hook(cfg)``."""
    del cfg                         # the reference's signature
    out = dict(params)
    out["layers"] = quantize_layers(params["layers"])
    return out


@functools.lru_cache(maxsize=None)
def dequant_hook(cfg: TransformerConfig):
    """``layers_hook`` for forward(): one layer's int8 leaves ->
    ``(q.float() * s).to(cfg.dtype)``. Memoized per cfg, as in the
    reference, so one server holds one hook."""
    def hook(layer: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for k, v in layer.items():
            if k.endswith(_SUFFIX_Q):
                out[k[:-len(_SUFFIX_Q)]] = _widen(layer, k[:-len(_SUFFIX_Q)],
                                                  cfg.dtype)
            elif not k.endswith(_SUFFIX_S):
                out[k] = v
        return out
    return hook


def _widen(layer: Dict[str, torch.Tensor], base: str,
           dtype: torch.dtype) -> torch.Tensor:
    return (layer[base + _SUFFIX_Q].float() * layer[base + _SUFFIX_S]
            ).to(dtype)


@functools.lru_cache(maxsize=None)
def fused_expert_hook(cfg):
    """``layers_hook`` for the fused int8 MoE path: attention leaves
    widen exactly as ``dequant_hook`` widens them, the expert stacks
    (``w_gate``/``w_up``/``w_down``) pass through as their ``#q8`` and
    ``#scale`` leaves, which ``models/moe.py`` feeds to
    ``ops/q8_expert.py`` — no wide expert copy is made. MoE only: dense
    int8 trees keep ``dequant_hook``. Memoized per cfg."""
    def hook(layer: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for k, v in layer.items():
            if k.endswith(_SUFFIX_Q) or k.endswith(_SUFFIX_S):
                base = k.rsplit("#", 1)[0]
                if base in _EXPERT_KEYS:
                    out[k] = v                 # int8 + its kernel scales
                elif k.endswith(_SUFFIX_Q):
                    out[base] = _widen(layer, base, cfg.dtype)
            else:
                out[k] = v
        return out
    return hook


def quant_layer_specs(layer_specs: Dict[str, Any],
                      layers: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """Spec tree of a ``quantize_layers`` tree from the full-precision
    layer specs (reference ``quant_layer_specs``): ``k#q8`` places like
    ``k``; its scale ``[..., 1, Out]`` keeps every non-reduced axis and
    drops the input axis's (a row split cannot cut a size-1 axis), so
    a row-parallel leaf's scales replicate over tp and an expert
    stack's keep ep. Specs must be explicit full rank; pass ``layers``
    to have that checked against the leaves."""
    from tpushare_torch.parallel.sharding import P
    out: Dict[str, Any] = {}
    for k, sp in layer_specs.items():
        if k in _QUANT_KEYS:
            entries = tuple(sp)
            if len(entries) < 3:
                raise ValueError(
                    f"quantized leaf {k!r} needs an explicit rank>=3 "
                    f"spec [L, ..., In, Out]; got {sp}")
            if layers is not None and k in layers and \
                    len(entries) != layers[k].ndim:
                raise ValueError(
                    f"quantized leaf {k!r} is rank {layers[k].ndim} "
                    f"but its spec {sp} has {len(entries)} entries; "
                    f"truncated specs would mis-place the scale "
                    f"sharding — spell out every axis")
            out[k + _SUFFIX_Q] = sp
            out[k + _SUFFIX_S] = P(*entries[:-2], None, entries[-1])
        else:
            out[k] = sp
    return out


def quant_param_specs(cfg: TransformerConfig,
                      **param_specs_kw) -> Dict[str, Any]:
    """Spec tree of a dense ``quantize_params`` tree: the int8 weights
    shard like the bf16 ones (``transformer.param_specs``)."""
    from tpushare_torch.models.transformer import param_specs
    specs = param_specs(cfg, **param_specs_kw)
    return dict(specs, layers=quant_layer_specs(specs["layers"]))


def quant_moe_param_specs(cfg, **param_specs_kw) -> Dict[str, Any]:
    """Spec tree of a quantized MoE tree (``moe.param_specs`` with the
    int8 layer leaves)."""
    from tpushare_torch.models.moe import param_specs as moe_param_specs
    specs = moe_param_specs(cfg, **param_specs_kw)
    return dict(specs, layers=quant_layer_specs(specs["layers"]))


def quantized_forward(qparams: Dict[str, Any], tokens: torch.Tensor,
                      cfg: TransformerConfig, **kw):
    """``transformer.forward`` over a ``quantize_params`` tree through
    ``dequant_hook(cfg)`` (serving without training)."""
    from tpushare_torch.models.transformer import forward
    return forward(qparams, tokens, cfg, layers_hook=dequant_hook(cfg),
                   **kw)


def param_bytes(params) -> int:
    """Bytes of every tensor of a params tree (nested dicts, lists,
    tuples) at its stored width: ``numel() * element_size()`` summed
    over the leaves (int8 leaves and their f32 scales as stored)."""
    return sum(t.numel() * t.element_size()
               for t in profiling.tree_tensors(params))


def dequant_expert_leaves(layer: Dict[str, torch.Tensor],
                          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Widen a layer's int8 leaves with ``dequant_hook``'s math, for the
    MoE dispatches the fused kernel does not cover."""
    out = {k: v for k, v in layer.items()
           if not (k.endswith(_SUFFIX_Q) or k.endswith(_SUFFIX_S))}
    for k in layer:
        if k.endswith(_SUFFIX_Q):
            base = k[:-len(_SUFFIX_Q)]
            out[base] = _widen(layer, base, dtype)
    return out


def init_cache_q8(cfg: TransformerConfig, batch: int, max_len: int, *,
                  n_kv_heads: Optional[int] = None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Int8 dense KV cache: {"k", "v"} int8 [L, B, M, Hkv, Dh] and
    {"k_scale", "v_scale"} f32 [L, B, M, Hkv]."""
    dev = resolve_device(device)
    hkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
    shape = (cfg.n_layers, batch, max_len, hkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)}


def kv_quantize(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Dh] -> (int8 [..., Dh], f32 scale [...]); absmax over Dh."""
    x = rows.float()
    s = torch.clamp(x.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def kv_dequantize(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """(int8 [..., Dh], scale [...]) -> dtype [..., Dh]."""
    return (q.float() * s[..., None]).to(dtype)


def scales_to_pool_layout(s: torch.Tensor) -> torch.Tensor:
    """Row-major scales [..., bs, Hkv] -> the port's page layout
    [..., Hkv, bs] (contiguous)."""
    return s.float().transpose(-1, -2).contiguous()


def pool_scales_to_rows(s: torch.Tensor) -> torch.Tensor:
    """Page layout [..., Hkv, bs] -> row-major [..., bs, Hkv]."""
    return s.transpose(-1, -2)
