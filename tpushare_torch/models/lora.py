"""LoRA adapters for the decoder LM, and the multi-LoRA bank that serves
many of them over one base model. Counterpart of
``tpushare/models/lora.py``.

Adapters keep the reference's stacked layout ({name: {"a": [L, d_in, r],
"b": [L, r, d_out]}}), so adapter trees bridge across unchanged
(``bridge.adapters_from_jax``). ``lora_hook`` is the ``layers_hook``
that merges ``W + scale * (A @ B)`` one layer at a time inside
``forward``; ``merge_lora`` folds the adapters into plain base-layout
params. ``stack_adapters`` builds the serving bank ([L, NA, ...]
leaves: the adapter axis after the layer axis), and
``multi_lora_params`` packs it under the reserved ``_mlora`` key of the
layer tree, where ``transformer.forward`` applies each row's adapter on
the activation path (``mlora_idx`` [B], -1 = the base model).

Left out, each raising ``NotImplementedError`` naming its ROADMAP item:
``lora_param_specs`` (sharded placement) and LoRA training
(``lora_loss``, ``make_lora_fit_step``, ``lora_train_step``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Tuple

import torch

from tpushare_torch.models.transformer import TODO_MESH, TransformerConfig

TODO_LORA_TRAIN = "ROADMAP A12 (LoRA training)"

# Every linear the layer stack carries. (wq, wv) is the classic
# attention-only default; MLP targets are there for full-layer LoRA.
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
DEFAULT_TARGETS = ("wq", "wv")
# The layer-tree key the multi-LoRA bank rides under.
MLORA_KEY = "_mlora"


def _target_dims(cfg: TransformerConfig, name: str) -> Tuple[int, int]:
    Dm, F = cfg.d_model, cfg.d_ff
    return {
        "wq": (Dm, cfg.q_dim), "wk": (Dm, cfg.kv_dim),
        "wv": (Dm, cfg.kv_dim), "wo": (cfg.q_dim, Dm),
        "w_gate": (Dm, F), "w_up": (Dm, F), "w_down": (F, Dm),
    }[name]


def init_lora(gen: torch.Generator, cfg: TransformerConfig, rank: int,
              targets: Tuple[str, ...] = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Adapter tree {name: {"a": [L, d_in, r], "b": [L, r, d_out]}} on
    ``gen``'s device. A is truncated-normal (in [-2, 2]) / sqrt(d_in), B
    is zeros, so the delta starts at exactly zero and step 0 reproduces
    the base model bit for bit. The values differ from the JAX
    package's for the same seed; bridge a JAX tree where parity
    matters."""
    for t in targets:
        if t not in LORA_TARGETS:
            raise ValueError(f"unknown LoRA target {t!r}")
    L = cfg.n_layers
    dev = gen.device
    adapters: Dict[str, Any] = {}
    for name in targets:
        d_in, d_out = _target_dims(cfg, name)
        a = torch.empty((L, d_in, rank), dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(a, 0.0, 1.0, -2.0, 2.0, generator=gen)
        adapters[name] = {
            "a": (a / math.sqrt(d_in)).to(dtype),
            "b": torch.zeros((L, rank, d_out), dtype=dtype, device=dev),
        }
    return adapters


def lora_params(params: Dict[str, Any],
                adapters: Dict[str, Any]) -> Dict[str, Any]:
    """Pack base + adapters into one tree whose layer stack carries both
    ({"base": ..., "lora": ...}); pair it with ``lora_hook``. The base
    leaves are shared, not copied."""
    return {**params, "layers": {"base": params["layers"],
                                 "lora": adapters}}


def _merged(base: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            scale: float) -> torch.Tensor:
    """``base + scale * (a @ b)`` in f32, cast back to the base dtype."""
    return (base.float() + scale * (a.float() @ b.float())).to(base.dtype)


@functools.lru_cache(maxsize=None)
def lora_hook(scale: float = 1.0, inner=None):
    """``layers_hook`` computing ``W + scale * (A @ B)`` per target for
    a ``lora_params`` tree. ``inner`` is applied to the BASE slice first
    (``quant.dequant_hook(cfg)`` serves an int8 base with f32 adapters).
    Memoized per (scale, inner), as in the reference."""
    def hook(xs):
        base = inner(xs["base"]) if inner is not None else xs["base"]
        layer = dict(base)
        for name, ab in xs["lora"].items():
            layer[name] = _merged(base[name], ab["a"], ab["b"], scale)
        return layer
    return hook


def merge_lora(params: Dict[str, Any], adapters: Dict[str, Any],
               scale: float = 1.0) -> Dict[str, Any]:
    """Fold the adapters into plain base-layout params (the hook is no
    longer needed). One batched product per target over the layer axis;
    the untouched leaves are the source tree's own tensors."""
    layers = dict(params["layers"])
    for name, ab in adapters.items():
        layers[name] = _merged(layers[name], ab["a"], ab["b"], scale)
    return {**params, "layers": layers}


def stack_adapters(adapters: List[Dict[str, Any]]) -> Dict[str, Any]:
    """[{name: {a: [L, d, r], b: [L, r, o]}}, ...] -> {name: {a:
    [L, NA, d, r], b: [L, NA, r, o]}}: the multi-LoRA bank. The adapter
    axis rides after the layer axis, so a layer's slice carries the
    whole bank; all adapters must share targets and rank."""
    if not adapters:
        raise ValueError("stack_adapters needs at least one adapter")
    names = set(adapters[0])
    for ad in adapters[1:]:
        if set(ad) != names:
            raise ValueError("adapters disagree on target sets")
    return {name: {k: torch.stack([ad[name][k] for ad in adapters], dim=1)
                   for k in ("a", "b")}
            for name in names}


def multi_lora_params(params: Dict[str, Any],
                      bank: Dict[str, Any]) -> Dict[str, Any]:
    """Pack the bank under the reserved ``_mlora`` key of the layer
    tree; ``transformer.forward`` slices it per layer and applies each
    row's adapter (``mlora_idx`` [B], -1 = base)."""
    return {**params, "layers": {**params["layers"], MLORA_KEY: bank}}


def bank_size(bank: Dict[str, Any]) -> int:
    """Adapters in a bank (the NA axis of its leaves)."""
    first = next(iter(bank.values()))
    return int(first["a"].shape[1])


def lora_param_specs(*a, **kw):
    raise NotImplementedError(f"lora_param_specs: {TODO_MESH}")


def lora_loss(*a, **kw):
    raise NotImplementedError(f"lora_loss: {TODO_LORA_TRAIN}")


def make_lora_fit_step(*a, **kw):
    raise NotImplementedError(f"make_lora_fit_step: {TODO_LORA_TRAIN}")


def lora_train_step(*a, **kw):
    raise NotImplementedError(f"lora_train_step: {TODO_LORA_TRAIN}")
