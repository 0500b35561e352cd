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

Training (``lora_loss``, ``lora_train_step``, ``make_lora_fit_step``
for ``trainer.fit``): only the adapters are differentiated; the frozen
base's leaves never require a gradient, so no base gradient is ever
made (the reference differentiates ``argnums=1``). The update is the
shared SGD rule (``training._sgd_update``: f32 math, each leaf keeps its
dtype), in place on the adapter tree.

``lora_param_specs`` places an adapter tree on a serving mesh (the
Megatron split of its targets); a multi-LoRA bank on a mesh is refused
by the slot servers, as in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from tpushare_torch.models.training import (_sgd_update, value_and_grad,
                                            xent_loss)
from tpushare_torch.models.transformer import TransformerConfig

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


def lora_param_specs(cfg: TransformerConfig,
                     targets: Tuple[str, ...] = DEFAULT_TARGETS,
                     *, tp: str = "tp",
                     fsdp: Optional[str] = None) -> Dict[str, Any]:
    """Spec tree of an adapter tree (reference ``:155-171``), matching
    ``transformer.param_specs``' Megatron layout: column-parallel
    targets split B's out axis over tp (A replicated like the base's
    d_model axis); row-parallel targets (wo, w_down) split A's in axis
    over tp. The rank axis is never split. A multi-LoRA bank on a mesh
    stays refused, as the reference refuses it."""
    del cfg
    from tpushare_torch.parallel.sharding import P
    col = {"wq", "wk", "wv", "w_gate", "w_up"}
    specs: Dict[str, Any] = {}
    for name in targets:
        if name in col:
            specs[name] = {"a": P(None, fsdp, None), "b": P(None, None, tp)}
        else:                                   # wo, w_down: row-parallel
            specs[name] = {"a": P(None, tp, None), "b": P(None, None, fsdp)}
    return specs


def lora_loss(base: Dict[str, Any], adapters: Dict[str, Any],
              tokens: torch.Tensor, cfg: TransformerConfig, *,
              scale: float = 1.0, inner=None,
              attn_impl: str = "auto") -> torch.Tensor:
    """Next-token cross-entropy of the hooked (base + delta) model over
    tokens [B, S+1]."""
    return xent_loss(lora_params(base, adapters), tokens[:, :-1],
                     tokens[:, 1:], cfg, attn_impl=attn_impl,
                     layers_hook=lora_hook(scale, inner=inner))


def lora_train_step(base: Dict[str, Any], adapters: Dict[str, Any],
                    tokens: torch.Tensor, cfg: TransformerConfig, *,
                    lr: float = 1e-3, scale: float = 1.0,
                    attn_impl: str = "auto"
                    ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One SGD step on the ADAPTERS only: (adapters, loss). Only the
    adapter tree is differentiated (``training.value_and_grad``); the
    base's tensors are used as they are and require no gradient, so the
    backward computes no base gradient. The update is in place."""
    loss, grads = value_and_grad(
        lambda ads: lora_loss(base, ads, tokens, cfg, scale=scale,
                              attn_impl=attn_impl), adapters)
    return _sgd_update(adapters, grads, lr), loss


def make_lora_fit_step(base: Dict[str, Any], cfg: TransformerConfig, *,
                       lr: float = 1e-3, scale: float = 1.0,
                       attn_impl: str = "auto"):
    """``trainer.fit`` step with the ADAPTERS as the trained state:
    (adapters, opt_state, tokens) -> (adapters, opt_state, loss). SGD
    keeps no optimizer state: pass {} and the trainer checkpoints
    (adapters, {}, step), so a preempted LoRA tenant resumes bit for bit
    like any other."""
    def step(adapters, opt_state, tokens):
        adapters, loss = lora_train_step(base, adapters, tokens, cfg, lr=lr,
                                         scale=scale, attn_impl=attn_impl)
        return adapters, opt_state, loss
    return step
