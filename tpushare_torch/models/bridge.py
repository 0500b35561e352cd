"""Weight bridge from the JAX package to the port.

``params_from_jax`` takes the tree ``tpushare.models.transformer.
init_params`` returns (stacked ``[L, ...]`` leaves, any array type that
numpy can read — JAX arrays included) and returns the port's params:
the same nested dict of torch tensors on a given device and dtype.
A ``quantize_params`` tree bridges too: its ``#q8`` leaves stay int8
and its ``#scale`` leaves stay f32, whatever ``dtype`` asks for the
rest; MoE expert stacks ([L, E, ...] leaves, int8 or not) bridge the
same way. ``config_from_jax`` / ``moe_config_from_jax`` copy a JAX
``TransformerConfig``'s / ``MoEConfig``'s fields into the port's.
``bert_params_from_jax`` / ``bert_config_from_jax`` do the same for
``tpushare.models.bert``'s encoder. ``adapters_from_jax`` carries a
LoRA adapter tree (``lora.init_lora``) or a stacked multi-LoRA bank
(``lora.stack_adapters``) across. ``opt_state_from_jax`` carries an
AdamW state (``adamw_init`` / ``apply_adamw``'s mu, nu and count)
across, so both packages can train on from one non-zero optimizer
state. None imports JAX: they read
arrays through numpy and config fields by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.models.bert import BertConfig
from tpushare_torch.models.moe import MoEConfig
from tpushare_torch.models.transformer import TransformerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"no torch dtype for {name!r}")
    return _DTYPES[name]


def params_from_jax(tree: Dict[str, Any], *, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Numpy-readable leaves -> torch tensors on ``device``. Float
    leaves go through f32 (numpy has no bfloat16 that torch reads) and
    are cast to ``dtype`` (default: each leaf's own dtype); int8 weight
    leaves (``#q8``) are copied as int8 and their ``#scale`` leaves kept
    f32."""
    dev = resolve_device(device)

    def conv(leaf, key=""):
        if isinstance(leaf, dict):
            return {k: conv(v, k) for k, v in leaf.items()}
        arr = np.asarray(leaf)
        if arr.dtype == np.int8:
            return torch.from_numpy(np.array(arr)).to(device=dev)
        target = (torch.float32 if key.endswith("#scale")
                  else dtype or _torch_dtype(arr.dtype))
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=dev, dtype=target)

    return conv(tree)


def _fields_from_jax(cls, cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)}
    kw["dtype"] = _torch_dtype(kw["dtype"])
    return cls(**kw)


def config_from_jax(cfg) -> TransformerConfig:
    """The port's config with every field of a JAX TransformerConfig."""
    return _fields_from_jax(TransformerConfig, cfg)


def moe_config_from_jax(cfg) -> MoEConfig:
    """The port's MoEConfig with every field of a JAX MoEConfig."""
    return _fields_from_jax(MoEConfig, cfg)


def bert_config_from_jax(cfg) -> BertConfig:
    """The port's BertConfig with every field of a JAX BertConfig."""
    return _fields_from_jax(BertConfig, cfg)


def bert_params_from_jax(tree: Dict[str, Any], *, device: DeviceLike = None,
                         dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A JAX ``bert.init_params`` tree (``embed``, ``layers`` stacked
    over L, ``pooler``) -> the port's ``models.bert`` params."""
    missing = {"embed", "layers", "pooler"} - set(tree)
    if missing:
        raise ValueError(f"not a BERT params tree: missing {sorted(missing)}")
    return params_from_jax(tree, device=device, dtype=dtype)


def adapters_from_jax(tree: Dict[str, Any], *, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A JAX LoRA adapter tree ({name: {"a": [L, d_in, r], "b": [L, r,
    d_out]}}) or a stacked bank (the same with [L, NA, ...] leaves) ->
    the port's ``models.lora`` layout on ``device`` (each leaf keeps its
    dtype unless ``dtype`` says otherwise)."""
    for name, ab in tree.items():
        if not isinstance(ab, dict) or set(ab) != {"a", "b"}:
            raise ValueError(f"not a LoRA adapter tree: {name!r} holds "
                             f"{sorted(ab) if isinstance(ab, dict) else ab}")
    return params_from_jax(tree, device=device, dtype=dtype)


def opt_state_from_jax(state: Dict[str, Any], *,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """A JAX AdamW state {"mu", "nu", "count"} -> the port's
    (``training.adamw_init`` layout): f32 moment trees and an int32 0-d
    count, on ``device``."""
    dev = resolve_device(device)
    return {"mu": params_from_jax(state["mu"], device=dev,
                                  dtype=torch.float32),
            "nu": params_from_jax(state["nu"], device=dev,
                                  dtype=torch.float32),
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32, device=dev)}
