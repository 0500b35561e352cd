"""Weight bridge from the JAX package to the port.

``params_from_jax`` takes the tree ``tpushare.models.transformer.
init_params`` returns (stacked ``[L, ...]`` leaves, any array type that
numpy can read — JAX arrays included) and returns the port's params:
the same nested dict of torch tensors on a given device and dtype.
``config_from_jax`` copies a JAX ``TransformerConfig``'s fields into the
port's. Neither imports JAX: they read arrays through numpy and config
fields by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
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
    """Numpy-readable leaves -> torch tensors on ``device``. Leaves go
    through f32 (numpy has no bfloat16 that torch reads) and are cast
    to ``dtype`` (default: each leaf's own dtype)."""
    dev = resolve_device(device)

    def conv(leaf):
        if isinstance(leaf, dict):
            return {k: conv(v) for k, v in leaf.items()}
        arr = np.asarray(leaf)
        target = dtype or _torch_dtype(arr.dtype)
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=dev, dtype=target)

    return conv(tree)


def config_from_jax(cfg) -> TransformerConfig:
    """The port's config with every field of a JAX TransformerConfig."""
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(TransformerConfig)}
    kw["dtype"] = _torch_dtype(kw["dtype"])
    return TransformerConfig(**kw)
