"""tpushare_torch — the PyTorch/CUDA port of tpushare's workload harness.

The JAX package (``tpushare``) is the reference; this package mirrors
its module names (``ops/attention.py``, ``models/paged.py``, ...) so a
reader can find each module's counterpart. It imports ``torch`` and
never ``jax`` or anything of ``tpushare``: what it needs from there it
keeps as its own copy.

Device rule: every entry point runs on the CUDA card unless the caller
passes ``device="cpu"``. With no card and no device given it raises —
there is no silent CPU fallback. Kernel wrappers launch their
hand-written Hopper kernel on CUDA tensors and use their plain PyTorch
version only on CPU tensors.
"""

from __future__ import annotations

from typing import Union

# torch is imported on first use, not here: the static-analysis gate
# (tpushare_torch.analysis) imports this package and needs only the
# standard library.
DeviceLike = Union[str, "torch.device", None]


def resolve_device(device: DeviceLike = None) -> "torch.device":
    """The device an entry point runs on: ``device`` when given, else
    the first CUDA card. Raises when no device was given and CUDA is
    absent, so a missing card can never turn into a quiet CPU run."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpushare_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


__all__ = ["resolve_device", "DeviceLike"]
