"""tpushare_torch.ops — numeric primitives of the port.

Plain PyTorch for the elementwise passes; hand-written Hopper kernels
(``csrc/``, built by ``ops/_build.py``) for attention, each with its
plain PyTorch version beside it.
"""

from tpushare_torch.ops.attention import attention, mha_reference
from tpushare_torch.ops.flash_attention import (
    flash_attention, paged_flash_decode,
)
from tpushare_torch.ops.norms import layer_norm, rms_norm
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding

__all__ = [
    "attention", "mha_reference", "flash_attention", "paged_flash_decode",
    "layer_norm", "rms_norm", "apply_rotary", "rotary_embedding",
]
