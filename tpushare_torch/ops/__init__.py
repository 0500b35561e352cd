"""tpushare_torch.ops — numeric primitives of the port.

Plain PyTorch for the elementwise passes; hand-written Hopper kernels
(``csrc/``, built by ``ops/_build.py``) for attention, its gradient
and the int8 expert FFN, each with its plain PyTorch version beside it.
"""

from tpushare_torch.ops.attention import attention, mha_reference
from tpushare_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_partial,
    flash_decode, paged_flash_decode, paged_flash_verify,
)
from tpushare_torch.ops.q8_expert import q8_expert_ffn
from tpushare_torch.ops.norms import layer_norm, rms_norm
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding

__all__ = [
    "attention", "mha_reference", "flash_attention",
    "flash_attention_partial", "flash_attention_bwd", "paged_flash_decode",
    "paged_flash_verify", "flash_decode", "q8_expert_ffn",
    "layer_norm", "rms_norm", "apply_rotary", "rotary_embedding",
]
