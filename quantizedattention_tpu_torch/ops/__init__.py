from quantizedattention_tpu_torch.ops.api import flash_attention_bf16
from quantizedattention_tpu_torch.ops.common import (
    LOG2_E,
    MASK_VALUE,
    pad_tokens,
    qk_scales,
    tile_mask,
)
from quantizedattention_tpu_torch.ops.flash_bwd import (
    BwdOperands,
    bwd_operands,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
)
from quantizedattention_tpu_torch.ops.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)

__all__ = [
    "BwdOperands",
    "bwd_operands",
    "flash_attention_bf16",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "LOG2_E",
    "MASK_VALUE",
    "pad_tokens",
    "qk_scales",
    "tile_mask",
]
