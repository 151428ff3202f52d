from quantizedattention_tpu_torch.ops.api import (
    flash_attention_bf16,
    sage_attention_int8,
    sage_attention_int8_inference,
)
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
from quantizedattention_tpu_torch.ops.int8_bwd import (
    Int8BwdOperands,
    int8_attention_bwd,
    int8_attention_bwd_plain,
    int8_bwd_dkv,
    int8_bwd_dkv_plain,
    int8_bwd_dq,
    int8_bwd_dq_plain,
    int8_bwd_operands,
)
from quantizedattention_tpu_torch.ops.int4_linear import (
    int4_weight_matmul,
    int4_weight_matmul_plain,
    pack_int4,
    unpack_int4,
)
from quantizedattention_tpu_torch.ops.int8_fwd import (
    int8_attention_fwd,
    int8_attention_fwd_from_quantized,
    int8_attention_fwd_fused,
    int8_attention_fwd_fused_plain,
    int8_attention_fwd_from_quantized_plain,
    quantize_qkv,
    quantize_qkv_plain,
)
from quantizedattention_tpu_torch.ops.int8_linear import (
    int8_weight_matmul,
    int8_weight_matmul_plain,
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
    "Int8BwdOperands",
    "int4_weight_matmul",
    "int4_weight_matmul_plain",
    "int8_attention_bwd",
    "int8_attention_bwd_plain",
    "int8_attention_fwd",
    "int8_attention_fwd_from_quantized",
    "int8_attention_fwd_from_quantized_plain",
    "int8_attention_fwd_fused",
    "int8_attention_fwd_fused_plain",
    "int8_bwd_dkv",
    "int8_bwd_dkv_plain",
    "int8_bwd_dq",
    "int8_bwd_dq_plain",
    "int8_bwd_operands",
    "int8_weight_matmul",
    "int8_weight_matmul_plain",
    "pack_int4",
    "quantize_qkv",
    "quantize_qkv_plain",
    "sage_attention_int8",
    "sage_attention_int8_inference",
    "unpack_int4",
    "LOG2_E",
    "MASK_VALUE",
    "pad_tokens",
    "qk_scales",
    "tile_mask",
]
