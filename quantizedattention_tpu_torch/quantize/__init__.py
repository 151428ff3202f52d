from quantizedattention_tpu_torch.quantize.bf16_correction import EPS_BIAS
from quantizedattention_tpu_torch.quantize.int8 import (
    QuantJob,
    absmax_scale,
    dequantize_int8,
    quant_int8,
    quant_int8_plain,
    quantize_int8,
    quantize_int8_blocks,
)
from quantizedattention_tpu_torch.quantize.smoothing import k_smooth
from quantizedattention_tpu_torch.quantize.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    embedding_lookup,
    mm,
    quantize_lm_weights,
    quantize_weight,
    quantize_weight_int4,
)

__all__ = [
    "EPS_BIAS",
    "QuantJob",
    "QuantizedWeight",
    "QuantizedWeight4",
    "absmax_scale",
    "dequantize_int8",
    "embedding_lookup",
    "k_smooth",
    "mm",
    "quant_int8",
    "quant_int8_plain",
    "quantize_int8",
    "quantize_int8_blocks",
    "quantize_lm_weights",
    "quantize_weight",
    "quantize_weight_int4",
]
