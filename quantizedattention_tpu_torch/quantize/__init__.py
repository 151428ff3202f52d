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
from quantizedattention_tpu_torch.quantize.weights import embedding_lookup, mm

__all__ = [
    "EPS_BIAS",
    "QuantJob",
    "absmax_scale",
    "dequantize_int8",
    "embedding_lookup",
    "k_smooth",
    "mm",
    "quant_int8",
    "quant_int8_plain",
    "quantize_int8",
    "quantize_int8_blocks",
]
