from quantizedattention_tpu_torch.quantize.bf16_correction import EPS_BIAS
from quantizedattention_tpu_torch.quantize.weights import embedding_lookup, mm

__all__ = ["EPS_BIAS", "embedding_lookup", "mm"]
