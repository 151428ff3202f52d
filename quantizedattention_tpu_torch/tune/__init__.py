from quantizedattention_tpu_torch.tune.config import INT8_DEFAULT, BlockConfig, int8_grain

__all__ = ["BlockConfig", "INT8_DEFAULT", "int8_grain"]
