from quantizedattention_tpu_torch.reference.attention import (
    reference_attention,
    reference_attention_vjp,
)

__all__ = ["reference_attention", "reference_attention_vjp"]
