from quantizedattention_tpu_torch.models.convert import params_from_jax
from quantizedattention_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_horizon_batched,
    decode_step_batched,
    generate,
    init_transformer,
    prefill_batched,
    prefill_slot,
    prefill_slots,
    rmsnorm,
    rope,
    sample_token,
    transformer_forward,
)

__all__ = [
    "TransformerConfig",
    "decode_horizon_batched",
    "decode_step_batched",
    "generate",
    "init_transformer",
    "params_from_jax",
    "prefill_batched",
    "prefill_slot",
    "prefill_slots",
    "rmsnorm",
    "rope",
    "sample_token",
    "transformer_forward",
]
