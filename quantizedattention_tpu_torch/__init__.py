"""quantizedattention_tpu_torch: the PyTorch + CUDA port of quantizedattention_tpu.

The serving and training paths run on hand-written Hopper (sm_90a)
kernels: the corrected-bf16 flash-attention forward (prefill, training) and
its backward (dK/dV and dQ), the int8 SageAttention path for fine-tuning
(quantize, forward, dK/dV and dQ), and int8-KV-cache decode attention, each
beside a plain PyTorch version that CPU tensors take. The kernels are built from
`csrc/` with nvcc on first use (`_build.py`).

Public surface:
  flash_attention_bf16(q, k, v, causal)      differentiable (torch.autograd.Function)
  sage_attention_int8(q, k, v, causal)       int8, differentiable (int8 backward)
  flash_attention_fwd / flash_attention_bwd / decode_attention   the kernel wrappers
  models.TransformerConfig, init_transformer, generate, params_from_jax
  models.lm_loss, make_train_step            training, AdamW (attention "bf16" or "int8")
  serve.ServingEngine                        continuous batching, one device
"""

__version__ = "0.1.0"

from quantizedattention_tpu_torch.ops import (
    flash_attention_bf16,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    sage_attention_int8,
)
from quantizedattention_tpu_torch.parallel import decode_attention, decode_attention_plain

__all__ = [
    "flash_attention_bf16",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "decode_attention",
    "decode_attention_plain",
    "sage_attention_int8",
]
