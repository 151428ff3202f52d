"""quantizedattention_tpu_torch: the PyTorch + CUDA port of quantizedattention_tpu.

The serving path runs on hand-written Hopper (sm_90a) kernels: the
corrected-bf16 flash-attention forward (prefill) and int8-KV-cache decode
attention, each beside a plain PyTorch version that CPU tensors take. The
kernels are built from `csrc/` with nvcc on first use (`_build.py`).

Public surface:
  flash_attention_bf16(q, k, v, causal)      forward only (no backward yet)
  flash_attention_fwd / decode_attention     the kernel wrappers
  models.TransformerConfig, init_transformer, generate, params_from_jax
  serve.ServingEngine                        continuous batching, one device
"""

__version__ = "0.1.0"

from quantizedattention_tpu_torch.ops import (
    flash_attention_bf16,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from quantizedattention_tpu_torch.parallel import decode_attention, decode_attention_plain

__all__ = [
    "flash_attention_bf16",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "decode_attention",
    "decode_attention_plain",
]
