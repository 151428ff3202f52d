"""quantizedattention_tpu_torch: the PyTorch + CUDA port of quantizedattention_tpu.

The serving and training paths run on hand-written Hopper (sm_90a)
kernels: the corrected-bf16 flash-attention forward (prefill, training) and
its backward (dK/dV and dQ), the int8 SageAttention path for fine-tuning and
int8 prefill (quantize, forward, dK/dV and dQ), the fused int8 inference
forward, int8-KV-cache decode attention, the weight-only int8 and int4
matmuls of quantized serving, and the JVP family of the rCM DiT step (the
fp32 flash forward, the fused (O, tO) forward, the tangent kernel and the
second-order backward), each beside a plain PyTorch version that CPU
tensors take. The kernels are built from
`csrc/` with nvcc on first use (`_build.py`).

Public surface:
  flash_attention_bf16(q, k, v, causal)      differentiable (torch.autograd.Function)
  sage_attention_int8(q, k, v, causal)       int8, differentiable (int8 backward)
  sage_attention_int8_inference(q, k, v, causal)   int8, forward only (fused kernel)
  attention_jvp(q, k, v, causal)             fp32, forward- and reverse-mode AD
  attention_value_and_jvp(q, k, v, tq, tk, tv, causal, fast)   (O, tO), reverse-mode AD
  flash_attention_fwd / flash_attention_bwd / decode_attention   the kernel wrappers
  models.TransformerConfig, init_transformer, generate, params_from_jax
  models.lm_loss, make_train_step            training, AdamW (attention "bf16" or "int8")
  serve.ServingEngine                        continuous batching, one device or, with
                                             mesh=, one process a rank (slots on data,
                                             heads on model); attention "bf16" or
                                             "int8"; weight_quant
  parallel.initialize_multihost, make_attention_mesh   process group and mesh
  parallel.launch.RankPool                   spawned ranks for multi-process runs
  quantize.quantize_lm_weights               weight-only int8 / int4 params
  models.DiTConfig, init_dit, dit_forward, dit_jvp_step, make_dit_rcm_step
                                             the DiT and its rCM step, one device
"""

__version__ = "0.1.0"

from quantizedattention_tpu_torch.ops import (
    attention_jvp,
    attention_jvp_fwd,
    attention_value_and_jvp,
    flash_attention_bf16,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    sage_attention_int8,
    sage_attention_int8_inference,
)
from quantizedattention_tpu_torch.parallel import decode_attention, decode_attention_plain

__all__ = [
    "attention_jvp",
    "attention_jvp_fwd",
    "attention_value_and_jvp",
    "flash_attention_bf16",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "decode_attention",
    "decode_attention_plain",
    "sage_attention_int8",
    "sage_attention_int8_inference",
]
