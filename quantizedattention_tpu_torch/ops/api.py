"""Public attention entry points.

Counterpart of quantizedattention_tpu/ops/api.py. Only the inference forward
of the corrected-bf16 attention is ported so far; its backward (the
dK/dV and dQ kernels behind a torch.autograd.Function) comes with training.
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd


def flash_attention_bf16(q, k, v, causal: bool = False, sm_scale: float | None = None,
                         correction: str = "eps") -> torch.Tensor:
    """Corrected-bf16 flash attention, forward only. q [b, h, t, d], k/v
    [b, h_kv, s, d]; returns O f32 [b, h, t, d] (lse dropped)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("flash_attention_bf16 has no backward yet (forward only)")
    o, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               correction=correction)
    return o
