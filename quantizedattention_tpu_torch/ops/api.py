"""Public attention entry points.

Counterpart of quantizedattention_tpu/ops/api.py. `flash_attention_bf16` is
a torch.autograd.Function, as the JAX package's custom_vjp
(ops/api.py:51-104): the corrected-bf16 forward (B1) saves the residuals
(q, k, v, O, lse) exactly as the caller passed q, k and v in, and the
backward runs the dK/dV and dQ kernels (B2, B3) from them.
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd


class _FlashAttentionBF16(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, correction, bwd_exact):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                     correction=correction)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, bwd_exact)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, bwd_exact = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=sm_scale, fast=not bwd_exact)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention_bf16(q, k, v, causal: bool = False, sm_scale: float | None = None,
                         correction: str = "eps", bwd_exact: bool = False) -> torch.Tensor:
    """Corrected-bf16 flash attention, differentiable.

    q [b, h, t, d], k/v [b, h_kv, s, d] (h a multiple of h_kv); returns O f32
    [b, h, t, d] (lse dropped). The backward rounds its matmul operands to
    bf16 and accumulates in f32 (`bwd_exact=False`, the TPU's DEFAULT
    precision), or runs fp32 throughout (`bwd_exact=True`); in both modes P
    is recomputed against the lse of the bf16 forward.
    """
    return _FlashAttentionBF16.apply(q, k, v, causal, sm_scale, correction, bwd_exact)
