"""Public attention entry points.

Counterpart of quantizedattention_tpu/ops/api.py. Each is a
torch.autograd.Function, as the JAX package's custom_vjp:
- `flash_attention_bf16` (ops/api.py:51-104): the corrected-bf16 forward
  (B1) saves the residuals (q, k, v, O, lse) exactly as the caller passed
  q, k and v in, and the backward runs the dK/dV and dQ kernels (B2, B3).
- `sage_attention_int8` (ops/api.py:111-167): K-smoothing, then the int8
  forward (B4 quantizes, B5 attends); it saves only what the JAX package
  saves, the int8 payloads and scales, k_mean, O and lse, and the backward
  runs the int8 dK/dV and dQ kernels (B7, B8) from them.
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu_torch.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu_torch.ops.int8_fwd import int8_attention_fwd


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


class _SageAttentionInt8(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        # the K-smoothing mean over tokens, in f32; the shift itself is
        # applied inside the quantization kernel
        k_mean = k.mean(dim=-2, keepdim=True)
        o, lse, residuals = int8_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                               k_sub=k_mean)
        (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
        ctx.save_for_backward(q_i8, sq, k_i8, sk, v_i8, sv, k_mean, o, lse)
        ctx.args = ((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]), causal,
                    sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q_i8, sq, k_i8, sk, v_i8, sv, k_mean, o, lse = ctx.saved_tensors
        dims, causal, sm_scale = ctx.args
        dq, dk, dv = int8_attention_bwd(((q_i8, sq), (k_i8, sk), (v_i8, sv)), k_mean, o, lse,
                                        do, dims, causal=causal, sm_scale=sm_scale)
        return dq, dk, dv, None, None


def sage_attention_int8(q, k, v, causal: bool = False,
                        sm_scale: float | None = None) -> torch.Tensor:
    """Int8 attention (K-smoothed, quantized per token grain), differentiable
    with an int8 backward.

    q [b, h, t, d], k/v [b, h_kv, s, d] (h a multiple of h_kv). The primals
    are carried in f32, as the JAX package does, so the gradients come back
    in the inputs' dtypes through the casts. Returns O f32 [b, h, t, d].
    """
    return _SageAttentionInt8.apply(q.float(), k.float(), v.float(), causal, sm_scale)
