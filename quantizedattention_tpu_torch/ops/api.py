"""Public attention entry points.

Counterpart of quantizedattention_tpu/ops/api.py. Each is a
torch.autograd.Function, as the JAX package's custom_vjp:
- `flash_attention_bf16` (ops/api.py:51-104): the corrected-bf16 forward
  (B1) saves the residuals (q, k, v, O, lse) exactly as the caller passed
  q, k and v in, and the backward runs the dK/dV and dQ kernels (B2, B3).
- `sage_attention_int8` (ops/api.py:111-167): K-smoothing, then the int8
  forward (B4 quantizes, B5 attends); it saves only what the JAX package
  saves, the int8 payloads and scales, k_mean, O and lse, and the backward
  runs the int8 dK/dV and dQ kernels (B7, B8) from them. Where no gradient
  is wanted (under torch.no_grad, as prefill runs) autograd records no
  graph, and the residuals are freed when the call returns.
- `sage_attention_int8_inference` (ops/api.py:170-196): forward only, the
  fused int8 kernel (B6), which quantizes inside the kernel.
- `attention_jvp` (ops/api.py:199-300): fp32 attention with both AD modes.
  The forward is B1's fp32 mode and saves (q, k, v, O, lse); `backward` runs
  the exact flash backward (B2, B3); `jvp`, the forward-mode rule, runs the
  tangent kernel (B10). One new-style Function (`setup_context`,
  `save_for_forward`) gives both, so torch.func.jvp and
  torch.autograd.forward_ad work on it; the JAX package's custom_transpose
  detour is not needed.
- `attention_value_and_jvp` (ops/api.py:303-364): (O, tO) of six inputs in
  one pass (B9), differentiable in reverse mode through the second-order
  backward (B11, B12): the rCM distillation primitive.
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd, flash_attention_fwd_fp32
from quantizedattention_tpu_torch.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu_torch.ops.int8_fwd import int8_attention_fwd, int8_attention_fwd_fused
from quantizedattention_tpu_torch.ops.jvp_bwd import attention_jvp_bwd
from quantizedattention_tpu_torch.ops.jvp_fwd import attention_jvp_fwd, check_jvp_args
from quantizedattention_tpu_torch.ops.jvp_tangent import attention_tangent_fwd


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


def sage_attention_int8_inference(q, k, v, causal: bool = False, sm_scale: float | None = None,
                                  smooth_k: bool = True) -> torch.Tensor:
    """Forward-only int8 attention with the quantization inside the kernel
    (B6): no int8 payload or scale table is kept, and nothing is
    differentiable. Same numerics as `sage_attention_int8`'s forward at the
    same grain, except for the K mean: smooth_k=True subtracts the per-head K
    token mean taken, as the JAX package's `jnp.mean` gives it, in k's own
    dtype (bf16 inputs give a bf16 mean), where `sage_attention_int8` takes
    it in f32. Returns O f32 [b, h, t, d].
    """
    k_mean = k.float().mean(dim=-2, keepdim=True).to(k.dtype) if smooth_k else None
    return int8_attention_fwd_fused(q, k, v, causal=causal, sm_scale=sm_scale, k_sub=k_mean)[0]


class _AttentionJVP(torch.autograd.Function):

    @staticmethod
    def forward(q, k, v, causal, sm_scale):
        return flash_attention_fwd_fp32(q, k, v, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, sm_scale = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.save_for_forward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale,
                                         fast=False)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None

    @staticmethod
    def jvp(ctx, tq, tk, tv, _tcausal, _tscale):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale = ctx.args
        tq, tk, tv = (torch.zeros_like(x) if tx is None else tx
                      for x, tx in ((q, tq), (k, tk), (v, tv)))
        to = attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv, causal=causal, sm_scale=sm_scale)
        return to, None


def attention_jvp(q, k, v, causal: bool = False, sm_scale: float | None = None) -> torch.Tensor:
    """fp32 attention with forward-mode AD (the tangent kernel, B10) and
    reverse-mode AD (the exact flash backward, B2 + B3).

    q/k/v [b, h, t|s, d], one head count (GQA raises ValueError, as the
    tangent kernel is single-head-count). Returns O f32 [b, h, t, d].
    torch.func.jvp(attention_jvp, (q, k, v), (tq, tk, tv)) gives (O, tO).
    Gradients of losses over tO need `attention_value_and_jvp`: autograd
    does not differentiate a Function's jvp rule.
    """
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"attention_jvp is single-head-count only: q has {q.shape[1]} heads "
                         f"but k/v have {k.shape[1]}; repeat k/v first")
    return _AttentionJVP.apply(q, k, v, causal, sm_scale)[0]


class _AttentionValueAndJVP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, tq, tk, tv, causal, sm_scale, fast):
        o, to, lse, mu = attention_jvp_fwd(q, k, v, tq, tk, tv, causal=causal,
                                           sm_scale=sm_scale, fast=fast)
        ctx.save_for_backward(q, k, v, tq, tk, tv, o, to, lse, mu)
        ctx.args = (causal, sm_scale, fast)
        return o, to

    @staticmethod
    def backward(ctx, do, dto):
        causal, sm_scale, fast = ctx.args
        grads = attention_jvp_bwd(*ctx.saved_tensors, do, dto, causal=causal, sm_scale=sm_scale,
                                  fast=fast)
        return (*grads, None, None, None)


def attention_value_and_jvp(q, k, v, tq, tk, tv, causal: bool = False,
                            sm_scale: float | None = None, fast: bool = False):
    """(O, tO) in one streaming pass (B9), differentiable in reverse mode with
    respect to all six inputs through the second-order backward (B11, B12).

    Inputs [b, h, t|s, d], one head count, cast to f32 first, so gradients
    come back in the inputs' dtypes. `fast=True` rounds every product's
    operands to bf16 with f32 accumulation, forward and backward; the
    default is fp32 throughout. Returns (O, tO) f32 [b, h, t, d].
    """
    check_jvp_args(q, k, v, tq, tk, tv)
    return _AttentionValueAndJVP.apply(*(x.float() for x in (q, k, v, tq, tk, tv)), causal,
                                       sm_scale, fast)
