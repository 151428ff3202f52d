"""Tangent-only attention, tO given (O, lse): CUDA kernel and plain version.

Counterpart of quantizedattention_tpu/ops/jvp_tangent.py (B10), the tangent
rule of `attention_jvp` under forward-mode AD. With lse known, p =
exp2(S - lse) is final on first touch, so no running max is kept:

    acc += (p o tS) V + p tV,   r += rowsum(p o tS),   tO = acc - r o O

S and tS as in ops/jvp_fwd (masked entries give p = 0 explicitly); `fast`
rounds q, k, v, tq, tk, tv, p and p o tS to bf16 where they enter a product.
CUDA tensors launch the hand-written Hopper kernel (csrc/jvp.cu); CPU tensors
run `attention_tangent_fwd_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.common import qk_scales, tile_mask
from quantizedattention_tpu_torch.ops.jvp_fwd import check_jvp_args, kernel_args, rounder
from quantizedattention_tpu_torch.utils.runtime import check_status


def _check_residuals(q, o, lse):
    if o.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"want o {tuple(q.shape)} and lse {tuple(q.shape[:3])}; got "
                         f"{tuple(o.shape)}, {tuple(lse.shape)}")


def attention_tangent_fwd_plain(q, k, v, o, lse, tq, tk, tv, causal=False, sm_scale=None,
                                fast=False):
    """B10's arithmetic in plain PyTorch over whole rows: tO f32."""
    check_jvp_args(q, k, v, tq, tk, tv)
    _check_residuals(q, o, lse)
    t, s, d = q.shape[2], k.shape[2], q.shape[3]
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    rd = rounder(fast)
    qf, kf, vf, tqf, tkf, tvf = (rd(x.float()) for x in (q, k, v, tq, tk, tv))
    mask = tile_mask(0, 0, t, s, s, causal, device=q.device)
    p = torch.where(mask, torch.exp2((qf @ kf.transpose(-1, -2)) * qk_scale
                                     - lse.float()[..., None]), 0.0)
    hp = p * ((tqf @ kf.transpose(-1, -2) + qf @ tkf.transpose(-1, -2)) * sm_scale)
    acc = rd(hp) @ vf + rd(p) @ tvf
    return acc - hp.sum(-1, keepdim=True) * o.float()


@functools.cache
def _kernel():
    fn = load_kernel("jvp").qa_jvp_tangent
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, o, lse, tq, tk, tv, causal, sm_scale, fast):
    b, h, t, d = q.shape
    s = k.shape[2]
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    ins, dev = kernel_args(b, h, d, q, k, v, tq, tk, tv, o, lse)
    to = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    status = _kernel()(
        *(x.data_ptr() for x in ins), to.data_ptr(), b * h, t, s, int(causal), int(fast),
        sm_scale, qk_scale, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "jvp_tangent")
    attention_tangent_fwd.launches += 1
    return to


# A dispatcher op, so that torch.func transforms unwrap their tensors before
# the kernel reads raw pointers: `attention_jvp`'s forward-mode rule calls
# this under torch.func.jvp, where its operands are functorch wrappers with
# no storage of their own. No autograd formula is registered, so reverse
# mode through tO raises (the JAX package's attention_jvp refuses
# grad-of-jvp too).
@torch.library.custom_op("quantizedattention_tpu_torch::attention_tangent_fwd", mutates_args=())
def _tangent_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                lse: torch.Tensor, tq: torch.Tensor, tk: torch.Tensor, tv: torch.Tensor,
                causal: bool, sm_scale: float, fast: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_tangent_fwd_plain(q, k, v, o, lse, tq, tk, tv, causal, sm_scale, fast)
    return _launch(q, k, v, o, lse, tq, tk, tv, causal, sm_scale, fast)


@_tangent_op.register_fake
def _(q, k, v, o, lse, tq, tk, tv, causal, sm_scale, fast):
    return torch.empty(q.shape, dtype=torch.float32, device=q.device)


def attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv, causal=False, sm_scale=None,
                          fast=False):
    """B10: tO f32 [b, h, t, d] for tangents (tq, tk, tv) at (q, k, v), given
    the forward's O [b, h, t, d] and exp2-domain lse [b, h, t].

    CUDA tensors launch the kernel (head_dim 64) or raise; CPU tensors take
    `attention_tangent_fwd_plain`. Both go through a dispatcher op, which
    torch.func transforms see through. `attention_tangent_fwd.launches`
    counts launches.
    """
    check_jvp_args(q, k, v, tq, tk, tv)
    _check_residuals(q, o, lse)
    sm_scale, _ = qk_scales(q.shape[3], sm_scale)
    return _tangent_op(q, k, v, o, lse, tq, tk, tv, bool(causal), float(sm_scale), bool(fast))


attention_tangent_fwd.launches = 0
