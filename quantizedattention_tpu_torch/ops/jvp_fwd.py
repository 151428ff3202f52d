"""Forward-mode (JVP) attention, (O, tO) in one pass: CUDA kernel and plain version.

Counterpart of quantizedattention_tpu/ops/jvp_fwd.py (B9). For q, k, v and
their tangents tq, tk, tv (all [b, h, t|s, d], one head count),
`attention_jvp_fwd` returns (O, tO, lse, mu) in f32: lse = m + log2(l) in the
exp2 domain and mu = rowsum(P o tS) with P normalized, the residuals the
second-order backward (ops/jvp_bwd) reuses. CUDA tensors launch the
hand-written Hopper kernel (csrc/jvp.cu); CPU tensors run
`attention_jvp_fwd_plain`, the same arithmetic over whole rows.

Numerics shared by both: S = (Q K^T) * qk_scale (exp2 domain), masked
(causal k <= q, and k < s) to MASK_VALUE; tS = (tQ K^T + Q tK^T) * sm_scale
(natural domain); P = exp2(S - m), 0 where masked, with no eps bias;
H = P o tS; O = (P V) / l, tO = (P tV + H V - r O) / l with l, r the row
sums of P and H. `fast=True` rounds every product's operands to bf16, as the
TPU's DEFAULT-precision dots do (q, k, v, tq, tk, tv, P and H), and
accumulates in f32; the row sums use the unrounded P and H. The kernel runs
the online softmax over 32-key tiles, so in fast mode P is rounded against
the running max, the plain version's against the row's final max.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.common import MASK_VALUE, qk_scales, tile_mask
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

HEAD_DIM = 64  # the JVP kernels' compiled head dim


def check_jvp_args(q, k, v, tq, tk, tv) -> None:
    """The JVP family's shapes: q/tq [b, h, t, d], k/v/tk/tv [b, h, s, d]."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"want q [b,h,t,d], k/v [b,h,s,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"the JVP family is single-head-count only: q has {q.shape[1]} heads but k/v "
            f"have {k.shape[1]}; GQA is unsupported here, repeat k/v to the q head count")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch/head_dim")
    if tq.shape != q.shape or tk.shape != k.shape or tv.shape != v.shape:
        raise ValueError("each tangent must have its primal's shape")
    if k.shape[2] == 0:
        raise ValueError("kv length must be positive")


def rounder(fast: bool):
    """x -> x rounded to bf16 and back (fast mode), or x itself."""
    if fast:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def kernel_args(b: int, h: int, d: int, *tensors):
    """Check what the JVP kernels take; returns the tensors as contiguous f32
    and their device."""
    if d != HEAD_DIM or b * h > 65535:
        raise ValueError(f"the JVP kernels take head_dim {HEAD_DIM}, b*h <= 65535; got "
                         f"d={d}, b*h={b * h}")
    out = [x.float().contiguous() for x in tensors]
    return out, require_cuda(*out)


def attention_jvp_fwd_plain(q, k, v, tq, tk, tv, causal=False, sm_scale=None, fast=False):
    """B9's arithmetic in plain PyTorch over whole rows: (O, tO, lse, mu)."""
    check_jvp_args(q, k, v, tq, tk, tv)
    t, s, d = q.shape[2], k.shape[2], q.shape[3]
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    rd = rounder(fast)
    qf, kf, vf, tqf, tkf, tvf = (rd(x.float()) for x in (q, k, v, tq, tk, tv))
    mask = tile_mask(0, 0, t, s, s, causal, device=q.device)
    scores = torch.where(mask, (qf @ kf.transpose(-1, -2)) * qk_scale, MASK_VALUE)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp2(scores - m), 0.0)
    ts = (tqf @ kf.transpose(-1, -2) + qf @ tkf.transpose(-1, -2)) * sm_scale
    hp = p * ts
    l = p.sum(-1, keepdim=True)
    r = hp.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (rd(p) @ vf) / l_safe
    to = (rd(p) @ tvf + rd(hp) @ vf - r * o) / l_safe
    return o, to, (m + torch.log2(l_safe))[..., 0], (r / l_safe)[..., 0]


@functools.cache
def _kernel():
    fn = load_kernel("jvp").qa_jvp_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_jvp_fwd(q, k, v, tq, tk, tv, causal=False, sm_scale=None, fast=False):
    """B9: (O, tO f32 [b, h, t, d], lse, mu f32 [b, h, t]).

    CUDA tensors launch the kernel (head_dim 64) or raise; CPU tensors take
    `attention_jvp_fwd_plain`. `attention_jvp_fwd.launches` counts launches.
    """
    if q.device.type == "cpu":
        return attention_jvp_fwd_plain(q, k, v, tq, tk, tv, causal, sm_scale, fast)
    check_jvp_args(q, k, v, tq, tk, tv)
    b, h, t, d = q.shape
    s = k.shape[2]
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    ins, dev = kernel_args(b, h, d, q, k, v, tq, tk, tv)
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    to = torch.empty_like(o)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    mu = torch.empty_like(lse)
    status = _kernel()(
        *(x.data_ptr() for x in ins), o.data_ptr(), to.data_ptr(), lse.data_ptr(), mu.data_ptr(),
        b * h, t, s, int(causal), int(fast), sm_scale, qk_scale,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "jvp_fwd")
    attention_jvp_fwd.launches += 1
    return o, to, lse, mu


attention_jvp_fwd.launches = 0
