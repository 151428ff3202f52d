"""Forward-mode (JVP) attention, (O, tO) in one pass: CUDA kernel and plain version.

Counterpart of quantizedattention_tpu/ops/jvp_fwd.py (B9). For q, k, v and
their tangents tq, tk, tv (all [b, h, t|s, d], one head count),
`attention_jvp_fwd` returns (O, tO, lse, mu) in f32: lse = m + log2(l) in the
exp2 domain and mu = rowsum(P o tS) with P normalized, the residuals the
second-order backward (ops/jvp_bwd) reuses. CUDA tensors launch the
hand-written Hopper kernel (csrc/jvp.cu; in fast mode after one
`jvp_fwd_prep` launch that writes K, V, tK and tV as contiguous bf16, while
Q and tQ are read through their strides and rounded in the kernel); CPU
tensors run `attention_jvp_fwd_plain`, the same arithmetic over whole rows.

Numerics shared by both: S = (Q K^T) * qk_scale (exp2 domain), masked
(causal k <= q, and k < s) to MASK_VALUE; tS = (tQ K^T + Q tK^T) * sm_scale
(natural domain); P = exp2(S - m), 0 where masked, with no eps bias;
H = P o tS; O = (P V) / l, tO = (P tV + H V - r O) / l with l, r the row
sums of P and H. `fast=True` rounds every product's operands to bf16, as the
TPU's DEFAULT-precision dots do (q, k, v, tq, tk, tv, P and H), and
accumulates in f32; the row sums use the unrounded P and H. The kernel runs
the online softmax over key tiles (fast: `jvp_tiling.FWD_KEYS`, 64), so in
fast mode P and H are rounded against the running max, the plain version's
against the row's final max.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops import jvp_tiling
from quantizedattention_tpu_torch.ops.common import MASK_VALUE, qk_scales, tile_mask
from quantizedattention_tpu_torch.ops.flash_fwd import _kernel_ready, _strides
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
    """Check what the JVP kernels' contiguous entries take (B9, B11 and B12
    exact, B10 fast); returns the tensors as contiguous f32 and their
    device."""
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


_PTR, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # the C entries of csrc/jvp.cu this module calls
    "qa_jvp_fwd": [_PTR] * 10 + [_I32] * 5 + [_F32] * 2 + [_PTR],
    "qa_jvp_fwd_prep": [_PTR] * 3 + [_I32] * 3 + [_PTR],
    "qa_jvp_fwd_bf16": [_PTR, _I64, _I64, _I64] * 2 + [_PTR] * 8 + [_I32] * 5 + [_F32] * 2
                       + [_PTR],
}


@functools.cache
def _kernel(name="qa_jvp_fwd"):
    fn = getattr(load_kernel("jvp"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _one_device(tensors) -> torch.device:
    """The one CUDA device all of `tensors` lie on; raises otherwise."""
    dev = tensors[0].device
    if any(x.device != dev for x in tensors):
        raise ValueError(f"expected tensors on one device, got {[str(x.device) for x in tensors]}")
    return dev


def jvp_fwd_prep_plain(k, v, tk, tv):
    """B9 fast's K-side prep in plain PyTorch: k, v, tk, tv [b, h, s, d] ->
    each rounded to bf16 (round to nearest even), contiguous [b * h, s, d]."""
    b, h, s, d = k.shape
    return tuple(x.to(torch.bfloat16).reshape(b * h, s, d).contiguous() for x in (k, v, tk, tv))


def jvp_fwd_prep(k, v, tk, tv):
    """`jvp_fwd_prep_plain`'s result, byte for byte, from one kernel launch
    for CUDA tensors (read through their strides, rows contiguous; others are
    copied first); CPU tensors take the plain version. `jvp_fwd_prep.launches`
    counts kernel launches."""
    if k.device.type == "cpu":
        return jvp_fwd_prep_plain(k, v, tk, tv)
    b, h, s, d = k.shape
    if d != HEAD_DIM or any(x.shape != k.shape for x in (v, tk, tv)):
        raise ValueError(f"kernel takes k, v, tk, tv of one shape [b, h, s, {HEAD_DIM}]; got "
                         f"{[tuple(x.shape) for x in (k, v, tk, tv)]}")
    jvp_tiling.fwd_prep_grid(b * h, s)
    ins = [_kernel_ready(x, (torch.float32,)) for x in (k, v, tk, tv)]
    dev = _one_device(ins)
    outs = [torch.empty((b * h, s, d), dtype=torch.bfloat16, device=dev) for _ in range(4)]
    status = _kernel("qa_jvp_fwd_prep")(
        (ctypes.c_void_p * 4)(*(x.data_ptr() for x in ins)),
        (ctypes.c_longlong * 12)(*(st for x in ins for st in _strides(x))),
        (ctypes.c_void_p * 4)(*(x.data_ptr() for x in outs)), b, h, s,
        torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "jvp_fwd prep")
    jvp_fwd_prep.launches += 1
    return tuple(outs)


def attention_jvp_fwd(q, k, v, tq, tk, tv, causal=False, sm_scale=None, fast=False):
    """B9: (O, tO f32 [b, h, t, d], lse, mu f32 [b, h, t]).

    CUDA tensors launch the kernel (head_dim 64) or raise: fast mode reads q
    and tq through their strides (rows contiguous) after one `jvp_fwd_prep`
    launch for k, v, tk and tv; exact mode takes contiguous f32 copies. CPU
    tensors take `attention_jvp_fwd_plain`. `attention_jvp_fwd.launches`
    counts launches of the kernel (the prep's are `jvp_fwd_prep.launches`).
    """
    if q.device.type == "cpu":
        return attention_jvp_fwd_plain(q, k, v, tq, tk, tv, causal, sm_scale, fast)
    check_jvp_args(q, k, v, tq, tk, tv)
    b, h, t, d = q.shape
    s = k.shape[2]
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    if fast:
        if d != HEAD_DIM:
            raise ValueError(f"the JVP kernels take head_dim {HEAD_DIM}; got d={d}")
        jvp_tiling.q_blocks(b * h, t)
        qf, tqf = _kernel_ready(q, (torch.float32,)), _kernel_ready(tq, (torch.float32,))
        kv = jvp_fwd_prep(k, v, tk, tv)
        dev = _one_device([qf, tqf, *kv])
    else:
        ins, dev = kernel_args(b, h, d, q, k, v, tq, tk, tv)
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    to = torch.empty_like(o)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    mu = torch.empty_like(lse)
    outs = (o.data_ptr(), to.data_ptr(), lse.data_ptr(), mu.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if fast:
        status = _kernel("qa_jvp_fwd_bf16")(
            qf.data_ptr(), *_strides(qf), tqf.data_ptr(), *_strides(tqf),
            *(x.data_ptr() for x in kv), *outs, b, h, t, s, int(causal), sm_scale, qk_scale,
            stream)
    else:
        status = _kernel()(*(x.data_ptr() for x in ins), *outs, b * h, t, s, int(causal), 0,
                           sm_scale, qk_scale, stream)
    check_status(status, "jvp_fwd")
    attention_jvp_fwd.launches += 1
    return o, to, lse, mu


attention_jvp_fwd.launches = 0
jvp_fwd_prep.launches = 0
