"""Tangent-only attention, tO given (O, lse): CUDA kernel and plain version.

Counterpart of quantizedattention_tpu/ops/jvp_tangent.py (B10), the tangent
rule of `attention_jvp` under forward-mode AD. With lse known, p =
exp2(S - lse) is final on first touch, so no running max is kept:

    acc += (p o tS) V + p tV,   r += rowsum(p o tS),   tO = acc - r o O

S and tS as in ops/jvp_fwd (masked entries give p = 0 explicitly); `fast`
rounds q, k, v, tq, tk, tv, p and p o tS to bf16 where they enter a product.
CUDA tensors launch the hand-written Hopper kernels (csrc/jvp.cu): exact
mode one `tangent_prep` launch (K, tK, V and tV split into TF32 big and
small parts, read through their strides) and the 3xTF32 kernel, which
reads q, tq, o and lse through their strides and, where the q blocks alone
do not fill the card, splits the keys into ranges whose sums a merge launch
adds in order (`jvp_tiling.tangent_grid`); fast mode the mma.sync kernel on
contiguous f32 copies. CPU tensors run `attention_tangent_fwd_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops import flash_tiling, jvp_tiling
from quantizedattention_tpu_torch.ops.common import qk_scales, tile_mask
from quantizedattention_tpu_torch.ops.flash_fwd import _kernel_ready, _strides, kv_split_tf32_plain
from quantizedattention_tpu_torch.ops.jvp_fwd import check_jvp_args, kernel_args, rounder
from quantizedattention_tpu_torch.utils.runtime import check_status

HEAD_DIM = jvp_tiling.HEAD_DIM  # the kernels' compiled head dim


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


_PTR, _PTRS = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
_I64S, _I32, _F32 = ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # the C entries of csrc/jvp.cu this module calls
    "qa_jvp_tangent": [_PTR] * 9 + [_I32] * 5 + [_F32] * 2 + [_PTR],
    "qa_jvp_tangent_prep": [_PTRS, _I64S, _PTRS] + [_I32] * 3 + [_PTR],
    "qa_jvp_tangent_tf32": [_PTR, _I64S] * 4 + [_PTRS, _PTR, _PTR] + [_I32] * 7 + [_F32] * 2
                           + [_PTR],
}


@functools.cache
def _kernel(name="qa_jvp_tangent"):
    fn = getattr(load_kernel("jvp"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def tangent_prep_plain(k, v, tk, tv):
    """B10 exact's prep in plain PyTorch: `kv_split_tf32_plain` of (k, v)
    and of (tk, tv), eight tensors: K big, K small [b * h, s, d], V^T big,
    V^T small [b * h, d, s8], then the same of tK and tV."""
    return (*kv_split_tf32_plain(k, v), *kv_split_tf32_plain(tk, tv))


def tangent_prep(k, v, tk, tv):
    """`tangent_prep_plain`'s result, byte for byte, from one kernel launch
    for CUDA tensors (f32 [b, h, s, 64] read through their strides, rows
    contiguous; others are copied first); CPU tensors take the plain
    version."""
    if k.device.type == "cpu":
        return tangent_prep_plain(k, v, tk, tv)
    b, h, s, d = k.shape
    if d != HEAD_DIM or any(x.shape != k.shape for x in (v, tk, tv)):
        raise ValueError(f"kernel takes k, v, tk, tv [b, h, s, {HEAD_DIM}] of one shape")
    ins = [_kernel_ready(x, (torch.float32,)) for x in (k, v, tk, tv)]
    dev = ins[0].device
    if any(x.device != dev for x in ins):
        raise ValueError("k, v, tk and tv must lie on one device")
    s8 = flash_tiling.fp32_kv_cols(s)
    out = [torch.empty(shape, dtype=torch.float32, device=dev)
           for shape in ([(b * h, s, d)] * 2 + [(b * h, d, s8)] * 2) * 2]
    status = _kernel("qa_jvp_tangent_prep")(
        (ctypes.c_void_p * 4)(*(x.data_ptr() for x in ins)),
        (ctypes.c_longlong * 12)(*(st for x in ins for st in _strides(x))),
        (ctypes.c_void_p * 8)(*(x.data_ptr() for x in out)), b, h, s,
        torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "jvp_tangent prep")
    return tuple(out)


def _launch_exact(q, k, v, o, lse, tq, tk, tv, causal, sm_scale):
    """B10 exact: one prep launch, the 3xTF32 kernel and, where the keys are
    split, the merge launch."""
    b, h, t, d = q.shape
    s = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"kernel takes head_dim {HEAD_DIM}; got d={d}")
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    qf, tqf, of = (_kernel_ready(x, (torch.float32,)) for x in (q, tq, o))
    dev = qf.device
    lsef = lse.float()
    if lsef.device != dev or tqf.device != dev or of.device != dev:
        raise ValueError("q, tq, o and lse must lie on one device")
    _, z, per = jvp_tiling.tangent_grid(b * h, t, s,
                                        torch.cuda.get_device_properties(dev).multi_processor_count)
    prep = tangent_prep(k, v, tk, tv)
    to = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    part = torch.empty(z * b * h * t * (d + 1), dtype=torch.float32, device=dev) if z > 1 else None

    def strides(x):
        return (ctypes.c_longlong * 3)(*x.stride()[:3])

    status = _kernel("qa_jvp_tangent_tf32")(
        qf.data_ptr(), strides(qf), tqf.data_ptr(), strides(tqf), of.data_ptr(), strides(of),
        lsef.data_ptr(), strides(lsef), (ctypes.c_void_p * 8)(*(x.data_ptr() for x in prep)),
        to.data_ptr(), None if part is None else part.data_ptr(), b, h, t, s, int(causal), z,
        per, sm_scale, qk_scale, torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "jvp_tangent exact")
    return to


def _launch_fast(q, k, v, o, lse, tq, tk, tv, causal, sm_scale):
    """B10 fast: the mma.sync kernel on contiguous f32 copies."""
    b, h, t, d = q.shape
    s = k.shape[2]
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    ins, dev = kernel_args(b, h, d, q, k, v, tq, tk, tv, o, lse)
    to = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    status = _kernel()(
        *(x.data_ptr() for x in ins), to.data_ptr(), b * h, t, s, int(causal), 1, sm_scale,
        qk_scale, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "jvp_tangent")
    return to


def _launch(q, k, v, o, lse, tq, tk, tv, causal, sm_scale, fast):
    to = (_launch_fast if fast else _launch_exact)(q, k, v, o, lse, tq, tk, tv, causal, sm_scale)
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

    CUDA tensors launch the kernels (head_dim 64; exact mode: the prep, the
    3xTF32 kernel and, with the keys split, the merge) or raise; CPU tensors
    take `attention_tangent_fwd_plain`. Both go through a dispatcher op, which
    torch.func transforms see through. `attention_tangent_fwd.launches`
    counts launches.
    """
    check_jvp_args(q, k, v, tq, tk, tv)
    _check_residuals(q, o, lse)
    sm_scale, _ = qk_scales(q.shape[3], sm_scale)
    return _tangent_op(q, k, v, o, lse, tq, tk, tv, bool(causal), float(sm_scale), bool(fast))


attention_tangent_fwd.launches = 0
