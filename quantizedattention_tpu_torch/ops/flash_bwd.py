"""Flash-attention backward: CUDA kernels and plain versions.

Counterpart of quantizedattention_tpu/ops/flash_bwd.py. `flash_attention_bwd`
takes the forward's residuals (q, k, v, O, lse) and dO and returns
(dq, dk, dv) in f32, with dk/dv on the kv-head count (the GQA group sum runs
inside the dK/dV kernel). It runs two hand-written Hopper kernels
(csrc/flash_bwd.cu) for CUDA tensors:

  flash_bwd_dkv  B2, dK and dV per 64-key tile over all q tiles;
  flash_bwd_dq   B3, dQ per q tile over all kv tiles;

and their plain PyTorch versions (`flash_bwd_dkv_plain`, `flash_bwd_dq_plain`)
for CPU tensors. Each wrapper counts its launches (`.launches`).

Shared arithmetic (flash_bwd.py:229-242): `bwd_operands` folds qk_scale =
sm_scale*log2(e) into q and sm_scale into dO, computes the row term
D = rowsum(dO*sm_scale o O) once in f32, and lays q/dO out as
[b*h_kv, rep, t, d] (q head = kv_head * rep + g). Then P = exp2(q_s k^T - lse)
is recomputed against the forward's exp2-domain lse, dV = P^T dO_s / sm_scale,
dP = dO_s v^T, dS = P (dP - D), dK = dS^T q_s / qk_scale and dQ = dS k.

`fast=True` rounds the operands of every product to bf16, as the TPU's
DEFAULT-precision dots do: q_s and k for S, bf16(P) and dO_s for dV, dO_s and
v for dP, bf16(dS) and q_s for dK, bf16(dS) and k for dQ; dS itself uses the
unrounded f32 P (flash_bwd.py:113). `fast=False` is fp32 throughout (no TF32:
the plain version needs `torch.backends.cuda.matmul.allow_tf32 = False` on a
card, which is PyTorch's default).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.common import MASK_VALUE, qk_scales, tile_mask
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

_HEAD_DIM = 64  # the kernels' compiled head dim
_BLOCK_ROWS = 64  # rows per fast dQ block; the GQA group must fit in it


class BwdOperands(NamedTuple):
    """The backward kernels' inputs, laid out for them by `bwd_operands`."""

    q: torch.Tensor    # [b*h_kv, rep, t, d] q * qk_scale (bf16 when fast, else f32)
    k: torch.Tensor    # [b*h_kv, s, d]
    v: torch.Tensor    # [b*h_kv, s, d]
    do: torch.Tensor   # [b*h_kv, rep, t, d] dO * sm_scale
    lse: torch.Tensor  # [b*h_kv, rep, t] f32, exp2 domain
    di: torch.Tensor   # [b*h_kv, rep, t] f32, rowsum(dO * sm_scale * O)
    sm_scale: float
    qk_scale: float
    causal: bool
    fast: bool


def bwd_operands(q, k, v, o, lse, do, causal=False, sm_scale=None, fast=False) -> BwdOperands:
    """Scale, round and lay out the residuals for the kernels (any strides in)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or o.shape != q.shape \
            or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"want q/o/do [b,h,t,d], k/v [b,h_kv,s,d], lse [b,h,t]; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, lse {tuple(lse.shape)}, do {tuple(do.shape)}")
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch/head_dim")
    if h % h_kv != 0:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({h_kv})")
    rep = h // h_kv
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    dtype = torch.bfloat16 if fast else torch.float32
    dos = do.float() * sm_scale
    di = (dos * o.float()).sum(-1)

    def heads(x):  # [b, h, t, ...] -> [b*h_kv, rep, t, ...]
        return x.reshape(b * h_kv, rep, *x.shape[2:]).contiguous()

    def kv(x):
        return x.reshape(b * h_kv, s, d).to(dtype).contiguous()

    return BwdOperands(
        q=heads((q.float() * qk_scale).to(dtype)), k=kv(k), v=kv(v), do=heads(dos.to(dtype)),
        lse=heads(lse.float()), di=heads(di), sm_scale=sm_scale, qk_scale=qk_scale,
        causal=bool(causal), fast=bool(fast),
    )


# --------------------------------------------------------------------------
# Plain versions (whole rows, the same rounding points as the kernels)
# --------------------------------------------------------------------------

def _rounded(x, fast):
    return x.to(torch.bfloat16).float() if fast else x


def _p_ds(ops: BwdOperands):
    """(P, dS) [b*h_kv, rep, t, s] in f32; P recomputed as in _recompute_p."""
    qs, kf, vf, dos = ops.q.float(), ops.k.float()[:, None], ops.v.float()[:, None], ops.do.float()
    t, s = qs.shape[2], kf.shape[2]
    scores = qs @ kf.transpose(-1, -2)
    mask = tile_mask(0, 0, t, s, s, ops.causal, device=qs.device)
    p = torch.exp2(torch.where(mask, scores, MASK_VALUE) - ops.lse[..., None])
    dp = dos @ vf.transpose(-1, -2)
    return p, p * (dp - ops.di[..., None])


def flash_bwd_dkv_plain(ops: BwdOperands):
    """B2's arithmetic in plain PyTorch: (dk, dv) [b*h_kv, s, d] f32."""
    p, ds = _p_ds(ops)
    dv = (_rounded(p, ops.fast).transpose(-1, -2) @ ops.do.float()).sum(1)
    dk = (_rounded(ds, ops.fast).transpose(-1, -2) @ ops.q.float()).sum(1)
    return dk * (1.0 / ops.qk_scale), dv * (1.0 / ops.sm_scale)


def flash_bwd_dq_plain(ops: BwdOperands):
    """B3's arithmetic in plain PyTorch: dq [b*h_kv, rep, t, d] f32."""
    _, ds = _p_ds(ops)
    return _rounded(ds, ops.fast) @ ops.k.float()[:, None]


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

@functools.cache
def _kernels():
    lib = load_kernel("flash_bwd")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.qa_flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 6 + [f32, f32, ptr]
    lib.qa_flash_bwd_dq.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.qa_flash_bwd_dkv.restype = lib.qa_flash_bwd_dq.restype = ctypes.c_int
    return lib


def _launch_args(ops: BwdOperands):
    """Check what the kernels take; returns (device, bh_kv, rep, t, s)."""
    bh_kv, rep, t, d = ops.q.shape
    s = ops.k.shape[1]
    if d != _HEAD_DIM or (ops.fast and rep > _BLOCK_ROWS) or bh_kv * rep > 65535:
        raise ValueError(f"kernels take head_dim {_HEAD_DIM}, rep <= {_BLOCK_ROWS} (fast), "
                         f"b*h <= 65535; got d={d}, rep={rep}, b*h={bh_kv * rep}")
    want = torch.bfloat16 if ops.fast else torch.float32
    if any(x.dtype != want for x in (ops.q, ops.k, ops.v, ops.do)):
        raise ValueError(f"fast={ops.fast} kernels take {want} q/k/v/do (see bwd_operands)")
    if ops.lse.dtype != torch.float32 or ops.di.dtype != torch.float32:
        raise ValueError("lse and di must be float32")
    dev = require_cuda(ops.q, ops.k, ops.v, ops.do, ops.lse, ops.di)
    return dev, bh_kv, rep, t, s


def flash_bwd_dkv(ops: BwdOperands):
    """B2: (dk, dv) [b*h_kv, s, d] f32. CUDA operands launch the kernel (or
    raise); CPU operands take `flash_bwd_dkv_plain`."""
    if ops.q.device.type == "cpu":
        return flash_bwd_dkv_plain(ops)
    dev, bh_kv, rep, t, s = _launch_args(ops)
    dk = torch.empty((bh_kv, s, _HEAD_DIM), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    status = _kernels().qa_flash_bwd_dkv(
        ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(), ops.do.data_ptr(),
        ops.lse.data_ptr(), ops.di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh_kv, rep, t, s, int(ops.causal), int(ops.fast), 1.0 / ops.qk_scale,
        1.0 / ops.sm_scale, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(ops: BwdOperands):
    """B3: dq [b*h_kv, rep, t, d] f32. CUDA operands launch the kernel (or
    raise); CPU operands take `flash_bwd_dq_plain`."""
    if ops.q.device.type == "cpu":
        return flash_bwd_dq_plain(ops)
    dev, bh_kv, rep, t, s = _launch_args(ops)
    dq = torch.empty((bh_kv, rep, t, _HEAD_DIM), dtype=torch.float32, device=dev)
    status = _kernels().qa_flash_bwd_dq(
        ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(), ops.do.data_ptr(),
        ops.lse.data_ptr(), ops.di.data_ptr(), dq.data_ptr(),
        bh_kv, rep, t, s, int(ops.causal), int(ops.fast),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def _unflatten(q, k, dq, dk, dv):
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(k.shape)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, sm_scale=None, fast=False):
    """Flash-attention backward from the forward's residuals.

    q/o/do [b, h, t, d], k/v [b, h_kv, s, d], lse [b, h, t] (exp2 domain).
    Returns (dq [b, h, t, d], dk, dv [b, h_kv, s, d]) in f32. CUDA tensors run
    the two kernels (head_dim 64); CPU tensors their plain versions.
    """
    ops = bwd_operands(q, k, v, o, lse, do, causal, sm_scale, fast)
    dk, dv = flash_bwd_dkv(ops)
    return _unflatten(q, k, flash_bwd_dq(ops), dk, dv)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, sm_scale=None, fast=False):
    """`flash_attention_bwd` through the plain versions, on any device."""
    ops = bwd_operands(q, k, v, o, lse, do, causal, sm_scale, fast)
    dk, dv = flash_bwd_dkv_plain(ops)
    return _unflatten(q, k, flash_bwd_dq_plain(ops), dk, dv)
