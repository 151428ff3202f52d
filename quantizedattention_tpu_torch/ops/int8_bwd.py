"""Int8 flash-attention backward from the forward's quantized residuals.

Counterpart of quantizedattention_tpu/ops/int8_bwd.py. `int8_attention_bwd`
takes the residuals of `ops.int8_fwd.quantize_qkv` (int8 payloads and their
scale tables, K smoothed), the K-smoothing mean, O, lse and dO, and returns
(dq, dk, dv) in f32 with dk/dv on the kv-head count. It runs two
hand-written Hopper kernels (csrc/int8_bwd.cu) for CUDA tensors:

  int8_bwd_dkv  B7, dK and dV per 128-key block over the q tiles that see it;
  int8_bwd_dq   B8, dQ per block of 128 rows (the GQA group) over the key
                tiles it sees;

and their plain PyTorch versions (`int8_bwd_dkv_plain`, `int8_bwd_dq_plain`)
for CPU tensors. Each wrapper counts its launches (`.launches`).

Shared arithmetic, with the JAX package's rounding points
(ops/int8_bwd.py:56-59, 98-110, 154-164): P = exp2(Q_i8 K_i8^T * c - lse),
c = (sq * sk) * qk_scale, masked to 0, in f32 from exact integer logits;
dV += bf16(P)^T bf16(dO); dP = (bf16(dO) V_i8^T) * sv; dS = P (dP - D) *
sm_scale with D = rowsum(dO * O) in f32 and the unrounded P; dK gets
(bf16(dS)^T Q_i8) * sq per (q head, q grain); dQ gets (bf16(dS) K_i8) * sk
+ rowsum(dS) * k_mean per kv grain, the rowsum over the f32 dS (the last
term undoes K-smoothing). dO is not pre-scaled.

Causal masking is on global positions, k_offset + j <= q_offset + i, as in
the forward (ops/int8_fwd.py). A row that saw no key (the forward's lse
-inf, O = 0) goes to the kernels with lse +inf, so its P is 0: it gets dQ = 0,
and keys that no row sees get dK = dV = 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.common import (
    check_head_dim,
    check_offsets,
    qk_scales,
    tile_mask,
)
from quantizedattention_tpu_torch.ops.int8_fwd import _layout, raw_logits_and_scale
from quantizedattention_tpu_torch.ops.int8_tiling import bwd_grids, check_bwd_grains
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda


class Int8BwdOperands(NamedTuple):
    """The backward kernels' inputs, laid out for them by `int8_bwd_operands`."""

    q_i8: torch.Tensor    # [b*h, q_pad, d] int8, q head = kv_head * rep + g
    sq: torch.Tensor      # [b*h, q_pad // q_grain] f32
    k_i8: torch.Tensor    # [b*h_kv, kv_pad, d] int8, smoothed
    sk: torch.Tensor      # [b*h_kv, kv_pad // kv_grain] f32
    v_i8: torch.Tensor    # [b*h_kv, kv_pad, d] int8
    sv: torch.Tensor      # [b*h_kv, kv_pad // kv_grain] f32
    k_mean: torch.Tensor  # [b*h_kv, d] f32
    do: torch.Tensor      # [b*h, t, d] bf16
    lse: torch.Tensor     # [b*h, t] f32, exp2 domain; +inf for a row that saw no key
    di: torch.Tensor      # [b*h, t] f32, rowsum(dO * O)
    dims: tuple           # (batch, head, q_tokens, kv_len, head_dim)
    rep: int
    q_grain: int
    kv_grain: int
    sm_scale: float
    qk_scale: float
    causal: bool
    q_offset: int = 0     # global position of the first query
    k_offset: int = 0     # global position of the first key


def int8_bwd_operands(residuals, k_mean, o, lse, do, dims, causal=False, sm_scale=None,
                      q_offset=0, k_offset=0) -> Int8BwdOperands:
    """Lay out the residuals, k_mean [b, h_kv, 1, d], O/dO [b, h, t, d] and lse
    [b, h, t] for the kernels; D = rowsum(dO * O) in f32, and a row's lse of
    -inf (it saw no key) as +inf."""
    q_offset, k_offset = check_offsets(q_offset, k_offset)
    bh_kv, rep, q_grain, kv_grain = _layout(residuals, dims)
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
    b, h, t, s, d = dims
    if o.shape != (b, h, t, d) or do.shape != o.shape or lse.shape != (b, h, t) \
            or k_mean.numel() != bh_kv * d:
        raise ValueError(f"want o/do {(b, h, t, d)}, lse {(b, h, t)}, k_mean of {bh_kv * d}; got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}, "
                         f"{tuple(k_mean.shape)}")
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    di = (do.float() * o.float()).sum(-1)
    lse = lse.float()
    lse = torch.where(lse == -torch.inf, torch.inf, lse)
    return Int8BwdOperands(
        q_i8=q_i8, sq=sq.float(), k_i8=k_i8, sk=sk.float(), v_i8=v_i8, sv=sv.float(),
        k_mean=k_mean.float().reshape(bh_kv, d).contiguous(),
        do=do.to(torch.bfloat16).reshape(b * h, t, d).contiguous(),
        lse=lse.reshape(b * h, t).contiguous(), di=di.reshape(b * h, t).contiguous(),
        dims=tuple(dims), rep=rep, q_grain=q_grain, kv_grain=kv_grain, sm_scale=sm_scale,
        qk_scale=qk_scale, causal=bool(causal), q_offset=q_offset, k_offset=k_offset,
    )


# --------------------------------------------------------------------------
# Plain versions (whole rows, the same rounding points as the kernels)
# --------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _p_ds(ops: Int8BwdOperands):
    """(P, dS) [b*h_kv, rep, t, s] in f32."""
    _, _, t, s, d = ops.dims
    bh_kv = ops.k_i8.shape[0]
    raw, c = raw_logits_and_scale(ops.q_i8, ops.sq, ops.k_i8, ops.sk, bh_kv, ops.rep, t, s,
                                  ops.q_grain, ops.kv_grain, ops.qk_scale)
    lse = ops.lse.reshape(bh_kv, ops.rep, t, 1)
    mask = tile_mask(ops.q_offset, ops.k_offset, t, s, s, ops.causal, k_local_start=0,
                     device=raw.device)
    p = torch.where(mask, torch.exp2(raw * c - lse), 0.0)
    sv_key = ops.sv[:, torch.arange(s, device=raw.device) // ops.kv_grain]
    dp = (_dov(ops) @ ops.v_i8[:, :s].float()[:, None].transpose(-1, -2)) * sv_key[:, None, None]
    di = ops.di.reshape(bh_kv, ops.rep, t, 1)
    return p, p * (dp - di) * ops.sm_scale


def _dov(ops):
    """dO as f32 [b*h_kv, rep, t, d] (its values are bf16)."""
    _, _, t, _, d = ops.dims
    return ops.do.float().reshape(-1, ops.rep, t, d)


def int8_bwd_dkv_plain(ops: Int8BwdOperands):
    """B7's arithmetic in plain PyTorch: (dk, dv) [b*h_kv, s, d] f32."""
    _, _, t, s, d = ops.dims
    p, ds = _p_ds(ops)
    dv = (_bf16(p).transpose(-1, -2) @ _dov(ops)).sum(1)
    qf = ops.q_i8[:, :t].float().reshape(-1, ops.rep, t, d)
    sq = ops.sq.reshape(-1, ops.rep, ops.sq.shape[1])
    ds_t = _bf16(ds).transpose(-1, -2)
    dk = torch.zeros_like(dv)
    for r0 in range(0, t, ops.q_grain):  # each q grain's product scaled by its sq
        r1 = min(r0 + ops.q_grain, t)
        part = ds_t[..., r0:r1] @ qf[:, :, r0:r1]
        dk = dk + (part * sq[:, :, r0 // ops.q_grain, None, None]).sum(1)
    return dk, dv


def int8_bwd_dq_plain(ops: Int8BwdOperands):
    """B8's arithmetic in plain PyTorch: dq [b*h_kv, rep, t, d] f32."""
    _, _, t, s, d = ops.dims
    _, ds = _p_ds(ops)
    kf = ops.k_i8[:, :s].float()[:, None]
    k_mean = ops.k_mean[:, None, None, :]
    dq = torch.zeros((ds.shape[0], ops.rep, t, d), dtype=torch.float32, device=ds.device)
    for g0 in range(0, s, ops.kv_grain):  # per kv grain: * sk, + rowsum(dS) * k_mean
        g1 = min(g0 + ops.kv_grain, s)
        part = (_bf16(ds[..., g0:g1]) @ kf[:, :, g0:g1]) * ops.sk[:, g0 // ops.kv_grain,
                                                                  None, None, None]
        dq = dq + (part + ds[..., g0:g1].sum(-1, keepdim=True) * k_mean)
    return dq


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

@functools.cache
def _kernels():
    lib = load_kernel("int8_bwd")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.qa_int8_bwd_dkv.argtypes = [ptr] * 11 + [i32] * 11 + [f32, f32, i32, ptr]
    lib.qa_int8_bwd_dq.argtypes = [ptr] * 11 + [i32] * 12 + [f32, f32, i32, ptr]
    lib.qa_int8_bwd_dkv.restype = lib.qa_int8_bwd_dq.restype = ctypes.c_int
    return lib


def _launch_args(ops: Int8BwdOperands):
    """Check what the kernels take (ops/int8_tiling.py's backward geometry);
    returns (device, the kernels' shape args, bq)."""
    _, _, t, s, d = ops.dims
    bh_kv, q_pad, kv_pad = ops.k_i8.shape[0], ops.q_i8.shape[1], ops.k_i8.shape[1]
    check_head_dim("B7/B8", d)
    bq, _, _ = bwd_grids(bh_kv, ops.rep, t, s, q_pad, kv_pad)
    check_bwd_grains(ops.q_grain, ops.kv_grain, q_pad, kv_pad)
    if any(x.dtype != torch.int8 for x in (ops.q_i8, ops.k_i8, ops.v_i8)) \
            or ops.do.dtype != torch.bfloat16 \
            or any(x.dtype != torch.float32 for x in (ops.sq, ops.sk, ops.sv, ops.k_mean,
                                                      ops.lse, ops.di)):
        raise ValueError("kernels take int8 payloads, bf16 dO and float32 scales, "
                         "k_mean, lse and di (see int8_bwd_operands)")
    dev = require_cuda(ops.q_i8, ops.k_i8, ops.v_i8, ops.sq, ops.sk, ops.sv, ops.k_mean,
                       ops.do, ops.lse, ops.di)
    ints = (bh_kv, ops.rep, t, s, q_pad, kv_pad, ops.q_grain, ops.kv_grain)
    return dev, ints, bq


def _inputs(ops: Int8BwdOperands):
    return [x.data_ptr() for x in (ops.q_i8, ops.k_i8, ops.v_i8, ops.sq, ops.sk, ops.sv,
                                   ops.do, ops.lse, ops.di)]


def int8_bwd_dkv(ops: Int8BwdOperands):
    """B7: (dk, dv) [b*h_kv, s, d] f32. CUDA operands launch the kernel (or
    raise); CPU operands take `int8_bwd_dkv_plain`."""
    if ops.q_i8.device.type == "cpu":
        return int8_bwd_dkv_plain(ops)
    dev, ints, _ = _launch_args(ops)
    s, d = ops.dims[3], ops.dims[4]
    dk = torch.empty((ops.k_i8.shape[0], s, d), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    status = _kernels().qa_int8_bwd_dkv(
        *_inputs(ops), dk.data_ptr(), dv.data_ptr(), *ints, int(ops.causal), ops.q_offset,
        ops.k_offset, ops.qk_scale, ops.sm_scale, d, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "int8_bwd_dkv")
    int8_bwd_dkv.launches += 1
    return dk, dv


def int8_bwd_dq(ops: Int8BwdOperands):
    """B8: dq [b*h_kv, rep, t, d] f32. CUDA operands launch the kernel (or
    raise); CPU operands take `int8_bwd_dq_plain`."""
    if ops.q_i8.device.type == "cpu":
        return int8_bwd_dq_plain(ops)
    dev, ints, bq = _launch_args(ops)
    t, d = ops.dims[2], ops.dims[4]
    dq = torch.empty((ops.k_i8.shape[0], ops.rep, t, d), dtype=torch.float32, device=dev)
    status = _kernels().qa_int8_bwd_dq(
        *_inputs(ops), ops.k_mean.data_ptr(), dq.data_ptr(), *ints, bq, int(ops.causal),
        ops.q_offset, ops.k_offset, ops.qk_scale, ops.sm_scale, d,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "int8_bwd_dq")
    int8_bwd_dq.launches += 1
    return dq


int8_bwd_dkv.launches = 0
int8_bwd_dq.launches = 0


def _unflatten(ops, dq, dk, dv):
    b, h, t, s, d = ops.dims
    h_kv = h // ops.rep
    return dq.reshape(b, h, t, d), dk.reshape(b, h_kv, s, d), dv.reshape(b, h_kv, s, d)


def int8_attention_bwd(residuals, k_mean, o, lse, do, dims, causal=False, sm_scale=None,
                       q_offset=0, k_offset=0):
    """Int8 backward from the forward's residuals (`quantize_qkv`'s layout, K
    smoothed by k_mean [b, h_kv, 1, d]); o/do [b, h, t, d], lse [b, h, t];
    dims = (batch, head, q_tokens, kv_len, head_dim); q_offset/k_offset as
    the forward's. Returns (dq [b, h, t, d], dk, dv [b, h_kv, s, d]) in f32.
    CUDA tensors run B7 and B8, CPU tensors their plain versions."""
    ops = int8_bwd_operands(residuals, k_mean, o, lse, do, dims, causal, sm_scale, q_offset,
                            k_offset)
    dk, dv = int8_bwd_dkv(ops)
    return _unflatten(ops, int8_bwd_dq(ops), dk, dv)


def int8_attention_bwd_plain(residuals, k_mean, o, lse, do, dims, causal=False, sm_scale=None,
                             q_offset=0, k_offset=0):
    """`int8_attention_bwd` through the plain versions, on any device."""
    ops = int8_bwd_operands(residuals, k_mean, o, lse, do, dims, causal, sm_scale, q_offset,
                            k_offset)
    dk, dv = int8_bwd_dkv_plain(ops)
    return _unflatten(ops, int8_bwd_dq_plain(ops), dk, dv)
