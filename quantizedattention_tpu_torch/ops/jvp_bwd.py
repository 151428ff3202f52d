"""Second-order backward of JVP attention: CUDA kernels and plain versions.

Counterpart of quantizedattention_tpu/ops/jvp_bwd.py. `attention_jvp_bwd` is
the VJP of (q, k, v, tq, tk, tv) -> (O, tO): from the forward's residuals
(O, tO, lse, mu) and the cotangents (dO, dtO) it returns
(dq, dk, dv, dtq, dtk, dtv) in f32. Two hand-written Hopper kernels
(csrc/jvp.cu) run for CUDA tensors:

  jvp_bwd_prep  the fast kernels' operand prep, one launch: the eight
                operands in bf16 and the row terms lse, mu, c, dhat at TMA's
                row stride; `attention_jvp_bwd` runs it once a fast call and
                hands it to both kernels;
  jvp_bwd_dkv   B11, dK, dV, dtK, dtV per key tile (32 keys exact, 128 fast)
                over all q tiles (fast at head dim 128: one call launches the
                kernel twice, for dV and dtV, then for dK and dtK, and counts
                both launches);
  jvp_bwd_dq    B12, dQ, dtQ per q tile (32 rows exact, 128 fast) over all
                kv tiles;

and their plain PyTorch versions for CPU tensors. Each wrapper counts its
launches (`.launches`). The fast kernels' launch geometry is
ops/jvp_tiling.py's.

Tile math (jvp_bwd.py:15-44): p = exp2(S - lse), 0 where masked;
tS = (tQ K^T + Q tK^T) sm_scale; tpb = dtO V^T;
pbar = dO V^T + dtO tV^T + tpb (tS - mu) - c tS; dS = p (pbar - dhat);
tSb = p (tpb - c); tP = p (tS - mu); then dV = p^T dO + tP^T dtO,
dtV = p^T dtO, dK = (dS^T Q + tSb^T tQ) sm_scale, dtK = tSb^T Q sm_scale,
dQ = (dS K + tSb tK) sm_scale, dtQ = tSb K sm_scale. The row terms
D = rowsum(dO o O), c = rowsum(dtO o O) and dhat = D + rowsum(dtO o tO) - c mu
close over whole rows, so `jvp_bwd_operands` computes them in PyTorch before
either kernel runs (jvp_bwd.py:238-244). `fast=True` rounds every product's
operands to bf16 (q, k, v, tq, tk, tv, dO, dtO, and p, tP, dS, tSb where they
enter the second products); the row terms and tile quantities stay f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops import jvp_tiling
from quantizedattention_tpu_torch.ops.common import qk_scales, tile_mask
from quantizedattention_tpu_torch.ops.jvp_fwd import check_jvp_args, kernel_args, rounder
from quantizedattention_tpu_torch.utils.runtime import check_status


class JvpBwdOperands(NamedTuple):
    """The second-order backward's inputs, laid out by `jvp_bwd_operands`."""

    q: torch.Tensor    # [b*h, t, d] f32
    k: torch.Tensor    # [b*h, s, d]
    v: torch.Tensor    # [b*h, s, d]
    tq: torch.Tensor   # [b*h, t, d]
    tk: torch.Tensor   # [b*h, s, d]
    tv: torch.Tensor   # [b*h, s, d]
    do: torch.Tensor   # [b*h, t, d]
    dto: torch.Tensor  # [b*h, t, d]
    lse: torch.Tensor  # [b*h, t] exp2 domain
    mu: torch.Tensor   # [b*h, t] rowsum(P o tS), P normalized
    c: torch.Tensor    # [b*h, t] rowsum(dtO o O)
    dhat: torch.Tensor  # [b*h, t] rowsum(dO o O) + rowsum(dtO o tO) - c mu
    sm_scale: float
    qk_scale: float
    causal: bool
    fast: bool


def jvp_bwd_operands(q, k, v, tq, tk, tv, o, to, lse, mu, do, dto, causal=False, sm_scale=None,
                     fast=False) -> JvpBwdOperands:
    """Lay the residuals and cotangents out as [b*h, tokens, d] f32 (any
    strides in) and compute the row terms c and dhat."""
    check_jvp_args(q, k, v, tq, tk, tv)
    b, h, t, d = q.shape
    s = k.shape[2]
    for name, x, shape in (("o", o, q.shape), ("to", to, q.shape), ("do", do, q.shape),
                           ("dto", dto, q.shape), ("lse", lse, q.shape[:3]),
                           ("mu", mu, q.shape[:3])):
        if x.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    sm_scale, qk_scale = qk_scales(d, sm_scale)
    of, tof, dof, dtof, muf = o.float(), to.float(), do.float(), dto.float(), mu.float()
    c_row = (dtof * of).sum(-1)
    dhat = (dof * of).sum(-1) + (dtof * tof).sum(-1) - c_row * muf

    def q_side(x):
        return x.float().reshape(b * h, t, *x.shape[3:]).contiguous()

    def kv_side(x):
        return x.float().reshape(b * h, s, d).contiguous()

    return JvpBwdOperands(
        q=q_side(q), k=kv_side(k), v=kv_side(v), tq=q_side(tq), tk=kv_side(tk), tv=kv_side(tv),
        do=q_side(dof), dto=q_side(dtof), lse=q_side(lse), mu=q_side(muf), c=q_side(c_row),
        dhat=q_side(dhat), sm_scale=sm_scale, qk_scale=qk_scale, causal=bool(causal),
        fast=bool(fast),
    )


# --------------------------------------------------------------------------
# Plain versions (whole rows, the same rounding points as the kernels)
# --------------------------------------------------------------------------

def _tile_terms(ops: JvpBwdOperands):
    """(p, tP, dS, tSb) [b*h, t, s] f32 and the rounded operands."""
    rd = rounder(ops.fast)
    qf, kf, vf, tqf, tkf, tvf, dof, dtof = (rd(x) for x in ops[:8])
    t, s = qf.shape[1], kf.shape[1]
    mask = tile_mask(0, 0, t, s, s, ops.causal, device=qf.device)
    kt = kf.transpose(-1, -2)
    p = torch.where(mask, torch.exp2((qf @ kt) * ops.qk_scale - ops.lse[..., None]), 0.0)
    ts = (tqf @ kt + qf @ tkf.transpose(-1, -2)) * ops.sm_scale
    tsmu = ts - ops.mu[..., None]
    tpb = dtof @ vf.transpose(-1, -2)
    c = ops.c[..., None]
    pbar = dof @ vf.transpose(-1, -2) + dtof @ tvf.transpose(-1, -2) + tpb * tsmu - c * ts
    ds = p * (pbar - ops.dhat[..., None])
    tsb = p * (tpb - c)
    return p, p * tsmu, ds, tsb, (qf, kf, vf, tqf, tkf, tvf, dof, dtof)


def jvp_bwd_dkv_plain(ops: JvpBwdOperands):
    """B11's arithmetic in plain PyTorch: (dk, dv, dtk, dtv) [b*h, s, d] f32."""
    rd = rounder(ops.fast)
    p, tp, ds, tsb, (qf, _, _, tqf, _, _, dof, dtof) = _tile_terms(ops)
    pt, tpt, dst, tsbt = (rd(x).transpose(-1, -2) for x in (p, tp, ds, tsb))
    dv = pt @ dof + tpt @ dtof
    dtv = pt @ dtof
    dk = (dst @ qf + tsbt @ tqf) * ops.sm_scale
    dtk = (tsbt @ qf) * ops.sm_scale
    return dk, dv, dtk, dtv


def jvp_bwd_dq_plain(ops: JvpBwdOperands):
    """B12's arithmetic in plain PyTorch: (dq, dtq) [b*h, t, d] f32."""
    rd = rounder(ops.fast)
    _, _, ds, tsb, (_, kf, _, _, tkf, _, _, _) = _tile_terms(ops)
    ds, tsb = rd(ds), rd(tsb)
    return (ds @ kf + tsb @ tkf) * ops.sm_scale, (tsb @ kf) * ops.sm_scale


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def jvp_bwd_prep_plain(ops: JvpBwdOperands):
    """The fast kernels' prep in plain PyTorch: (q, k, v, tq, tk, tv, do, dto)
    in bf16 (round to nearest even, the shapes of `ops`) and the row terms
    (lse, mu, c, dhat) stacked, f32 [4, b*h, t]."""
    return tuple(x.to(torch.bfloat16) for x in ops[:8]), torch.stack(ops[8:12])


def jvp_bwd_prep(ops: JvpBwdOperands):
    """`jvp_bwd_prep_plain`'s result from one kernel launch for CUDA
    operands, byte for byte: the bf16 operands contiguous, the row terms a
    [4, b*h, t] view of [4, b*h, ld] rows (ld = `jvp_tiling.row_stride(t)`).
    CPU operands take the plain version. `jvp_bwd_prep.launches` counts
    kernel launches."""
    if ops.q.device.type == "cpu":
        return jvp_bwd_prep_plain(ops)
    dev, bh, t, s, _ = _launch_args(ops)
    d = ops.q.shape[2]
    ld = jvp_tiling.row_stride(t)
    outs = [torch.empty(x.shape, dtype=torch.bfloat16, device=dev) for x in ops[:8]]
    rows = torch.empty((4, bh, ld), dtype=torch.float32, device=dev)
    arr = ctypes.c_void_p * 8
    status = _kernels().qa_jvp_bwd_prep(
        arr(*(x.data_ptr() for x in ops[:8])), arr(*(x.data_ptr() for x in outs)),
        (ctypes.c_void_p * 4)(*(x.data_ptr() for x in ops[8:12])), rows.data_ptr(), bh, t, s,
        ld, d, torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "jvp_bwd prep")
    jvp_bwd_prep.launches += 1
    return tuple(outs), rows[..., :t]


def _from_prep(ops: JvpBwdOperands, prep) -> JvpBwdOperands:
    """`ops` with the prep's operands (widened back to f32: the values the
    plain fast path rounds them to) and row terms in place of its own."""
    operands, rows = prep
    names = JvpBwdOperands._fields
    return ops._replace(**dict(zip(names[:8], (x.float() for x in operands))),
                        **dict(zip(names[8:12], rows)))


@functools.cache
def _kernels():
    lib = load_kernel("jvp")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.qa_jvp_bwd_dkv.argtypes = [ptr] * 16 + [i32] * 6 + [f32, f32, ptr]
    lib.qa_jvp_bwd_dkv_bf16.argtypes = [ptr] * 13 + [i32] * 6 + [f32, f32, ptr]
    lib.qa_jvp_bwd_prep.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.qa_jvp_bwd_dq.argtypes = [ptr] * 14 + [i32] * 6 + [f32, f32, ptr]
    lib.qa_jvp_bwd_dq_bf16.argtypes = [ptr] * 11 + [i32] * 6 + [f32, f32, ptr]
    for fn in (lib.qa_jvp_bwd_dkv, lib.qa_jvp_bwd_dkv_bf16, lib.qa_jvp_bwd_prep,
               lib.qa_jvp_bwd_dq, lib.qa_jvp_bwd_dq_bf16):
        fn.restype = ctypes.c_int
    return lib


def _launch_args(ops: JvpBwdOperands):
    """Check what the kernels take; returns (device, bh, t, s, the tail of
    every C call)."""
    bh, t, d = ops.q.shape
    s = ops.k.shape[1]
    if any(x.dtype != torch.float32 for x in ops[:12]):
        raise ValueError("the JVP backward kernels take float32 operands (see jvp_bwd_operands)")
    _, dev = kernel_args("B9/B11/B12 fast" if ops.fast else "B9/B11/B12 exact", 1, bh, d,
                         *ops[:12])
    tail = (bh, t, s, int(ops.causal), int(ops.fast), d, ops.sm_scale, ops.qk_scale,
            torch.cuda.current_stream(dev).cuda_stream)
    return dev, bh, t, s, tail


def _fast_args(ops: JvpBwdOperands, prep):
    """The pointers and sizes both fast kernels take after their operands'
    prep (run here, counted, unless `prep` is given): the eight bf16
    operands, the row terms, then (bh, t, s, ld)."""
    operands, rows = prep if prep is not None else jvp_bwd_prep(ops)
    bh, t, _ = operands[0].shape
    return ([x.data_ptr() for x in operands] + [rows.data_ptr()],
            (bh, t, operands[1].shape[1], rows.stride(1)))


def jvp_bwd_dkv(ops: JvpBwdOperands, prep=None):
    """B11: (dk, dv, dtk, dtv) [b*h, s, d] f32. CUDA operands launch the
    kernel (or raise): fast mode on `prep`, `jvp_bwd_prep(ops)`'s result,
    which it runs itself when not given. CPU operands take
    `jvp_bwd_dkv_plain` (on the prep's operands when given)."""
    if ops.q.device.type == "cpu":
        return jvp_bwd_dkv_plain(ops if prep is None else _from_prep(ops, prep))
    dev, bh, t, s, tail = _launch_args(ops)
    outs = [torch.empty((bh, s, ops.q.shape[2]), dtype=torch.float32, device=dev)
            for _ in range(4)]
    if ops.fast:
        jvp_tiling.dkv_grid(bh, t, s)
        ptrs, sizes = _fast_args(ops, prep)
        status = _kernels().qa_jvp_bwd_dkv_bf16(*ptrs, *(x.data_ptr() for x in outs), *sizes,
                                                int(ops.causal), ops.q.shape[2], ops.sm_scale,
                                                ops.qk_scale, tail[-1])
    else:
        status = _kernels().qa_jvp_bwd_dkv(*(x.data_ptr() for x in ops[:12]),
                                           *(x.data_ptr() for x in outs), *tail)
    check_status(status, "jvp_bwd_dkv")
    jvp_bwd_dkv.launches += jvp_tiling.dkv_parts(ops.q.shape[2]) if ops.fast else 1
    return tuple(outs)


def jvp_bwd_dq(ops: JvpBwdOperands, prep=None):
    """B12: (dq, dtq) [b*h, t, d] f32. CUDA operands launch the kernel (or
    raise): fast mode on `prep`, as `jvp_bwd_dkv`. CPU operands take
    `jvp_bwd_dq_plain` (on the prep's operands when given)."""
    if ops.q.device.type == "cpu":
        return jvp_bwd_dq_plain(ops if prep is None else _from_prep(ops, prep))
    dev, bh, t, _, tail = _launch_args(ops)
    outs = [torch.empty_like(ops.q) for _ in range(2)]
    if ops.fast:
        jvp_tiling.q_blocks(bh, t)
        ptrs, sizes = _fast_args(ops, prep)
        status = _kernels().qa_jvp_bwd_dq_bf16(*ptrs, *(x.data_ptr() for x in outs), *sizes,
                                               int(ops.causal), ops.q.shape[2], ops.sm_scale,
                                               ops.qk_scale, tail[-1])
    else:
        status = _kernels().qa_jvp_bwd_dq(*(x.data_ptr() for x in ops[:12]),
                                          *(x.data_ptr() for x in outs), *tail)
    check_status(status, "jvp_bwd_dq")
    jvp_bwd_dq.launches += 1
    return tuple(outs)


jvp_bwd_prep.launches = 0
jvp_bwd_dkv.launches = 0
jvp_bwd_dq.launches = 0


def attention_jvp_bwd(q, k, v, tq, tk, tv, o, to, lse, mu, do, dto, causal=False,
                      sm_scale=None, fast=False):
    """VJP of (q, k, v, tq, tk, tv) -> (O, tO). Returns
    (dq, dk, dv, dtq, dtk, dtv) f32 in the inputs' shapes. CUDA tensors run
    B11 and B12 (head_dim 64 or 128; fast mode on one `jvp_bwd_prep` launch
    shared by both); CPU tensors their plain versions (fast mode on the
    plain prep's operands)."""
    ops = jvp_bwd_operands(q, k, v, tq, tk, tv, o, to, lse, mu, do, dto, causal, sm_scale, fast)
    prep = jvp_bwd_prep(ops) if fast else None  # one prep for both fast kernels
    dk, dv, dtk, dtv = jvp_bwd_dkv(ops, prep)
    dq, dtq = jvp_bwd_dq(ops, prep)
    qs, ks = q.shape, k.shape
    return (dq.reshape(qs), dk.reshape(ks), dv.reshape(ks), dtq.reshape(qs), dtk.reshape(ks),
            dtv.reshape(ks))
