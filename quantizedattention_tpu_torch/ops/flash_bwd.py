"""Flash-attention backward: CUDA kernels and plain versions.

Counterpart of quantizedattention_tpu/ops/flash_bwd.py. `flash_attention_bwd`
takes the forward's residuals (q, k, v, O, lse) and dO and returns
(dq, dk, dv) in f32, with dk/dv on the kv-head count (the GQA group sum runs
inside the dK/dV kernel). It runs hand-written Hopper kernels
(csrc/flash_bwd.cu) for CUDA tensors:

  bwd_prep       fast mode's operand prep, one launch: q_s, dO_s, D (and lse);
  flash_bwd_dkv  B2, dK and dV per 128-key block over all q tiles;
  flash_bwd_dq   B3, dQ per block of the GQA group's rows over all kv tiles;

and their plain PyTorch versions (`bwd_prep_plain`, `flash_bwd_dkv_plain`,
`flash_bwd_dq_plain`) for CPU tensors. Each wrapper counts its launches
(`.launches`). f32 K and V take flash_fwd.py's `kv_to_bf16` launch in fast
mode (bf16 K and V none); exact mode's prep is plain torch ops.

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
card, which is PyTorch's default), except that dP is summed in float64 and
the f32 D subtracted there before dS is rounded to f32: where dP - D cancels
(one visible key, O = bf16(V)) an f32 sum's rounding would decide dS, and
differently in the kernel and here.

Causal masking is on global positions (flash_bwd.py:200-201): query i at
q_offset + i, key j at k_offset + j, as in the forward. A row that saw no key
(forward lse -inf, O = 0) gets zero gradients: the prep hands its lse to the
kernels as +inf, so P = exp2(S - lse) is 0 for it. Only fast mode takes
offsets on the card; exact mode's kernels raise ValueError on a causal call
whose offsets differ (the plain versions take them in both modes).

The fast kernels read lse and D as rows `flash_tiling.lse_row_stride(t)`
floats apart (a 16-byte row start for TMA): `bwd_prep` writes them so, and
the operands hand the plain versions [b*h_kv, rep, t] views of them. The
launch geometry is ops/flash_tiling.py's. On the card both modes take head
dim 64 or 128 (ops/common.py:check_head_dim).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops import flash_tiling
from quantizedattention_tpu_torch.ops.common import (
    MASK_VALUE,
    check_head_dim,
    check_offsets,
    qk_scales,
    tile_mask,
)
from quantizedattention_tpu_torch.ops.flash_fwd import (
    _kernel_ready,
    _strides,
    kv_to_bf16,
)
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

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
    q_offset: int = 0  # global position of the first query (causal masking)
    k_offset: int = 0  # global position of the first key


def _kernel_lse(lse):
    """The lse the kernels recompute P against: f32, with a row that saw no
    key (-inf) as +inf, so that its P is 0."""
    lse = lse.float()
    return torch.where(lse == -torch.inf, torch.inf, lse)


def _prep_row_term(dos, o):
    """D = rowsum(dos * f32(O)) in the prep kernel's order: the products of
    each 8 head dims (one thread's) summed in turn, then those partials
    pairwise (the threads' butterfly), so the two agree bit for bit at the
    kernel's head dims. Any other head dim is padded with zeros, to 8 dims
    a partial and a power of two of partials (adding 0.0 is exact)."""
    prods = dos * o.float()
    d = prods.shape[-1]
    parts = max(1, -(-d // 8))
    width = 8 * (1 << (parts - 1).bit_length())
    prods = torch.nn.functional.pad(prods, (0, width - d)).unflatten(-1, (-1, 8))
    part = prods[..., 0]
    for e in range(1, 8):
        part = part + prods[..., e]
    while part.shape[-1] > 1:
        part = part[..., 0::2] + part[..., 1::2]
    return part[..., 0]


def bwd_prep_plain(q, o, do, lse, qk_scale: float, sm_scale: float):
    """Fast mode's q/dO/D prep in plain PyTorch: (q_s, dO_s) bf16 [b, h, t,
    d] with q_s = bf16(f32(q) * qk_scale) and dO_s = bf16(f32(dO) *
    sm_scale), then lse (-inf as +inf) and D = rowsum(f32(dO) * sm_scale *
    f32(O)), f32 [b, h, t], summed as the kernel sums it."""
    dos = do.float() * sm_scale
    return ((q.float() * qk_scale).to(torch.bfloat16), dos.to(torch.bfloat16), _kernel_lse(lse),
            _prep_row_term(dos, o))


def bwd_prep(q, o, do, lse, qk_scale: float, sm_scale: float):
    """`bwd_prep_plain`'s result from one kernel launch for CUDA tensors (q,
    dO and O f32 or bf16 with any strides, rows contiguous; head_dim 64 or
    128): q_s and dO_s contiguous and byte-equal to the plain version's, lse
    and D as [b, h, t] views of [b, h, ld] rows (ld =
    `flash_tiling.lse_row_stride`), D equal to the plain version's (the same
    f32 sums in the same order). CPU tensors take `bwd_prep_plain`.
    `bwd_prep.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return bwd_prep_plain(q, o, do, lse, qk_scale, sm_scale)
    b, h, t, d = q.shape
    check_head_dim("B2/B3 fast", d)
    if b * h > 65535:
        raise ValueError(f"kernel takes b*h <= 65535; got b*h={b * h}")
    ready = [_kernel_ready(x, (torch.float32, torch.bfloat16)) for x in (q, do, o)]
    lse_in = lse.float().contiguous()
    dev = require_cuda(lse_in)
    if any(x.device != dev for x in ready):
        raise ValueError(f"q, dO, O and lse lie on {[str(x.device) for x in ready]} and {dev}")
    ld = flash_tiling.lse_row_stride(t)
    qs = torch.empty((b, h, t, d), dtype=torch.bfloat16, device=dev)
    dos = torch.empty_like(qs)
    rows = torch.empty((2, b, h, ld), dtype=torch.float32, device=dev)
    args = [a for x in ready for a in (x.data_ptr(), *_strides(x), int(x.dtype == torch.float32))]
    status = _kernels().qa_flash_bwd_prep(
        *args, lse_in.data_ptr(), qs.data_ptr(), dos.data_ptr(), rows[0].data_ptr(),
        rows[1].data_ptr(), b, h, t, ld, qk_scale, sm_scale, d,
        torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "flash_bwd prep")
    bwd_prep.launches += 1
    return qs, dos, rows[0, ..., :t], rows[1, ..., :t]


bwd_prep.launches = 0


def _kv_bf16(k, v):
    """Fast mode's K and V in bf16: f32 (or other) CUDA tensors through one
    `kv_to_bf16` launch, bf16 ones as they are."""
    if k.device.type == "cuda" and not k.dtype == v.dtype == torch.bfloat16:
        check_head_dim("B2/B3 fast", k.shape[-1])
        return kv_to_bf16(_kernel_ready(k, (torch.float32,)), _kernel_ready(v, (torch.float32,)))
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


def bwd_operands(q, k, v, o, lse, do, causal=False, sm_scale=None, fast=False,
                 plain=False, q_offset=0, k_offset=0) -> BwdOperands:
    """Scale, round and lay out the residuals for the kernels (any strides
    in). Fast mode on CUDA tensors: one `bwd_prep` launch for q, dO and D
    and one `kv_to_bf16` launch for f32 K and V, unless `plain` (then torch
    ops, as on the CPU). q_offset/k_offset: host ints >= 0, as the
    forward's."""
    q_offset, k_offset = check_offsets(q_offset, k_offset)
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
    if fast and plain:
        qs, dos, lse_r, di = bwd_prep_plain(q, o, do, lse, qk_scale, sm_scale)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    elif fast:
        qs, dos, lse_r, di = bwd_prep(q, o, do, lse, qk_scale, sm_scale)
        kb, vb = _kv_bf16(k, v)
    else:
        dos = do.float() * sm_scale
        qs, kb, vb, lse_r, di = q.float() * qk_scale, k.float(), v.float(), _kernel_lse(lse), \
            (dos * o.float()).sum(-1)

    def heads(x):  # [b, h, t, ...] -> [b*h_kv, rep, t, ...]
        return x.reshape(b * h_kv, rep, *x.shape[2:])

    def kv(x):
        return x.reshape(b * h_kv, s, d).contiguous()

    # q_s and dO_s contiguous; on CUDA, fast mode's lse and D keep the
    # kernels' row stride (views of bwd_prep's rows, never copied)
    rows = [heads(x) for x in (lse_r, di)]
    if plain or not (fast and q.device.type == "cuda"):
        rows = [x.contiguous() for x in rows]
    return BwdOperands(
        q=heads(qs).contiguous(), k=kv(kb), v=kv(vb), do=heads(dos).contiguous(), lse=rows[0],
        di=rows[1], sm_scale=sm_scale, qk_scale=qk_scale, causal=bool(causal), fast=bool(fast),
        q_offset=q_offset, k_offset=k_offset,
    )


# --------------------------------------------------------------------------
# Plain versions (whole rows, the same rounding points as the kernels)
# --------------------------------------------------------------------------

def _rounded(x, fast):
    return x.to(torch.bfloat16).float() if fast else x


def _p_ds(ops: BwdOperands):
    """(P, dS) [b*h_kv, rep, t, s] in f32; P recomputed as in _recompute_p.
    Exact mode sums dP in float64 and subtracts D there, then rounds dP - D
    to f32 (as the exact kernels do)."""
    qs, kf, vf, dos = ops.q.float(), ops.k.float()[:, None], ops.v.float()[:, None], ops.do.float()
    t, s = qs.shape[2], kf.shape[2]
    scores = qs @ kf.transpose(-1, -2)
    mask = tile_mask(ops.q_offset, ops.k_offset, t, s, s, ops.causal, k_local_start=0,
                     device=qs.device)
    p = torch.exp2(torch.where(mask, scores, MASK_VALUE) - ops.lse[..., None])
    if ops.fast:
        return p, p * (dos @ vf.transpose(-1, -2) - ops.di[..., None])
    dp = dos.double() @ vf.double().transpose(-1, -2)
    return p, p * (dp - ops.di.double()[..., None]).float()


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
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.qa_flash_bwd_prep.argtypes = [ptr, i64, i64, i64, i32] * 3 + [ptr] * 5 + [i32] * 4 \
        + [f32, f32, i32, ptr]
    lib.qa_flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 9 + [f32, f32, i32, ptr]
    lib.qa_flash_bwd_dq.argtypes = [ptr] * 7 + [i32] * 11 + [ptr]
    for fn in (lib.qa_flash_bwd_prep, lib.qa_flash_bwd_dkv, lib.qa_flash_bwd_dq):
        fn.restype = ctypes.c_int
    return lib


def _rows_ok(x, rep: int, ld: int) -> bool:
    """x [b*h_kv, rep, t] f32 lies in rows ld floats apart (strides of
    dimensions of size 1 are free), 16-byte aligned."""
    return (x.dtype == torch.float32 and x.stride(2) == 1 and x.data_ptr() % 16 == 0
            and (x.shape[1] == 1 or x.stride(1) == ld)
            and (x.shape[0] == 1 or x.stride(0) == rep * ld))


def _launch_args(ops: BwdOperands):
    """Check what the kernels take; returns (device, bh_kv, rep, t, s, ld,
    bq, d): ld the row stride of lse and D, bq fast B3's positions a block."""
    bh_kv, rep, t, d = ops.q.shape
    s = ops.k.shape[1]
    check_head_dim("B2/B3 fast" if ops.fast else "B2/B3 exact", d)
    if ops.fast:
        bq = flash_tiling.bwd_grids(bh_kv, rep, t, s, d)[0]
    elif bh_kv * rep > 65535:
        raise ValueError(f"exact kernels take b*h <= 65535; got {bh_kv * rep}")
    elif ops.causal and ops.q_offset != ops.k_offset:
        raise ValueError("exact kernels take no global offsets (q_offset "
                         f"{ops.q_offset} != k_offset {ops.k_offset}); use fast mode")
    want = torch.bfloat16 if ops.fast else torch.float32
    if any(x.dtype != want for x in (ops.q, ops.k, ops.v, ops.do)):
        raise ValueError(f"fast={ops.fast} kernels take {want} q/k/v/do (see bwd_operands)")
    if ops.lse.dtype != torch.float32 or ops.di.dtype != torch.float32:
        raise ValueError("lse and di must be float32")
    dev = require_cuda(ops.q, ops.k, ops.v, ops.do)
    if not ops.fast:
        require_cuda(ops.lse, ops.di)
        return dev, bh_kv, rep, t, s, t, 0, d
    ld = flash_tiling.lse_row_stride(t)
    if not all(x.device == dev and _rows_ok(x, rep, ld) for x in (ops.lse, ops.di)):
        raise ValueError(f"fast kernels take lse and di as rows {ld} floats apart on {dev} "
                         "(see bwd_prep)")
    return dev, bh_kv, rep, t, s, ld, bq, d


def flash_bwd_dkv(ops: BwdOperands):
    """B2: (dk, dv) [b*h_kv, s, d] f32. CUDA operands launch the kernel (or
    raise); CPU operands take `flash_bwd_dkv_plain`."""
    if ops.q.device.type == "cpu":
        return flash_bwd_dkv_plain(ops)
    dev, bh_kv, rep, t, s, ld, _, d = _launch_args(ops)
    dk = torch.empty((bh_kv, s, d), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    status = _kernels().qa_flash_bwd_dkv(
        ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(), ops.do.data_ptr(),
        ops.lse.data_ptr(), ops.di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh_kv, rep, t, s, ld, int(ops.causal), ops.q_offset, ops.k_offset, int(ops.fast),
        1.0 / ops.qk_scale,
        1.0 / ops.sm_scale, d, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(ops: BwdOperands):
    """B3: dq [b*h_kv, rep, t, d] f32. CUDA operands launch the kernel (or
    raise); CPU operands take `flash_bwd_dq_plain`."""
    if ops.q.device.type == "cpu":
        return flash_bwd_dq_plain(ops)
    dev, bh_kv, rep, t, s, ld, bq, d = _launch_args(ops)
    dq = torch.empty((bh_kv, rep, t, d), dtype=torch.float32, device=dev)
    status = _kernels().qa_flash_bwd_dq(
        ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(), ops.do.data_ptr(),
        ops.lse.data_ptr(), ops.di.data_ptr(), dq.data_ptr(),
        bh_kv, rep, t, s, ld, bq, int(ops.causal), ops.q_offset, ops.k_offset, int(ops.fast), d,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def _unflatten(q, k, dq, dk, dv):
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(k.shape)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, sm_scale=None, fast=False,
                        q_offset=0, k_offset=0):
    """Flash-attention backward from the forward's residuals.

    q/o/do [b, h, t, d], k/v [b, h_kv, s, d], lse [b, h, t] (exp2 domain).
    Returns (dq [b, h, t, d], dk, dv [b, h_kv, s, d]) in f32. CUDA tensors run
    the two kernels (head_dim 64 or 128, either mode); CPU tensors their
    plain versions.
    q_offset/k_offset: the forward's global positions (fast mode on CUDA).
    """
    ops = bwd_operands(q, k, v, o, lse, do, causal, sm_scale, fast, q_offset=q_offset,
                       k_offset=k_offset)
    dk, dv = flash_bwd_dkv(ops)
    return _unflatten(q, k, flash_bwd_dq(ops), dk, dv)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, sm_scale=None, fast=False,
                              q_offset=0, k_offset=0):
    """`flash_attention_bwd` through the plain versions, on any device."""
    ops = bwd_operands(q, k, v, o, lse, do, causal, sm_scale, fast, plain=True,
                       q_offset=q_offset, k_offset=k_offset)
    dk, dv = flash_bwd_dkv_plain(ops)
    return _unflatten(q, k, flash_bwd_dq_plain(ops), dk, dv)
