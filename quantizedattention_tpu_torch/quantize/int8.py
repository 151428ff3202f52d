"""Symmetric absmax/127 int8 quantization: pure functions and kernel B4.

Counterpart of quantizedattention_tpu/quantize/int8.py. The pure functions
(`absmax_scale`, `quantize_int8`, `dequantize_int8`, `quantize_int8_blocks`)
have the JAX package's numerics as its compiled kernels compute them: the
scale is s = max(absmax, 1e-12) * fl(1/127) in f32 (XLA's simplifier turns
the division by the constant 127 into a product with its f32 reciprocal, so
s can sit one ulp from an IEEE division), and the payload is
clamp(round_half_even(x / s), -128, 127) with an IEEE division.

`quant_int8` is the wrapper of the hand-written Hopper kernel
(csrc/quant_int8.cu) that replaces the three Pallas quantizers
(`_quant_block_kernel`, `_quant_block_sub_kernel`, `_quant_qkv_kernel`): one
launch quantizes up to three tensors (Q, K and V of one attention call), each
a `QuantJob` with its own padded length, grain and optional K-smoothing shift.
A job's rows are [rows, t, d] or [b, h, t, d] (rows b * h); the kernel reads
them through their strides (token rows contiguous, 16-byte aligned), so the
model's [b, h, t, d] views of [b, t, h, d] activations need no copy. CPU
tensors take `quant_int8_plain`; the two agree byte for byte.
`quant_int8_uncounted` runs the same kernel on f32 or bf16 rows: the fused
inference forward (B6) quantizes Q, K and V with it once per call, and counts
the launch as its own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.common import check_head_dim
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

INT8_MAX = 127.0
# f32(1/127): the scale is absmax times it, as the JAX package's jitted code
# computes absmax / 127.
INV_INT8_MAX = 1.0 / INT8_MAX
# Floor for scales so an all-zero block quantizes to zeros instead of NaN.
_EPS = 1e-12

_MAX_JOBS = 3
# input dtype -> the kernel's type code
IN_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def absmax_scale(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Symmetric scale s = max(absmax(x), 1e-12) * f32(1/127) over `dim`
    (None: the whole tensor)."""
    ax = x.float().abs()
    amax = ax.amax() if dim is None else ax.amax(dim=dim, keepdim=keepdim)
    return torch.clamp_min(amax, _EPS) * INV_INT8_MAX


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize x by a (broadcastable) scale to int8, rounding half to even."""
    return torch.clamp(torch.round(x.float() / scale), -128.0, INT8_MAX).to(torch.int8)


def dequantize_int8(x_int8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x_int8.float() * scale


def quantize_int8_blocks(x: torch.Tensor, block_size: int):
    """Per-block quantization along the token axis of a [..., tokens, d] tensor:
    each (block_size x d) tile shares one scale. Returns (x_int8, scales
    [..., tokens // block_size]); tokens must be a multiple of block_size."""
    *lead, tokens, d = x.shape
    if tokens % block_size != 0:
        raise ValueError(f"tokens={tokens} not divisible by block_size={block_size}")
    xb = x.reshape(*lead, tokens // block_size, block_size, d)
    scales = absmax_scale(xb, dim=(-2, -1))
    return quantize_int8(xb, scales[..., None, None]).reshape(*lead, tokens, d), scales


class QuantJob(NamedTuple):
    """One tensor for `quant_int8`: x [rows, t, d] or [b, h, t, d] (rows b *
    h, row r = (r // h, r % h)) is zero-padded to `pad` tokens, shifted by
    `sub` [rows, d] (K-smoothing; padded rows become -sub, as the JAX
    package's pad-then-subtract gives) and quantized with one scale per
    `grain` tokens."""

    x: torch.Tensor
    pad: int
    grain: int
    sub: torch.Tensor | None = None


def _rows_view(x: torch.Tensor) -> tuple[int, int, int, int]:
    """(rows, heads, t, d) of a job's x, [rows, t, d] (heads = rows) or [b,
    h, t, d]."""
    if x.ndim == 3:
        return x.shape[0], x.shape[0], x.shape[1], x.shape[2]
    if x.ndim == 4:
        return x.shape[0] * x.shape[1], x.shape[1], x.shape[2], x.shape[3]
    raise ValueError(f"want x [rows, t, d] or [b, h, t, d], got {tuple(x.shape)}")


def _check_job(job: QuantJob) -> None:
    rows, _, t, d = _rows_view(job.x)
    if job.grain <= 0 or job.pad % job.grain != 0 or job.pad < t:
        raise ValueError(f"want pad >= t and a multiple of grain; got t={t}, pad={job.pad}, "
                         f"grain={job.grain}")
    if job.sub is not None and tuple(job.sub.shape) != (rows, d):
        raise ValueError(f"sub must be [rows, d] = {(rows, d)}, got {tuple(job.sub.shape)}")


def quant_int8_plain(jobs) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """B4's arithmetic in plain PyTorch: [(payload [rows, pad, d] int8,
    scales [rows, pad // grain] f32)] per job."""
    out = []
    for job in jobs:
        _check_job(job)
        rows, _, t, d = _rows_view(job.x)
        x = F.pad(job.x.float().reshape(rows, t, d), (0, 0, 0, job.pad - t))
        if job.sub is not None:
            x = x - job.sub.float()[:, None, :]
        out.append(quantize_int8_blocks(x, job.grain))
    return out


def _strides(x: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, token) strides in elements of a job's x, as the kernel
    takes them; a dimension of size 1 gets a stride of d (never read)."""
    d = x.shape[-1]
    sizes, strides = (x.shape[:-1], x.stride()[:-1]) if x.ndim == 4 else \
        ((1, *x.shape[:-1]), (0, *x.stride()[:-1]))
    return tuple(st if n > 1 else d for n, st in zip(sizes, strides))


@functools.cache
def _kernel():
    fn = load_kernel("quant_int8").qa_quant_int8
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ptrs, ctypes.POINTER(ctypes.c_longlong), ints] + [ptrs] * 3 + [ints] * 4 \
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_args(jobs, dtypes=(torch.float32,)) -> torch.device:
    """Check what the kernel takes (rows of one of `dtypes`, read through
    their strides: token rows contiguous, pointer and strides 16-byte
    aligned); returns the jobs' device."""
    if not 1 <= len(jobs) <= _MAX_JOBS:
        raise ValueError(f"the kernel takes 1 to {_MAX_JOBS} jobs, got {len(jobs)}")
    for job in jobs:
        _check_job(job)
        check_head_dim("B4", job.x.shape[-1])
        if job.x.shape[-1] != jobs[0].x.shape[-1]:
            raise ValueError(f"kernel takes one head dim for all jobs; got "
                             f"{[j.x.shape[-1] for j in jobs]}")
        if job.x.dtype not in dtypes or job.x.dtype != jobs[0].x.dtype:
            raise ValueError(f"kernel takes one type among {list(dtypes)} for all jobs; got "
                             f"{job.x.dtype}")
        if job.sub is not None and job.sub.dtype != torch.float32:
            raise ValueError("sub must be float32")
    # the kernel's geometry (imported here: the ops package imports this module)
    from quantizedattention_tpu_torch.ops import int8_tiling

    int8_tiling.quant_items([(_rows_view(j.x)[0], j.pad, j.grain) for j in jobs])
    for job in jobs:
        x, size = job.x, job.x.element_size()
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(st * size % 16 for st in _strides(x)):
            raise ValueError("kernel reads rows through their strides: want a unit last stride "
                             "and 16-byte-aligned rows")
    dev = jobs[0].x.device
    for job in jobs:
        if job.x.device.type != "cuda" or job.x.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got one on {job.x.device}")
    subs = [j.sub for j in jobs if j.sub is not None]
    if subs and require_cuda(*subs) != dev:
        raise ValueError(f"sub rows must lie on {dev}")
    return dev


def _launch(jobs, out, dev) -> None:
    """One launch over `jobs`; `out` holds each job's (payload, scales)."""
    n = len(jobs)

    def ptrs(values):
        return (ctypes.c_void_p * n)(*values)

    def ints(values):
        return (ctypes.c_int * n)(*values)

    views = [_rows_view(j.x) for j in jobs]
    status = _kernel()(
        ptrs(j.x.data_ptr() for j in jobs),
        (ctypes.c_longlong * (3 * n))(*(st for j in jobs for st in _strides(j.x))),
        ints(heads for _, heads, _, _ in views),
        ptrs(None if j.sub is None else j.sub.data_ptr() for j in jobs),
        ptrs(x_i8.data_ptr() for x_i8, _ in out),
        ptrs(s.data_ptr() for _, s in out),
        ints(rows for rows, _, _, _ in views), ints(t for _, _, t, _ in views),
        ints(j.pad for j in jobs), ints(j.grain for j in jobs),
        n, IN_TYPES[jobs[0].x.dtype], jobs[0].x.shape[-1],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "quant_int8")


def _quant(jobs, dtypes):
    """One launch over `jobs` of one of `dtypes`: each job's (payload, scales)."""
    dev = _launch_args(jobs, dtypes)
    out = [(torch.empty((_rows_view(j.x)[0], j.pad, j.x.shape[-1]), dtype=torch.int8,
                        device=dev),
            torch.empty((_rows_view(j.x)[0], j.pad // j.grain), dtype=torch.float32, device=dev))
           for j in jobs]
    _launch(jobs, out, dev)
    return out


def quant_int8(jobs) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """B4: quantize 1 to 3 `QuantJob`s in one kernel launch.

    CUDA tensors (f32, head_dim 64 or 128, one for all jobs, read through their
    strides) launch the kernel or raise; CPU tensors take `quant_int8_plain`.
    `quant_int8.launches` counts kernel launches.
    """
    jobs = list(jobs)
    if not 1 <= len(jobs) <= _MAX_JOBS:
        raise ValueError(f"quant_int8 takes 1 to {_MAX_JOBS} jobs, got {len(jobs)}")
    if jobs[0].x.device.type == "cpu":
        return quant_int8_plain(jobs)
    out = _quant(jobs, (torch.float32,))
    quant_int8.launches += 1
    return out


quant_int8.launches = 0


def quant_int8_uncounted(jobs) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """B4 as part of the fused inference forward: one launch over 1 to 3
    `QuantJob`s (f32 or bf16 CUDA rows, head_dim 64 or 128, through their strides) that
    writes each job's payload [rows, pad, d] int8 and scale table [rows, pad //
    grain] f32, byte-equal to what `quant_int8` gives for the same rows in
    f32. Not counted here: the fused forward's wrapper counts its call; CPU
    tensors raise (B6's plain version quantizes with `quant_int8_plain`)."""
    return _quant(list(jobs), tuple(IN_TYPES))
