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
CPU tensors take `quant_int8_plain`; the two agree byte for byte.
`quant_int8_scales` runs the same kernel's absmax pass alone, on f32 or bf16
rows: the scale tables the fused inference forward (B6) quantizes with.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

INT8_MAX = 127.0
# f32(1/127): the scale is absmax times it, as the JAX package's jitted code
# computes absmax / 127.
INV_INT8_MAX = 1.0 / INT8_MAX
# Floor for scales so an all-zero block quantizes to zeros instead of NaN.
_EPS = 1e-12

_HEAD_DIM = 64  # the kernel's compiled row width
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
    """One tensor for `quant_int8`: x [rows, t, d] is zero-padded to `pad`
    tokens, shifted by `sub` [rows, d] (K-smoothing; padded rows become
    -sub, as the JAX package's pad-then-subtract gives) and quantized with
    one scale per `grain` tokens."""

    x: torch.Tensor
    pad: int
    grain: int
    sub: torch.Tensor | None = None


def _check_job(job: QuantJob) -> None:
    rows, t, d = job.x.shape
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
        x = F.pad(job.x.float(), (0, 0, 0, job.pad - job.x.shape[1]))
        if job.sub is not None:
            x = x - job.sub.float()[:, None, :]
        out.append(quantize_int8_blocks(x, job.grain))
    return out


@functools.cache
def _kernel():
    fn = load_kernel("quant_int8").qa_quant_int8
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ptrs] * 4 + [ints] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_args(jobs, dtypes=(torch.float32,)) -> torch.device:
    """Check what the kernel takes (rows of one of `dtypes`); returns the
    jobs' device."""
    if not 1 <= len(jobs) <= _MAX_JOBS:
        raise ValueError(f"the kernel takes 1 to {_MAX_JOBS} jobs, got {len(jobs)}")
    for job in jobs:
        _check_job(job)
        if job.x.shape[2] != _HEAD_DIM or job.x.dtype not in dtypes \
                or job.x.dtype != jobs[0].x.dtype:
            raise ValueError(f"kernel takes rows of width (head_dim) {_HEAD_DIM} and one type "
                             f"among {list(dtypes)}; got {job.x.dtype} width {job.x.shape[2]}")
        if job.sub is not None and job.sub.dtype != torch.float32:
            raise ValueError("sub must be float32")
        if job.grain % 16 != 0:
            raise ValueError(f"kernel takes grains that are multiples of 16, got {job.grain}")
    return require_cuda(*(j.x for j in jobs), *(j.sub for j in jobs if j.sub is not None))


def _launch(jobs, out, dev) -> None:
    """One launch over `jobs`; `out` holds each job's (payload or None, scales)."""
    n = len(jobs)

    def ptrs(values):
        return (ctypes.c_void_p * n)(*values)

    def ints(values):
        return (ctypes.c_int * n)(*values)

    status = _kernel()(
        ptrs(j.x.data_ptr() for j in jobs),
        ptrs(None if j.sub is None else j.sub.data_ptr() for j in jobs),
        ptrs(None if x_i8 is None else x_i8.data_ptr() for x_i8, _ in out),
        ptrs(s.data_ptr() for _, s in out),
        ints(j.x.shape[0] for j in jobs), ints(j.x.shape[1] for j in jobs),
        ints(j.pad for j in jobs), ints(j.grain for j in jobs),
        n, IN_TYPES[jobs[0].x.dtype], torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "quant_int8")


def _scales(job, dev) -> torch.Tensor:
    return torch.empty((job.x.shape[0], job.pad // job.grain), dtype=torch.float32, device=dev)


def quant_int8(jobs) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """B4: quantize 1 to 3 `QuantJob`s in one kernel launch.

    CUDA tensors (f32, head_dim 64) launch the kernel or raise; CPU tensors
    take `quant_int8_plain`. `quant_int8.launches` counts kernel launches.
    """
    jobs = list(jobs)
    if not 1 <= len(jobs) <= _MAX_JOBS:
        raise ValueError(f"quant_int8 takes 1 to {_MAX_JOBS} jobs, got {len(jobs)}")
    if jobs[0].x.device.type == "cpu":
        return quant_int8_plain(jobs)
    dev = _launch_args(jobs)
    out = [(torch.empty((j.x.shape[0], j.pad, _HEAD_DIM), dtype=torch.int8, device=dev),
            _scales(j, dev)) for j in jobs]
    _launch(jobs, out, dev)
    quant_int8.launches += 1
    return out


quant_int8.launches = 0


def quant_int8_scales(jobs) -> list[torch.Tensor]:
    """B4's absmax pass alone: the scale table [rows, pad // grain] f32 of
    each of 1 to 3 `QuantJob`s (contiguous f32 or bf16 CUDA rows, head_dim
    64), equal to the scales `quant_int8` gives for the same rows in f32; no
    payload is written. One launch, made as part of the fused inference
    forward, whose wrapper counts it; CPU tensors raise (B6's plain version
    quantizes with `quant_int8_plain`)."""
    jobs = list(jobs)
    dev = _launch_args(jobs, tuple(IN_TYPES))
    out = [(None, _scales(j, dev)) for j in jobs]
    _launch(jobs, out, dev)
    return [s for _, s in out]
