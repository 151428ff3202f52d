"""Weight-only int4 matmul (B18): bf16 activations times packed int4 weights.

Counterpart of quantizedattention_tpu/ops/int4_linear.py. Split-half
packing: for a [Kp, n] weight (Kp a multiple of 2 * group), byte [r, c] of
the packed [Kp/2, n] int8 array holds row r in its low nibble and row
r + Kp/2 in its high nibble. Group scales [Kp/group, n] f32, the lower
half's groups first. For each group t the two sub-dots, one per half, are
taken in f32 from bf16 x and the exact int4 values, each is multiplied by its
own scale row and added to the accumulator; the result is cast to
`out_dtype` (default x's dtype) once.

`int4_weight_matmul` launches the hand-written Hopper kernel
(csrc/int4_linear.cu) for CUDA tensors and runs `int4_weight_matmul_plain`
for CPU tensors; the two differ only in the order of the f32 sums.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.int8_linear import OUT_TYPES
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

_CHUNK = 64  # the kernel's k rows per step; a group must be a multiple of it


def pack_int4(w4: torch.Tensor) -> torch.Tensor:
    """[K, n] int4-valued int8 (each in [-8, 7]) -> [K/2, n] packed bytes:
    byte r = (w4[r] & 0xF) | (w4[r + K/2] << 4). K must be even."""
    k = w4.shape[0]
    if k % 2 != 0:
        raise ValueError(f"pack_int4 wants an even K, got {k}")
    lo = w4[: k // 2].to(torch.int32) & 0xF
    hi = w4[k // 2:].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor):
    """[K/2, n] packed bytes -> (lo, hi) int32 halves, sign-extended."""
    p = packed.to(torch.int32)  # sign-extended byte
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4  # arithmetic shift: bits 4-7, sign-extended
    return lo, hi


def _check_args(x, packed, scale, group):
    if x.ndim != 2 or packed.ndim != 2 or scale.ndim != 2:
        raise ValueError("int4_weight_matmul wants x [m,Kp], packed [Kp/2,n], scale [Kp/group,n]")
    kp = x.shape[1]
    half, n = packed.shape
    if group <= 0 or kp != 2 * half or half % group != 0 or tuple(scale.shape) != (kp // group, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}, group {group}")


def int4_weight_matmul_plain(x, packed, scale, group: int = 128, out_dtype=None):
    """B18's arithmetic in plain PyTorch, group by group, lower half first."""
    _check_args(x, packed, scale, group)
    half = packed.shape[0]
    n_groups = half // group
    xb = x.to(torch.bfloat16).float()
    lo, hi = unpack_int4(packed)
    s = scale.float()
    acc = torch.zeros((x.shape[0], packed.shape[1]), dtype=torch.float32, device=x.device)
    for t in range(n_groups):
        rows = slice(t * group, (t + 1) * group)
        acc = acc + (xb[:, rows] @ lo[rows].float()) * s[t]
        acc = acc + (xb[:, half:][:, rows] @ hi[rows].float()) * s[n_groups + t]
    return acc.to(out_dtype or x.dtype)


@functools.cache
def _kernel():
    fn = load_kernel("int4_linear").qa_int4_linear
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_args(x, packed, scale, group, out_dtype):
    """Check what the kernel takes; returns (device, bf16 x, f32 scale)."""
    if packed.dtype != torch.int8 or out_dtype not in OUT_TYPES or group % _CHUNK != 0:
        raise ValueError(f"kernel takes int8 packed weights, a group that is a multiple of "
                         f"{_CHUNK} and an output in {list(OUT_TYPES)}; got {packed.dtype}, "
                         f"group {group}, {out_dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    sf = scale.float().contiguous()
    return require_cuda(xb, packed, sf), xb, sf


def int4_weight_matmul(x, packed, scale, group: int = 128, out_dtype=None):
    """B18: x [m, Kp] (any float dtype; computed in bf16) times a split-half
    packed int4 weight [Kp/2, n] with group scales [Kp/group, n] f32; Kp
    must be a multiple of 2 * group and x already padded to it
    (`quantize.weights.mm` does both). Returns [m, n] in `out_dtype` (default
    x.dtype). CUDA tensors launch the kernel (group a multiple of 64) or
    raise; CPU tensors take `int4_weight_matmul_plain`. `.launches` counts
    kernel launches."""
    _check_args(x, packed, scale, group)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int4_weight_matmul_plain(x, packed, scale, group, out_dtype)
    dev, xb, sf = _launch_args(x, packed, scale, group, out_dtype)
    m = xb.shape[0]
    half, n = packed.shape
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    status = _kernel()(xb.data_ptr(), packed.data_ptr(), sf.data_ptr(), out.data_ptr(), m, n, half,
                       group, OUT_TYPES[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "int4_linear")
    int4_weight_matmul.launches += 1
    return out


int4_weight_matmul.launches = 0
