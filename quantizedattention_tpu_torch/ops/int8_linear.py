"""Weight-only int8 matmul (B17): bf16 activations times int8 weights.

Counterpart of quantizedattention_tpu/ops/int8_linear.py. out[m, n] =
(x[m, k] @ w_i8[k, n]) * scale[n]: x is cast to bf16, the int8 weights enter
the product exactly (|w| <= 128 is exact in bf16), products accumulate in f32
over all of k, the f32 per-column scale is applied once at the end and the
result is cast to `out_dtype` (default x's dtype).

`int8_weight_matmul` launches the hand-written Hopper kernel
(csrc/int8_linear.cu) for CUDA tensors and runs
`int8_weight_matmul_plain`, the same arithmetic in plain PyTorch, for CPU
tensors; the two differ only in the order of the f32 sums.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

# output dtype -> the kernel's type code
OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(x, w_i8, scale):
    if x.ndim != 2 or w_i8.ndim != 2 or scale.ndim != 1:
        raise ValueError("int8_weight_matmul wants x [m,k], w [k,n], scale [n]")
    if x.shape[1] != w_i8.shape[0] or w_i8.shape[1] != scale.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w_i8.shape)}, "
                         f"scale {tuple(scale.shape)}")


def int8_weight_matmul_plain(x, w_i8, scale, out_dtype=None):
    """B17's arithmetic in plain PyTorch."""
    _check_args(x, w_i8, scale)
    acc = x.to(torch.bfloat16).float() @ w_i8.float()  # products exact in f32
    return (acc * scale.float()).to(out_dtype or x.dtype)


@functools.cache
def _kernel():
    fn = load_kernel("int8_linear").qa_int8_linear
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_args(x, w_i8, scale, out_dtype):
    """Check what the kernel takes; returns (device, bf16 x, f32 scale)."""
    if w_i8.dtype != torch.int8 or out_dtype not in OUT_TYPES:
        raise ValueError(f"kernel takes int8 weights and an output in {list(OUT_TYPES)}; got "
                         f"{w_i8.dtype}, {out_dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    sf = scale.float().contiguous()
    return require_cuda(xb, w_i8, sf), xb, sf


def int8_weight_matmul(x, w_i8, scale, out_dtype=None):
    """B17: x [m, k] (any float dtype; computed in bf16) @ w_i8 [k, n] int8,
    times the per-output-channel scale [n]. Returns [m, n] in `out_dtype`
    (default x.dtype). CUDA tensors launch the kernel or raise; CPU tensors
    take `int8_weight_matmul_plain`. `.launches` counts kernel launches."""
    _check_args(x, w_i8, scale)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_weight_matmul_plain(x, w_i8, scale, out_dtype)
    dev, xb, sf = _launch_args(x, w_i8, scale, out_dtype)
    (m, k), n = xb.shape, w_i8.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    status = _kernel()(xb.data_ptr(), w_i8.data_ptr(), sf.data_ptr(), out.data_ptr(), m, n, k,
                       OUT_TYPES[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    check_status(status, "int8_linear")
    int8_weight_matmul.launches += 1
    return out


int8_weight_matmul.launches = 0
