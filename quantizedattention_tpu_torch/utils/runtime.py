"""Small runtime helpers shared by the kernel wrappers."""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """Check that every tensor lies on one CUDA device, is contiguous and
    starts on a 16-byte boundary.

    Kernel wrappers call this on the CUDA branch: a kernel reads raw
    pointers with 16-byte vector loads, so a strided or offset view, or a
    tensor on another device, would be read as garbage or fault instead of
    raising.
    """
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got one on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError("kernel inputs must be contiguous and 16-byte aligned")
    return dev


def check_status(status: int, what: str) -> None:
    """Raise if a kernel's C entry returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {status}")
