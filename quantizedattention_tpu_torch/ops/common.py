"""Shared kernel helpers: masks, scaling constants, padding."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Large-negative fill for masked logits: finite, so exp2(mask - mask) never
# gives NaN, and far enough below any real scaled logit that exp2 underflows
# to exactly 0 in f32.
MASK_VALUE = -30000.0

# 1/ln(2): converts natural-log-domain softmax to the exp2 domain.
LOG2_E = 1.44269504


def qk_scales(head_dim: int, sm_scale: float | None):
    """(sm_scale, qk_scale): natural-domain and exp2-domain logit scales."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    return sm_scale, sm_scale * LOG2_E


# The head dims each kernel (or mode) takes on the card. CPU tensors take the
# plain versions at any head dim; on CUDA tensors a wrapper checks its
# kernel's entry here and raises, never falling back to the plain version.
# Every kernel takes 64 and 128; ROADMAP B-f3 brings them to head dim 32.
KERNEL_HEAD_DIMS = {
    "B1 bf16": (64, 128),
    "B1 fp32": (64, 128),
    "B2/B3 fast": (64, 128),
    "B2/B3 exact": (64, 128),
    "B4": (64, 128),
    "B5": (64, 128),
    "B6": (64, 128),
    "B7/B8": (64, 128),
    "B9/B11/B12 fast": (64, 128),
    "B9/B11/B12 exact": (64, 128),
    "B10": (64, 128),
    "B13": (64, 128),
    "B14": (64, 128),
    "B15": (64, 128),
    "B16": (64, 128),
}


def check_head_dim(kernel: str, d: int) -> None:
    """Raise ValueError unless `kernel` (a key of KERNEL_HEAD_DIMS) takes
    head dim d on the card."""
    dims = KERNEL_HEAD_DIMS[kernel]
    if d not in dims:
        todo = " (ROADMAP B-f3: head_dim 32 is not ported yet)" if d == 32 else ""
        raise ValueError(f"the {kernel} kernel takes head_dim {' or '.join(map(str, dims))}; "
                         f"got d={d}{todo}")


def check_offsets(q_offset, k_offset) -> tuple[int, int]:
    """The global positions of a shard's first query and key: host ints >= 0
    (a float that is a whole number is taken), or ValueError."""
    if int(q_offset) != q_offset or int(k_offset) != k_offset or q_offset < 0 or k_offset < 0:
        raise ValueError(f"q_offset and k_offset are host ints >= 0; got {q_offset!r}, "
                         f"{k_offset!r}")
    return int(q_offset), int(k_offset)


def tile_mask(
    q_start: int,
    k_start: int,
    block_q: int,
    block_kv: int,
    kv_len: int,
    causal: bool,
    k_local_start: int | None = None,
    device=None,
) -> torch.Tensor:
    """Boolean [block_q, block_kv] mask: True where the logit is valid.

    Causal is `k <= q` on global token positions (q_start/k_start include any
    sequence-shard offset), combined with a kv-length mask for padded keys
    taken against the local position `k_local_start` (defaults to k_start).
    """
    col = torch.arange(block_kv, device=device)[None, :]
    if k_local_start is None:
        k_local_start = k_start
    mask = (k_local_start + col) < kv_len
    if causal:
        row = q_start + torch.arange(block_q, device=device)[:, None]
        mask = mask & ((k_start + col) <= row)
    return mask.expand(block_q, block_kv)


def pad_tokens(x: torch.Tensor, block: int, axis: int) -> torch.Tensor:
    """Zero-pad `axis` up to a multiple of `block`."""
    pad = (-x.shape[axis]) % block
    if pad == 0:
        return x
    axis = axis % x.ndim
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)
