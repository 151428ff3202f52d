"""Projection and embedding helpers for plain (unquantized) weights.

Counterpart of quantizedattention_tpu/quantize/weights.py's plain-tensor
path. Weights are [in, out] and projections are `x @ w`, exactly as in the
JAX package, which leaves them to XLA; here they go to torch.matmul. The
weight-only int8/int4 formats are not ported yet.
"""

from __future__ import annotations

import torch


def _plain(w):
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"{type(w).__name__} weights: only plain tensors are ported (no weight quantization)")
    return w


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., in] @ w [in, out]."""
    return torch.matmul(x, _plain(w))


def embedding_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """embed[tokens] for a plain [vocab, d_model] table (its own dtype)."""
    return _plain(embed)[tokens]
