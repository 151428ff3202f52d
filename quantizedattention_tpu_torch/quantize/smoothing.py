"""K-smoothing: subtract the per-(batch, head) channel mean of K over tokens.

Counterpart of quantizedattention_tpu/quantize/smoothing.py. Since q . mean(K)
is the same for every key of a query row, subtracting the mean shifts each
softmax row by a constant: the attention output is unchanged and only the
int8 quantization error shrinks.
"""

from __future__ import annotations

import torch

# K-smoothing reduces over the token axis of [batch, head, tokens, head_dim].
K_SMOOTH_AXIS_TOKENS = -2


def k_smooth(k: torch.Tensor):
    """Return (k - mean, mean) with the mean over tokens, shaped [b, h, 1, d]
    and taken in f32, then cast back to k's dtype."""
    k_mean = k.float().mean(dim=K_SMOOTH_AXIS_TOKENS, keepdim=True).to(k.dtype)
    return k - k_mean, k_mean
