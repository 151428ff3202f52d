"""Carry the JAX package's LM params over to this package.

Both packages store weights [in, out] and project with `x @ w`, so the
conversion is a dtype/device move with no transpose. The input is the JAX
params tree as array-likes (numpy arrays, or JAX arrays, which numpy reads
without importing JAX here).
"""

from __future__ import annotations

import numpy as np
import torch

_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")


def params_from_jax(tree, device, dtype=torch.float32):
    """{"embed", "unembed", "final_norm", "layers": [{ln1, wq, ...}]} of
    array-likes -> the same dict of tensors on `device` as `dtype`."""

    def conv(a):
        # via f32: exact for the f32 and bf16 arrays the JAX package holds
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)

    return {
        "embed": conv(tree["embed"]),
        "unembed": conv(tree["unembed"]),
        "final_norm": conv(tree["final_norm"]),
        "layers": [{key: conv(layer[key]) for key in _LAYER_KEYS} for layer in tree["layers"]],
    }
