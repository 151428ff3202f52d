"""Carry the JAX package's LM and DiT params over to this package.

Both packages store weights [in, out] and project with `x @ w`, so the
conversion is a dtype/device move with no transpose. The input is the JAX
params tree as array-likes (numpy arrays, or JAX arrays, which numpy reads
without importing JAX here). Weight-only quantized leaves of the JAX
package (`QuantizedWeight`: w_i8, scale, axis; `QuantizedWeight4`: packed,
scale, k, group) are recognised by those fields and carried across as int8
payloads and f32 scales, with no re-quantization. Their `via` is not
carried: this package's quantized matmuls always run B17/B18 (the plain
versions on the CPU), so a leaf the JAX package would dequantize-then-dot
(via="xla") runs the kernel here, within a few bf16 ulps of that arm.
"""

from __future__ import annotations

import numpy as np
import torch

from quantizedattention_tpu_torch.models.dit import DIT_LAYER_KEYS
from quantizedattention_tpu_torch.quantize.weights import QuantizedWeight, QuantizedWeight4

_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")


def params_from_jax(tree, device, dtype=torch.float32):
    """{"embed", "unembed", "final_norm", "layers": [{ln1, wq, ...}]} of
    array-likes -> the same dict of tensors on `device`, floating leaves as
    `dtype`; quantized leaves keep their int8 payloads and f32 scales."""

    def raw(a, np_dtype):
        return torch.from_numpy(np.array(a, dtype=np_dtype)).to(device)

    def conv(a):
        if hasattr(a, "w_i8"):
            return QuantizedWeight(raw(a.w_i8, np.int8), raw(a.scale, np.float32), int(a.axis))
        if hasattr(a, "packed"):
            return QuantizedWeight4(raw(a.packed, np.int8), raw(a.scale, np.float32), int(a.k),
                                    int(a.group))
        # via f32: exact for the f32 and bf16 arrays the JAX package holds
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)

    return {
        "embed": conv(tree["embed"]),
        "unembed": conv(tree["unembed"]),
        "final_norm": conv(tree["final_norm"]),
        "layers": [{key: conv(layer[key]) for key in _LAYER_KEYS} for layer in tree["layers"]],
    }



def dit_params_from_jax(tree, device, dtype=torch.float32):
    """{"t_mlp1", "t_mlp2", "out", "layers": [{ada, wq, wk, wv, wo, w1, w2}]}
    of array-likes (the JAX `init_dit` tree) -> the same dict of tensors on
    `device` as `dtype`, with no transpose: both packages store [in, out]."""

    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)

    return {
        "t_mlp1": conv(tree["t_mlp1"]),
        "t_mlp2": conv(tree["t_mlp2"]),
        "out": conv(tree["out"]),
        "layers": [{key: conv(layer[key]) for key in DIT_LAYER_KEYS} for layer in tree["layers"]],
    }
