"""Projection and embedding helpers, plain or with weight-only int8/int4.

Counterpart of quantizedattention_tpu/quantize/weights.py. Weights are
[in, out] and projections are `x @ w`, exactly as in the JAX package. A plain
tensor goes to torch.matmul, as the JAX package leaves it to XLA. A
`QuantizedWeight` (int8, one f32 scale per output column) runs B17
(ops/int8_linear.py) and a `QuantizedWeight4` (split-half packed int4, one
f32 scale per (group, column)) runs B18 (ops/int4_linear.py): the kernels
on CUDA tensors, their plain versions on CPU ones. The embedding table quantizes per row and dequantizes the gathered rows in
bf16, which sets the activation dtype of a quantized forward.

The quantizers run eagerly in the JAX package's serving engine, where
absmax / 127 and absmax / 7 are true divisions (unlike its jitted attention
quantizers, which multiply by f32(1/127)), so these divide too.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch.ops.int4_linear import int4_weight_matmul, pack_int4, unpack_int4
from quantizedattention_tpu_torch.ops.int8_linear import int8_weight_matmul
from quantizedattention_tpu_torch.quantize.int8 import _EPS, INT8_MAX, quantize_int8

INT4_MAX = 7.0


@dataclasses.dataclass
class QuantizedWeight:
    """An int8 tensor and its f32 per-channel scale along `axis`: axis=1 for
    a [k, n] linear weight (per output column), axis=0 for a [vocab, d]
    embedding (per row)."""

    w_i8: torch.Tensor
    scale: torch.Tensor
    axis: int = 1

    @property
    def shape(self):
        return self.w_i8.shape

    def to(self, device) -> "QuantizedWeight":
        """The same weight on `device`; payload and scale keep their dtypes."""
        return dataclasses.replace(self, w_i8=self.w_i8.to(device), scale=self.scale.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        shape = [1] * self.w_i8.ndim
        shape[self.axis] = -1
        return (self.w_i8.float() * self.scale.reshape(shape)).to(dtype)


@dataclasses.dataclass
class QuantizedWeight4:
    """A [k, n] weight as split-half packed int4 nibbles `packed` [Kp/2, n]
    and group scales `scale` [Kp/group, n] f32, Kp being k padded with zero
    rows to a multiple of 2 * group."""

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    group: int = 128

    @property
    def shape(self):
        return (self.k, self.packed.shape[1])

    def to(self, device) -> "QuantizedWeight4":
        """The same weight on `device`; payload and scale keep their dtypes."""
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scale=self.scale.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        lo, hi = unpack_int4(self.packed)
        w4 = torch.cat([lo, hi], dim=0).float()
        kp, n = w4.shape
        wg = w4.reshape(kp // self.group, self.group, n) * self.scale[:, None, :]
        return wg.reshape(kp, n)[: self.k].to(dtype)


def quantize_weight(w: torch.Tensor, axis: int = 1) -> QuantizedWeight:
    """Symmetric absmax/127 int8 per channel along `axis` (the kept axis)."""
    reduce = tuple(a for a in range(w.ndim) if a != axis)
    amax = w.float().abs().amax(dim=reduce, keepdim=True)
    scale = torch.clamp_min(amax, _EPS) / INT8_MAX
    return QuantizedWeight(quantize_int8(w, scale), scale.reshape(-1), axis)


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> QuantizedWeight4:
    """Symmetric absmax/7 int4 with one scale per (`group` k rows, column)."""
    if w.ndim != 2:
        raise ValueError("quantize_weight_int4 wants a [k, n] matrix")
    k, n = w.shape
    kp = -(-k // (2 * group)) * (2 * group)
    wg = F.pad(w.float(), (0, 0, 0, kp - k)).reshape(kp // group, group, n)
    scale = torch.clamp_min(wg.abs().amax(dim=1), _EPS) / INT4_MAX  # [Kp/group, n]
    w4 = torch.clamp(torch.round(wg / scale[:, None, :]), -8.0, INT4_MAX)
    return QuantizedWeight4(pack_int4(w4.reshape(kp, n).to(torch.int8)), scale, k, group)


# the LM's linear weights ([in, out]: a scale per output column)
_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


def quantize_lm_weights(params: dict, include_embed: bool = True, bits: int = 8,
                        group: int = 128) -> dict:
    """A models.transformer params dict with its matmul weights quantized to
    int8 (bits=8, per output column) or int4 (bits=4, `group`-row group
    scales; JAX weights.py:139-175 without `via`). Norm gains stay as they
    are; the embedding table is per-row int8 at either width, or stays as it
    is with include_embed=False. Every prefill and decode path takes the
    result: matmuls go through `mm`, gathers through `embedding_lookup`."""
    if bits == 8:
        def quant(w):
            return quantize_weight(w, axis=1)
    elif bits == 4:
        def quant(w):
            return quantize_weight_int4(w, group=group)
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out = dict(params)
    out["layers"] = [{key: quant(leaf) if key in _LINEAR_KEYS else leaf
                      for key, leaf in layer.items()} for layer in params["layers"]]
    out["unembed"] = quant(params["unembed"])
    if include_embed:
        out["embed"] = quantize_weight(params["embed"], axis=0)
    return out


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., in] @ w for a plain [in, out] tensor, a QuantizedWeight (int8,
    axis=1, through B17) or a QuantizedWeight4 (through B18); leading dims
    of x are flattened into rows for the kernels. Quantized weights return
    x's dtype."""
    if isinstance(w, QuantizedWeight4):
        lead = x.shape[:-1]
        xr = x.reshape(-1, x.shape[-1])
        kp = 2 * w.packed.shape[0]
        if kp != w.k:  # zero-pad the contraction to the packed length
            xr = F.pad(xr, (0, kp - w.k))
        out = int4_weight_matmul(xr, w.packed, w.scale, group=w.group)
        return out.reshape(*lead, w.packed.shape[1])
    if not isinstance(w, QuantizedWeight):
        return torch.matmul(x, w)
    if w.axis != w.w_i8.ndim - 1:
        raise ValueError("mm wants output-channel scales (axis=last)")
    lead = x.shape[:-1]
    out = int8_weight_matmul(x.reshape(-1, x.shape[-1]), w.w_i8, w.scale)
    return out.reshape(*lead, w.w_i8.shape[1])


def embedding_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """embed[tokens] for a plain table (its own dtype) or a row-quantized
    QuantizedWeight, whose rows dequantize in bf16, the serving activation
    dtype: payload and scale are each cast to bf16, then multiplied, as the
    JAX package's default does."""
    if not isinstance(embed, QuantizedWeight):
        return embed[tokens]
    if embed.axis != 0:
        raise ValueError("embedding_lookup wants per-row scales (axis=0)")
    bf16 = torch.bfloat16
    return embed.w_i8[tokens].to(bf16) * embed.scale[tokens][..., None].to(bf16)


def quantize_lm_specs(specs: dict, include_embed: bool = True) -> dict:
    """The spec-tree twin of `quantize_lm_weights(bits=8)` (JAX
    weights.py:177-208): each quantized leaf's spec becomes a QuantizedWeight
    whose `w_i8` holds the weight's own spec and whose `scale` holds its
    output-axis entry, so a column scale shards with the columns it scales
    and a contraction-sharded weight (wo, w2) keeps a replicated scale,
    applied after the local product (scaling commutes with the psum). The
    embedding's per-row scale follows its row axis; include_embed=False
    leaves the embedding's spec as it is, as quantize_lm_weights leaves the
    table. int8 only: int4's split-half packing does not split along the
    contraction."""

    def q(spec):
        return QuantizedWeight(w_i8=spec, scale=(spec[1] if len(spec) > 1 else None,), axis=1)

    out = dict(specs)
    out["layers"] = [{key: q(leaf) if key in _LINEAR_KEYS else leaf for key, leaf in layer.items()}
                     for layer in specs["layers"]]
    out["unembed"] = q(specs["unembed"])
    if include_embed:
        e = specs["embed"]
        out["embed"] = QuantizedWeight(w_i8=e, scale=(e[0] if len(e) > 0 else None,), axis=0)
    return out
