"""Ulysses (DeepSpeed-style) sequence parallelism: an all-to-all swaps the
sequence split for a head split.

Counterpart of quantizedattention_tpu/parallel/ulysses.py. The inputs arrive
sequence-sharded over the `context` axis; one all-to-all a tensor re-shards
them by heads with the whole sequence on each rank, the one-device attention
runs on that (aligned causal: no offsets), and a second all-to-all restores
the sequence split of the output. kind "bf16" runs `flash_attention_bf16`
(B1; backward B2 + B3), "int8" `sage_attention_int8` (B4, B5; backward B7 +
B8), which quantizes each head's whole sequence. The all-to-all is a
torch.autograd.Function whose backward is the reverse all-to-all (its
transpose). Needs the q heads and the kv heads both divisible by the axis
size: only the kv heads' payload moves (GQA-native kernels).
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.ops.api import flash_attention_bf16, sage_attention_int8
from quantizedattention_tpu_torch.parallel.mesh import all_to_all, axis_size

_KINDS = {"bf16": flash_attention_bf16, "int8": sage_attention_int8}


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return all_to_all(g.contiguous(), mesh, axis, concat_dim, split_dim), None, None, None, None


def ulysses_attention(q, k, v, mesh, axis: str = "context", causal: bool = False,
                      sm_scale: float | None = None, kind: str = "bf16") -> torch.Tensor:
    """Ulysses attention on this rank's sequence shards q [b, h, t_local, d],
    k/v [b, h_kv, t_local, d]. Differentiable for both kinds; returns this
    rank's O shard (f32)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown ulysses kind {kind!r}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError("q heads must be a multiple of kv heads")
    n = axis_size(mesh, axis)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(
            f"ulysses all-to-all needs q heads ({q.shape[1]}) AND kv heads "
            f"({k.shape[1]}) divisible by the axis size ({n}); for fewer kv "
            f"heads than ranks use ring/zigzag/allgather SP instead")

    def swap_in(x):  # [b, h, t_loc, d] -> [b, h / n, t, d]
        return _AllToAll.apply(x, mesh, axis, 1, 2)

    o = _KINDS[kind](swap_in(q), swap_in(k), swap_in(v), causal=causal, sm_scale=sm_scale)
    return _AllToAll.apply(o, mesh, axis, 2, 1)  # [b, h / n, t, d] -> [b, h, t_loc, d]


def make_ulysses_attention(mesh, kind: str = "bf16", causal: bool = False,
                           sm_scale: float | None = None, context_axis: str = "context"):
    """(q, k, v) -> O on this rank's (batch, head, sequence) block of `mesh`
    through `ulysses_attention` (`spec` as make_ring_attention's)."""

    def sharded(q, k, v):
        return ulysses_attention(q, k, v, mesh, context_axis, causal=causal, sm_scale=sm_scale,
                                 kind=kind)

    sharded.spec = ("data", "model", context_axis, None)
    return sharded
