"""All-gather and KV-sharded attention over the `context` axis, and the
lse-weighted merge of partials across ranks.

Counterpart of quantizedattention_tpu/parallel/collective.py. The ring
(parallel/ring.py) hides the K/V traffic inside its hops; these spend it up
front:

- `allgather_kv_attention` (JAX collective.py:61-115): q stays
  sequence-sharded, the K/V shards are all-gathered to the whole sequence
  and one B1 launch attends with q_offset = idx * t_local, k_offset = 0 (the
  kernels' global offsets, B-f2; t_local queries against n * t_local keys).
  Its backward is B2 + B3 fast at the same offsets, which give each rank
  dK/dV over the whole sequence from its own queries; `psum_scatter` sums
  them over the ranks and hands each its own shard (the transpose of the
  forward's all_gather). dQ needs no collective.
- `kv_sharded_attention` (JAX collective.py:208-225): q replicated, K/V
  sharded; each rank attends its key slice with k_offset = idx * t_local and
  the normalized partials merge by `lse_weighted_merge`. Forward only. Rows
  that see no key of a rank's slice give that rank lse -inf and weight 0.

The int8 twins (JAX collective.py:123-201, :228-247) need the global
offsets in B5, B7 and B8 (queue B, B-f2), which the port's int8 kernels do
not take yet: they raise NotImplementedError.
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    pmax,
    psum,
    psum_scatter,
)

_INT8_OFFSETS = ("the int8 kernels B5, B7 and B8 take no global q/k offsets yet (queue B, "
                 "B-f2); use the int8 ring, zigzag or Ulysses")


def lse_weighted_merge(o: torch.Tensor, lse: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Merge normalized attention partials O [..., d] with their exp2-domain
    lse [...] across `axis`: m = pmax(lse); w = exp2(lse - m);
    O = psum(w O) / psum(w). A row with no live key anywhere (lse -inf on
    every rank) gives O = 0. Three all_reduces over the axis."""
    m = pmax(lse.clone(), mesh, axis)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.where(torch.isfinite(lse), torch.exp2(lse - m_safe), 0.0)
    num = psum((o * w[..., None]).contiguous(), mesh, axis)
    den = psum(w.contiguous(), mesh, axis)
    den = torch.where(den == 0.0, 1.0, den)
    return num / den[..., None]


class _AllGatherKV(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, sm_scale):
        q_off = axis_index(mesh, axis) * q.shape[2]
        # bf16 on the wire: the kernels round K and V to bf16 anyway
        k_full = all_gather(k.to(torch.bfloat16).contiguous(), mesh, axis, 2)
        v_full = all_gather(v.to(torch.bfloat16).contiguous(), mesh, axis, 2)
        o, lse = flash_attention_fwd(q, k_full, v_full, causal=causal, sm_scale=sm_scale,
                                     q_offset=q_off, k_offset=0)
        ctx.save_for_backward(q, k_full, v_full, o, lse)
        ctx.args = (mesh, axis, causal, sm_scale, q_off, k.dtype, v.dtype)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k_full, v_full, o, lse = ctx.saved_tensors
        mesh, axis, causal, sm_scale, q_off, k_dtype, v_dtype = ctx.args
        dq, dk_full, dv_full = flash_attention_bwd(q, k_full, v_full, o, lse, do, causal=causal,
                                                   sm_scale=sm_scale, fast=True, q_offset=q_off,
                                                   k_offset=0)
        # each rank holds its queries' share of dK/dV over the whole
        # sequence: the sum over ranks, each shard to its owner
        dk = psum_scatter(dk_full, mesh, axis, 2)
        dv = psum_scatter(dv_full, mesh, axis, 2)
        return dq.to(q.dtype), dk.to(k_dtype), dv.to(v_dtype), None, None, None, None


def allgather_kv_attention(q, k, v, mesh, axis: str = "context", causal: bool = False,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Sequence-parallel attention: the K/V shards all-gathered over `axis`,
    one B1 launch. q/k/v: this rank's shards [b, h(_kv), t_local, d], the
    sequence split identically over `axis`. Differentiable (B2 + B3, then
    psum_scatter of dK/dV); returns this rank's O shard in f32."""
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError("q heads must be a multiple of kv heads")
    return _AllGatherKV.apply(q, k, v, mesh, axis, causal, sm_scale)


def allgather_kv_attention_int8(q, k, v, mesh, axis: str = "context", causal: bool = False,
                                sm_scale: float | None = None):
    """The int8 all-gather attention: not ported (see the module docstring)."""
    raise NotImplementedError(f"allgather_kv_attention_int8: {_INT8_OFFSETS}")


def kv_sharded_attention(q, k, v, mesh, axis: str = "context", causal: bool = False,
                         sm_scale: float | None = None) -> torch.Tensor:
    """Attention of replicated q [b, h, t, d] to K/V [b, h_kv, t_local, d]
    sharded over `axis`: one B1 launch over this rank's slice (k_offset =
    idx * t_local), then `lse_weighted_merge`. Forward only; returns O f32
    [b, h, t, d], the same on every rank of the axis."""
    o, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=0,
                                 k_offset=axis_index(mesh, axis) * k.shape[2])
    return lse_weighted_merge(o, lse, mesh, axis)


def kv_sharded_attention_int8(q, k, v, mesh, axis: str = "context", causal: bool = False,
                              sm_scale: float | None = None):
    """The int8 KV-sharded attention: not ported (see the module docstring)."""
    raise NotImplementedError(f"kv_sharded_attention_int8: {_INT8_OFFSETS}")


def make_allgather_attention(mesh, causal: bool = False, sm_scale: float | None = None,
                             context_axis: str = "context", kind: str = "bf16"):
    """(q, k, v) -> O on this rank's (batch, head, sequence) block of `mesh`
    through `allgather_kv_attention` (`spec` as make_ring_attention's; swap
    one for the other freely). kind "int8" raises NotImplementedError."""
    if kind == "int8":
        raise NotImplementedError(f"make_allgather_attention(kind='int8'): {_INT8_OFFSETS}")
    if kind != "bf16":
        raise ValueError(f"unknown kind {kind!r}")

    def sharded(q, k, v):
        return allgather_kv_attention(q, k, v, mesh, context_axis, causal=causal,
                                      sm_scale=sm_scale)

    sharded.spec = ("data", "model", context_axis, None)
    return sharded
