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

The int8 twins (JAX collective.py:123-201, :228-247) quantize each shard
once (B4) with K smoothed by the GLOBAL token mean (`pmean` over the axis),
at the grain of the shard:
- `allgather_kv_attention_int8` all-gathers the int8 K/V payloads and their
  scale tables (a quarter of bf16's bytes; GQA: the unrepeated kv heads,
  which the GQA-native kernels read as they are) and runs one B5 with
  q_offset = idx * t_local; the backward is B7 + B8 at the same offsets,
  then `psum_scatter` of dK/dV. It keeps JAX's refusals
  (tune/config.py:int8_shard_grain): t_local a multiple of 128 and of the
  kv block and grain clamped to the shard, so that each shard's payload has
  no padding and the gathered payloads are the whole sequence's grid.
- `kv_sharded_attention_int8` runs B5 on the rank's key slice with k_offset
  = idx * t_local, then `lse_weighted_merge`. Forward only.
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu_torch.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu_torch.ops.int8_fwd import (
    _qkv_dims,
    int8_attention_fwd_from_quantized,
    quantize_qkv,
)
from quantizedattention_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    axis_size,
    pmax,
    psum,
    psum_scatter,
)
from quantizedattention_tpu_torch.parallel.ring import global_k_mean
from quantizedattention_tpu_torch.tune.config import int8_shard_grain


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


class _AllGatherKVInt8(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, sm_scale):
        b, h, t_local, d = q.shape
        k_mean = global_k_mean(k, mesh, axis)
        (q_i8, sq), (k_i8, sk), (v_i8, sv) = quantize_qkv(q, k, v, k_sub=k_mean)
        # the shards share one grain and carry no padding: the payloads and
        # scale tables concatenated in coordinate order ARE the sequence's
        k_i8, sk, v_i8, sv = (all_gather(x, mesh, axis, 1) for x in (k_i8, sk, v_i8, sv))
        dims = (b, h, t_local, axis_size(mesh, axis) * t_local, d)
        q_off = axis_index(mesh, axis) * t_local
        o, lse = int8_attention_fwd_from_quantized(((q_i8, sq), (k_i8, sk), (v_i8, sv)), dims,
                                                   causal=causal, sm_scale=sm_scale,
                                                   q_offset=q_off, k_offset=0)
        ctx.save_for_backward(q_i8, sq, k_i8, sk, v_i8, sv, k_mean, o, lse)
        ctx.args = (mesh, axis, causal, sm_scale, dims, q_off, q.dtype, k.dtype, v.dtype)
        return o

    @staticmethod
    def backward(ctx, do):
        q_i8, sq, k_i8, sk, v_i8, sv, k_mean, o, lse = ctx.saved_tensors
        mesh, axis, causal, sm_scale, dims, q_off, q_dtype, k_dtype, v_dtype = ctx.args
        dq, dk_full, dv_full = int8_attention_bwd(((q_i8, sq), (k_i8, sk), (v_i8, sv)), k_mean,
                                                  o, lse, do, dims, causal=causal,
                                                  sm_scale=sm_scale, q_offset=q_off, k_offset=0)
        dk = psum_scatter(dk_full, mesh, axis, 2)
        dv = psum_scatter(dv_full, mesh, axis, 2)
        return dq.to(q_dtype), dk.to(k_dtype), dv.to(v_dtype), None, None, None, None


def allgather_kv_attention_int8(q, k, v, mesh, axis: str = "context", causal: bool = False,
                                sm_scale: float | None = None) -> torch.Tensor:
    """Sequence-parallel int8 attention: each shard quantized once (K
    smoothed by the global mean), the int8 K/V payloads and scale tables
    all-gathered over `axis`, one B5 launch. q/k/v: this rank's shards [b,
    h(_kv), t_local, d], the sequence split identically over `axis`;
    t_local a multiple of 128 and of the shard's kv block and grain
    (`int8_shard_grain`), else ValueError before any collective.
    Differentiable (B7 + B8, then psum_scatter of dK/dV); returns this
    rank's O shard in f32."""
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError("q heads must be a multiple of kv heads")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"q and k/v shards must hold the same tokens: {q.shape[2]} != "
                         f"{k.shape[2]}")
    int8_shard_grain(q.shape[2], q.shape[1] // k.shape[1])
    return _AllGatherKVInt8.apply(q, k, v, mesh, axis, causal, sm_scale)


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
                              sm_scale: float | None = None) -> torch.Tensor:
    """Int8 attention of replicated q [b, h, t, d] to K/V [b, h_kv, t_local,
    d] sharded over `axis`: this rank's slice quantized with K smoothed by
    the global mean (q at the grain of (t, t_local)), one B5 launch with
    k_offset = idx * t_local, then `lse_weighted_merge`. Forward only;
    returns O f32 [b, h, t, d], the same on every rank of the axis."""
    k_mean = global_k_mean(k, mesh, axis)
    o, lse = int8_attention_fwd_from_quantized(
        quantize_qkv(q, k, v, k_sub=k_mean), _qkv_dims(q, k, v), causal=causal,
        sm_scale=sm_scale, q_offset=0, k_offset=axis_index(mesh, axis) * k.shape[2])
    return lse_weighted_merge(o, lse, mesh, axis)


def make_allgather_attention(mesh, causal: bool = False, sm_scale: float | None = None,
                             context_axis: str = "context", kind: str = "bf16"):
    """(q, k, v) -> O on this rank's (batch, head, sequence) block of `mesh`
    through `allgather_kv_attention` (kind "bf16") or
    `allgather_kv_attention_int8` ("int8"); `spec` as make_ring_attention's
    (swap one for the other freely)."""
    if kind not in ("bf16", "int8"):
        raise ValueError(f"unknown kind {kind!r}")
    fn = allgather_kv_attention_int8 if kind == "int8" else allgather_kv_attention

    def sharded(q, k, v):
        return fn(q, k, v, mesh, context_axis, causal=causal, sm_scale=sm_scale)

    sharded.spec = ("data", "model", context_axis, None)
    return sharded
