"""Zigzag (striped) causal ring attention: context parallelism with the
causal work balanced over the ranks.

Counterpart of quantizedattention_tpu/parallel/zigzag.py. The contiguous
causal ring is bound by its last rank, which attends every shard while rank
0 attends one. Split the global sequence into 2n chunks and give rank i the
pair (i, 2n - 1 - i): then every rank does the same work.
- Step 0 (its own pair): the two aligned diagonals (causal) and the high
  chunk against the whole low chunk.
- Every other step (source src != idx): exactly two whole [c x c] pieces,
  q_hi against the source's low chunk, and q_lo against its low chunk
  where src < idx, else q_hi against its high chunk.
The JAX package picks the second piece's operands with jnp.where on the
traced predicate; here src < idx is known on the host and picks them
directly. No piece needs the kernels' global offsets.

Callers shard the PERMUTED sequence (`zigzag_perm`), and
`zigzag_local_positions` gives a rank's global RoPE positions;
models/sharded_train.py does both under attention_sp="zigzag". The bf16
twin runs B1 (backward B2 + B3 fast); the int8 one quantizes each chunk
once (B4, K smoothed with the global token mean, each chunk at its own
grain: int8_grain(c, c)) and runs B5 (backward B7 + B8). Both are
parallel/ring.py's `_Ring` with two chunks a rank and these pieces, so
the backward is a ring: the chunk pair's dK/dV accumulators ride beside it
(JAX zigzag.py:167-260, :365-452).
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.parallel.ring import _KINDS, _Ring


def zigzag_perm(n: int, t: int) -> torch.Tensor:
    """Global token order whose contiguous n-way split gives rank i the
    chunk pair (i, 2n - 1 - i): [chunk 0, chunk 2n-1, chunk 1, chunk 2n-2,
    ...]. Apply to tokens AND targets before sharding; argsort inverts it."""
    if t % (2 * n) != 0:
        raise ValueError(f"t={t} must be a multiple of 2n={2 * n}")
    c = t // (2 * n)
    chunks = []
    for i in range(n):
        chunks.append(torch.arange(i * c, (i + 1) * c))
        chunks.append(torch.arange((2 * n - 1 - i) * c, (2 * n - i) * c))
    return torch.cat(chunks)


def zigzag_local_positions(idx: int, n: int, t_local: int, device=None) -> torch.Tensor:
    """Global positions of rank idx's local tokens (RoPE input): the low
    chunk [idx c, (idx + 1) c), then the high chunk [(2n - 1 - idx) c, ...)."""
    c = t_local // 2
    return torch.cat([idx * c + torch.arange(c, device=device),
                      (2 * n - 1 - idx) * c + torch.arange(c, device=device)])


def _pieces(step: int, src: int, idx: int):
    """The step's pieces as (q chunk, kv chunk, causal, q_offset, k_offset)
    with chunks 0 = low, 1 = high (JAX zigzag.py:120-160); no piece needs
    offsets."""
    if step == 0:
        return [(0, 0, True, 0, 0), (1, 1, True, 0, 0), (1, 0, False, 0, 0)]
    if src < idx:
        return [(1, 0, False, 0, 0), (0, 0, False, 0, 0)]
    return [(1, 0, False, 0, 0), (1, 1, False, 0, 0)]


def _zigzag(q, k, v, mesh, axis, sm_scale, kind):
    if q.shape[2] != k.shape[2] or q.shape[2] % 2:
        raise ValueError(f"zigzag shards hold an even number of tokens, the same in q and k/v; "
                         f"got {q.shape[2]} and {k.shape[2]}")
    return _Ring.apply(q, k, v, mesh, axis, sm_scale, _KINDS[kind], _pieces, 2)


def zigzag_ring_attention(q, k, v, mesh, axis: str = "context",
                          sm_scale: float | None = None) -> torch.Tensor:
    """Causal ring attention over zigzag-sharded inputs: q [b, h, t_local,
    d], k/v [b, h_kv, t_local, d], whose local tokens are this rank's (lo,
    hi) chunk pair (`zigzag_perm`). B1 pieces; differentiable (B2 + B3).
    Returns this rank's O shard (f32)."""
    return _zigzag(q, k, v, mesh, axis, sm_scale, "bf16")


def zigzag_ring_attention_int8(q, k, v, mesh, axis: str = "context",
                               sm_scale: float | None = None) -> torch.Tensor:
    """The int8 twin of `zigzag_ring_attention`: each chunk quantized once
    (B4, K smoothed with the global token mean), the payloads and scales
    ride the ring (B5; backward B7 + B8)."""
    return _zigzag(q, k, v, mesh, axis, sm_scale, "int8")


def make_zigzag_attention(mesh, kind: str = "bf16", sm_scale: float | None = None,
                          context_axis: str = "context"):
    """Causal (q, k, v) -> O on this rank's (batch, head, sequence) block of
    the zigzag-PERMUTED sequence (`zigzag_perm`; `spec` as
    make_ring_attention's): the blocks of JAX's make_zigzag_attention after
    its permutation, which the caller applies here, as the train step does.
    Differentiable."""
    if kind not in ("bf16", "int8"):
        raise ValueError(f"unknown kind {kind!r}")
    fn = zigzag_ring_attention_int8 if kind == "int8" else zigzag_ring_attention

    def sharded(q, k, v):
        return fn(q, k, v, mesh, context_axis, sm_scale=sm_scale)

    sharded.spec = ("data", "model", context_axis, None)
    return sharded
