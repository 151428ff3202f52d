"""int8 KV cache and decode attention (serving path).

Counterpart of quantizedattention_tpu/parallel/kv_cache.py. The cache stores
int8 K/V payloads [b, h_kv, max_len, d] with per-token symmetric scales
[b, h_kv, max_len] and a per-row live length [b] (int32). The cache writes
are plain tensor code, as they are plain jnp in the JAX package; unlike it,
they update the cache tensors IN PLACE (a decode step would otherwise copy
the whole cache) and return the cache for the JAX package's call form
`cache = append_kv(cache, ...)`.

`decode_attention` launches the hand-written Hopper kernel (csrc/cache_decode.cu,
entry qa_decode: a kv split over 256-token chunks with an lse merge,
geometry in decode_tiling.py, launched through decode_launch.py) for CUDA
tensors and runs `decode_attention_plain` for CPU tensors;
`verify_decode_attention` runs the same entry's speculative-verify
staircase (`spec` queries per row), or `verify_decode_attention_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch.ops.common import qk_scales
from quantizedattention_tpu_torch.parallel import decode_launch
from quantizedattention_tpu_torch.quantize.int8 import INV_INT8_MAX


class QuantizedKVCache(NamedTuple):
    """int8 KV cache: payload [b, h_kv, max_len, d], scales [b, h_kv, max_len]."""

    k_i8: torch.Tensor
    sk: torch.Tensor
    v_i8: torch.Tensor
    sv: torch.Tensor
    length: torch.Tensor  # [b] int32, tokens filled per batch row

    @property
    def max_len(self) -> int:
        return self.k_i8.shape[2]


def init_kv_cache(batch: int, n_kv_heads: int, max_len: int, head_dim: int,
                  device) -> QuantizedKVCache:
    payload = (batch, n_kv_heads, max_len, head_dim)
    return QuantizedKVCache(
        k_i8=torch.zeros(payload, dtype=torch.int8, device=device),
        sk=torch.zeros(payload[:3], dtype=torch.float32, device=device),
        v_i8=torch.zeros(payload, dtype=torch.int8, device=device),
        sv=torch.zeros(payload[:3], dtype=torch.float32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _row_quant(x: torch.Tensor):
    """Per-token symmetric int8: returns (x_i8 [..., t, d], scales [..., t]).

    The scale is max(absmax, 1e-12) * f32(1/127): the JAX cache writers run
    only under jit, where XLA turns the division by 127 into that product
    (an IEEE division sits one ulp away for about 4% of rows). The payload
    divides by the scale, as jitted JAX does."""
    s = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-12) * INV_INT8_MAX
    x_i8 = torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8)
    return x_i8, s[..., 0].float()


def append_kv(cache: QuantizedKVCache, k_new, v_new, active=None) -> QuantizedKVCache:
    """Quantize and append [b, h_kv, t_new, d] keys/values at each row's length.

    active: optional [b] bool; rows where it is False do not advance `length`
    (their write lands at the stale length, past the row's logical end). As
    in the JAX package's dynamic_update_slice, a write that would overflow
    max_len is shifted left to end at max_len.
    """
    k_i8, sk = _row_quant(k_new.float())
    v_i8, sv = _row_quant(v_new.float())
    b, _, t_new, _ = k_new.shape
    dev = cache.k_i8.device
    start = cache.length.long().clamp(0, cache.max_len - t_new)
    idx = start[:, None] + torch.arange(t_new, device=dev)  # [b, t_new]
    rows = torch.arange(b, device=dev)[:, None]
    # advanced indices around a slice put [b, t_new] first: [b, t_new, h, (d)]
    cache.k_i8[rows, :, idx] = k_i8.transpose(1, 2)
    cache.sk[rows, :, idx] = sk.transpose(1, 2)
    cache.v_i8[rows, :, idx] = v_i8.transpose(1, 2)
    cache.sv[rows, :, idx] = sv.transpose(1, 2)
    adv = t_new if active is None else t_new * active.to(torch.int32)
    cache.length.add_(adv)
    return cache


def _one(x, dtype, device) -> torch.Tensor:
    """A Python int or a one-element tensor as a [1] tensor of `dtype` on
    `device`; the cache writers take slots and lengths in either form."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(device=device, dtype=dtype)
    return torch.full((1,), x, dtype=dtype, device=device)


def write_kv_slot(cache: QuantizedKVCache, slot, k_new, v_new, true_len) -> QuantizedKVCache:
    """Fused-prefill write: quantize [h_kv, t, d] K/V and install them at
    batch row `slot`, resetting the row's length to `true_len` (<= t; the
    tail beyond it is prompt padding, masked out by decode). The whole row
    is rewritten: the prompt, then zeros to max_len.

    slot/true_len: Python ints or one-element tensors on the cache's device
    (neither form makes a blocking host-to-device copy)."""
    k_i8, sk = _row_quant(k_new.float())
    v_i8, sv = _row_quant(v_new.float())
    dev = cache.k_i8.device
    idx = _one(slot, torch.long, dev)

    def fit(val):
        t = val.shape[1]
        if t < cache.max_len:
            widths = [0, 0] * (val.ndim - 2) + [0, cache.max_len - t]
            val = F.pad(val, widths)
        return val[None, :, : cache.max_len]

    cache.k_i8.index_copy_(0, idx, fit(k_i8))
    cache.sk.index_copy_(0, idx, fit(sk))
    cache.v_i8.index_copy_(0, idx, fit(v_i8))
    cache.sv.index_copy_(0, idx, fit(sv))
    cache.length.index_copy_(0, idx, _one(true_len, torch.int32, dev))
    return cache


def write_kv_chunk(cache: QuantizedKVCache, slot: int, k_new, v_new, start: int,
                   new_len) -> QuantizedKVCache:
    """Chunked-prefill write: quantize [h_kv, c, d] K/V and install them at
    row `slot`, positions start .. start + c - 1, setting the row's length
    to `new_len` (a Python int or a one-element tensor). The caller trims c
    to the capacity, as models.transformer.prefill_chunk does: a write past
    max_len raises."""
    c = k_new.shape[1]
    if start < 0 or start + c > cache.max_len:
        raise ValueError(f"chunk [{start}, {start + c}) is outside max_len {cache.max_len}")
    dev = cache.k_i8.device
    idx = _one(slot, torch.long, dev)
    for buf, sbuf, x in ((cache.k_i8, cache.sk, k_new), (cache.v_i8, cache.sv, v_new)):
        x_i8, s = _row_quant(x.float())
        buf.narrow(2, start, c).index_copy_(0, idx, x_i8[None])
        sbuf.narrow(2, start, c).index_copy_(0, idx, s[None])
    cache.length.index_copy_(0, idx, _one(new_len, torch.int32, dev))
    return cache


def read_prefix_kv(cache: QuantizedKVCache, slot: int, n_tokens: int):
    """The first `n_tokens` of row `slot` dequantized: (k, v) f32
    [h_kv, n_tokens, d], payload times scale in f32, the values every later
    decode step reads (the JAX chunked prefill computes it inline,
    models/transformer.py:602-609)."""
    idx = _one(slot, torch.long, cache.k_i8.device)

    def deq(payload, scales):
        x = payload.narrow(2, 0, n_tokens).index_select(0, idx)[0].float()
        return x * scales.narrow(2, 0, n_tokens).index_select(0, idx)[0, ..., None]

    return deq(cache.k_i8, cache.sk), deq(cache.v_i8, cache.sv)


def _check_decode_args(q, cache, spec: int = 1):
    if q.ndim != 3 or q.shape[0] != cache.k_i8.shape[0] or q.shape[2] != cache.k_i8.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(cache.k_i8.shape)}")
    n_kv = cache.k_i8.shape[1]
    if q.shape[1] % (n_kv * spec) != 0:
        raise ValueError(f"{q.shape[1] // spec} q heads not a multiple of {n_kv} kv heads")


def fold_verify(q: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Verify queries [b, H, s, d] -> ([b, H * s, d], s): a kv head's q rows
    run (g, j) as g * s + j, the JAX fold (kv_cache.py:313-314), which for
    GQA head order kv_head * group + g is a plain reshape."""
    if q.ndim != 4:
        raise ValueError(f"verify q must be [b, H, s, d], got {tuple(q.shape)}")
    b, h, s, d = q.shape
    return q.reshape(b, h * s, d), s


def unfold_verify(o: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[b, H * s, d] -> [b, H, s, d], the inverse of `fold_verify`."""
    return o.reshape(o.shape[0], n_heads, -1, o.shape[-1])


def staircase_mask(length: torch.Tensor, rows: int, spec: int, max_len: int) -> torch.Tensor:
    """[b, 1, rows or 1, max_len] bool: the tokens each folded q row sees.
    Row r = g * spec + j attends t < length - (spec - 1) + j (spec == 1: the
    length itself, one mask row for the whole group)."""
    cols = torch.arange(max_len, device=length.device)
    lim = length.long()[:, None]  # [b, 1]
    if spec > 1:
        lim = lim - (spec - 1) + (torch.arange(rows, device=length.device) % spec)[None]
    return (cols < lim[:, :, None])[:, None]


def decode_attention_plain(q, cache: QuantizedKVCache, sm_scale=None, return_lse=False,
                           spec: int = 1):
    """Decode attention's arithmetic in plain PyTorch, one softmax per row.

    Positions a row does not see (at or past its length; with spec > 1, past
    its step of the verify staircase) are masked out of BOTH products with
    `where`, never by multiplying with 0: stale scales there may be
    non-finite. q's rows fold (GQA group, spec) as `fold_verify` does."""
    _check_decode_args(q, cache, spec)
    b, n_q, d = q.shape
    n_kv, max_len = cache.k_i8.shape[1], cache.max_len
    _, qk_scale = qk_scales(d, sm_scale)
    qg = q.to(torch.bfloat16).float().reshape(b, n_kv, n_q // n_kv, d)
    s = (qg @ cache.k_i8.float().transpose(-1, -2)) * (cache.sk[:, :, None, :] * qk_scale)
    mask = staircase_mask(cache.length, n_q // n_kv, spec, max_len)  # [b, 1, rows, L]
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp2(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    pw = torch.where(mask, p * cache.sv[:, :, None, :], 0.0).to(torch.bfloat16).float()
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = ((pw @ cache.v_i8.float()) / l_safe).reshape(b, n_q, d)
    if not return_lse:
        return o
    lse = torch.where(l == 0.0, -torch.inf, m + torch.log2(l_safe))
    return o, lse.reshape(b, n_q)


def _launch(q, cache: QuantizedKVCache, sm_scale, return_lse, spec: int):
    """Launch entry qa_decode on q [b, n_kv * group * spec, d] (folded)."""
    _check_decode_args(q, cache, spec)
    if (cache.k_i8.dtype, cache.v_i8.dtype, cache.sk.dtype, cache.sv.dtype,
            cache.length.dtype) != (torch.int8, torch.int8, torch.float32, torch.float32,
                                    torch.int32):
        raise TypeError("cache must be int8 payloads, f32 scales and int32 lengths")
    return decode_launch.launch("qa_decode", q, cache, cache.k_i8.shape[1], cache.max_len,
                                (cache.max_len,), sm_scale, return_lse, spec)


def decode_attention(q, cache: QuantizedKVCache, sm_scale=None, return_lse=False):
    """Single-token decode: q [b, n_q_heads, d] against the int8 cache.

    GQA: n_q_heads a multiple of the cache's kv heads, q head kv_head * group
    + g. Returns O [b, n_q_heads, d] f32, and with return_lse=True also the
    exp2-domain lse [b, n_q_heads] (-inf for rows with no live tokens).
    CUDA tensors launch the kernel (head_dim 64 or 128) or raise; CPU tensors take
    `decode_attention_plain`. `decode_attention.launches` counts launches.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache, sm_scale, return_lse)
    out = _launch(q, cache, sm_scale, return_lse, 1)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def verify_decode_attention_plain(q, cache: QuantizedKVCache, sm_scale=None):
    """`verify_decode_attention`'s arithmetic in plain PyTorch."""
    qf, s = fold_verify(q)
    return unfold_verify(decode_attention_plain(qf, cache, sm_scale, spec=s), q.shape[1])


def verify_decode_attention(q, cache: QuantizedKVCache, sm_scale=None):
    """Multi-position decode for speculative verification: q [b, H, s, d]
    holds s consecutive query positions per row (the last accepted token and
    s - 1 drafts) whose K/V are ALREADY appended (the row's length counts
    all s). Query j sits at position length - s + j and attends the tokens
    at or before it: the causal staircase, one launch for s positions.

    Returns [b, H, s, d] f32; a query with no token to see (length < s - j)
    gives 0. CUDA tensors launch B13 (qa_decode) with spec = s or raise; CPU
    tensors take `verify_decode_attention_plain`. `.launches` counts
    launches."""
    if q.device.type == "cpu":
        return verify_decode_attention_plain(q, cache, sm_scale)
    qf, s = fold_verify(q)
    o = _launch(qf, cache, sm_scale, False, s)
    verify_decode_attention.launches += 1
    return unfold_verify(o, q.shape[1])


verify_decode_attention.launches = 0


def shard_cache_context(cache: QuantizedKVCache, mesh, axis: str = "context") -> QuantizedKVCache:
    """This rank's view of a context-sharded cache: its payloads hold global
    token positions [i * shard_len, (i + 1) * shard_len) of every row (i its
    index on `axis`), and its live length is the clipped remainder of the
    row's GLOBAL length `cache.length`."""
    from quantizedattention_tpu_torch.parallel.mesh import axis_index

    shard_len = cache.max_len
    start = axis_index(mesh, axis) * shard_len
    local = torch.clamp(cache.length.long() - start, 0, shard_len).to(torch.int32)
    return cache._replace(length=local)


def context_sharded_decode(q, cache: QuantizedKVCache, mesh, axis: str = "context",
                           sm_scale=None) -> torch.Tensor:
    """Flash-decoding over a sequence-sharded int8 cache (JAX
    kv_cache.py:424-449): each rank holds a contiguous slice of every row's
    tokens (`cache.length` is the global length, the same on every rank),
    decodes q [b, n_q_heads, d] against its slice with B13 (`return_lse`),
    and the normalized partials merge over `axis` through
    `collective.lse_weighted_merge`: three all_reduces over [b, n_q_heads]
    statistics and the [b, n_q_heads, d] weighted outputs; no K/V moves."""
    from quantizedattention_tpu_torch.parallel.collective import lse_weighted_merge

    o, lse = decode_attention(q, shard_cache_context(cache, mesh, axis), sm_scale,
                              return_lse=True)
    return lse_weighted_merge(o, lse, mesh, axis)
