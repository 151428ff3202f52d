"""int4 KV cache and decode attention over it (B15).

Counterpart of quantizedattention_tpu/parallel/kv4_cache.py: payloads
[b, h_kv, max_len / 2, d] int8 holding two tokens per byte, per-token f32
scales [b, h_kv, max_len] and lengths [b] int32. The scale is
max(absmax, 1e-12) * f32(1/7), the product jitted JAX computes for its
division by 7, and the values are clip(round(x / s), -8, 7) stored as
two's-complement nibbles.

Packing is the JAX package's storage layout, SPLIT-HALF PER 256-TOKEN PACK
BLOCK: byte row r of pack block B (buffer row 128 B + r) holds token
256 B + r in its low nibble and token 256 B + 128 + r in its high nibble,
so max_len must be a multiple of 256. Any <= 128 consecutive tokens touch
distinct byte rows, so the read-modify-write appends go in pieces of at
most 128 tokens and never write one byte row twice in a piece.

The writes update the cache IN PLACE and return it, as kv_cache.py's do.
Where the JAX append drops a write past max_len, the port rewrites what the
byte row already holds (or, for the one row the last in-range token
shares, that token's own bytes), so the cache ends as JAX's does.

`decode_attention_int4` launches the Hopper kernel (csrc/cache_decode.cu,
entry qa_decode4: the decode kernel's int4 instance, geometry in
decode_tiling.py, launched through decode_launch.py) for CUDA tensors and
runs `decode_attention_int4_plain` for CPU tensors;
`verify_decode_attention_int4` runs the same entry's speculative-verify
staircase, or `verify_decode_attention_int4_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quantizedattention_tpu_torch.ops.int4_linear import unpack_int4
from quantizedattention_tpu_torch.parallel import decode_launch
from quantizedattention_tpu_torch.parallel.kv_cache import (
    QuantizedKVCache,
    _one,
    decode_attention_plain,
    fold_verify,
    unfold_verify,
)

PACK = 256  # tokens per pack block (128 byte rows)
_HALF = PACK // 2
# f32(1/7): the scale is absmax times it, as jitted JAX computes absmax / 7
INV_INT4_MAX = 1.0 / 7.0


class Int4KVCache(NamedTuple):
    """int4 KV cache: packed payloads [b, h_kv, max_len/2, d], scales
    [b, h_kv, max_len] f32, lengths [b] int32."""

    k_p: torch.Tensor
    sk: torch.Tensor
    v_p: torch.Tensor
    sv: torch.Tensor
    length: torch.Tensor

    @property
    def max_len(self) -> int:
        return 2 * self.k_p.shape[2]


def init_kv4_cache(batch: int, n_kv_heads: int, max_len: int, head_dim: int,
                   device="cuda") -> Int4KVCache:
    if max_len % PACK != 0:
        raise ValueError(f"max_len={max_len} must be a multiple of {PACK} (int4 pack blocks)")
    payload = (batch, n_kv_heads, max_len // 2, head_dim)
    return Int4KVCache(
        k_p=torch.zeros(payload, dtype=torch.int8, device=device),
        sk=torch.zeros(payload[:2] + (max_len,), dtype=torch.float32, device=device),
        v_p=torch.zeros(payload, dtype=torch.int8, device=device),
        sv=torch.zeros(payload[:2] + (max_len,), dtype=torch.float32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _quant4_rows(x: torch.Tensor):
    """Per-token symmetric int4: (low nibbles [..., t, d] int8 in [0, 15],
    scales [..., t] f32)."""
    s = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-12) * INV_INT4_MAX
    v = torch.clamp(torch.round(x / s), -8.0, 7.0).to(torch.int8)
    return v & 0x0F, s[..., 0].float()


def _rows_nibbles(positions: torch.Tensor):
    """Token positions -> (byte rows, nibble index: 0 = low, 1 = high)."""
    blk, r = positions // PACK, positions % PACK
    return blk * _HALF + r % _HALF, r // _HALF


def _combine(cur: torch.Tensor, vals4: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Byte rows `cur` (int8) with the nibble selected by `hi` replaced by
    the low nibbles `vals4`; bitwise, in uint8."""
    c, v = cur.view(torch.uint8), vals4.view(torch.uint8)
    out = torch.where(hi, (c & 0x0F) | (v << 4), (c & 0xF0) | v)
    return out.view(torch.int8)


def _pack_halves(v4: torch.Tensor, block: int) -> torch.Tensor:
    """[..., t, d] nibbles (t a multiple of `block`) -> [..., t/2, d] bytes:
    in each block of `block` tokens, byte row r = token r | token r + block/2."""
    *lead, t, d = v4.shape
    g = v4.view(torch.uint8).reshape(*lead, t // block, block, d)
    packed = g[..., : block // 2, :] | (g[..., block // 2:, :] << 4)
    return packed.reshape(*lead, t // 2, d).view(torch.int8)


def _write_tokens(pairs, start):
    """Write one piece of <= 128 tokens per row into each (buf, sbuf, vals4,
    s) of `pairs` (K, then V): nibbles vals4 [b, h, c, d] and scales
    s [b, h, c] at positions start[b] + 0 .. c-1 of buf [b, h, L/2, d] and
    sbuf [b, h, L], reading each byte row first.

    A token past max_len is written to the last position's byte row with the
    bytes that row gets anyway: the last token's own new bytes when it is in
    the piece (the same value twice), else the row's current bytes."""
    buf, sbuf, vals4, _ = pairs[0]
    b, _, c, _ = vals4.shape
    dev = buf.device
    positions = start[:, None] + torch.arange(c, device=dev)[None]  # [b, c]
    clamped = positions.clamp(max=sbuf.shape[2] - 1)
    src = clamped - start[:, None]  # the piece's token that lands there, < 0 if none
    write = src >= 0
    src = src.clamp(min=0)
    rows, nib = _rows_nibbles(clamped)
    hi = nib.bool()[:, :, None, None]
    bi = torch.arange(b, device=dev)[:, None]
    for buf, sbuf, vals4, s in pairs:
        # advanced indices at dims 0 and 2 go first: [b, c, h(, d)]
        vals = torch.gather(vals4, 2, src[:, None, :, None].expand_as(vals4)).transpose(1, 2)
        cur = buf[bi, :, rows]
        buf[bi, :, rows] = torch.where(write[:, :, None, None], _combine(cur, vals, hi), cur)
        s_new = torch.gather(s, 2, src[:, None, :].expand_as(s)).transpose(1, 2)
        sbuf[bi, :, clamped] = torch.where(write[:, :, None], s_new, sbuf[bi, :, clamped])


def append_kv4(cache: Int4KVCache, k_new, v_new, active=None) -> Int4KVCache:
    """Quantize and append [b, h_kv, t_new, d] K/V at each row's length: the
    int4 twin of kv_cache.append_kv (same active contract: inactive rows
    write at their stale length and do not advance). In pieces of <= 128
    tokens, so no byte row is written twice in a piece."""
    t_new = k_new.shape[2]
    k4, sk = _quant4_rows(k_new.float())
    v4, sv = _quant4_rows(v_new.float())
    length = cache.length.long()
    for c0 in range(0, t_new, _HALF):
        c1 = min(c0 + _HALF, t_new)
        _write_tokens([(cache.k_p, cache.sk, k4[:, :, c0:c1], sk[:, :, c0:c1]),
                       (cache.v_p, cache.sv, v4[:, :, c0:c1], sv[:, :, c0:c1])], length + c0)
    adv = t_new if active is None else t_new * active.to(torch.int32)
    cache.length.add_(adv)
    return cache


def _padded_quant4(x: torch.Tensor):
    """Quantize [..., t, d] after zero-padding t to a PACK multiple."""
    pad = (-x.shape[-2]) % PACK
    return _quant4_rows(torch.nn.functional.pad(x.float(), (0, 0, 0, pad)))


def install_kv4_batched(cache: Int4KVCache, k_new, v_new) -> Int4KVCache:
    """Whole-prompt install into ALL-FRESH rows (every row at length 0, as
    prefill_batched requires): one arithmetic lo | hi << 4 pack per pack
    block. k_new/v_new [b, h_kv, t, d]; every row's length becomes t."""
    t = k_new.shape[2]
    for buf, sbuf, x in ((cache.k_p, cache.sk, k_new), (cache.v_p, cache.sv, v_new)):
        x4, s = _padded_quant4(x)
        tp = s.shape[-1]
        buf[:, :, : tp // 2] = _pack_halves(x4, PACK)
        sbuf[:, :, :tp] = s
    cache.length.fill_(t)
    return cache


def write_kv4_slot(cache: Int4KVCache, slot, k_new, v_new, true_len) -> Int4KVCache:
    """Fused-prefill install of [h_kv, t, d] K/V at batch row `slot` from
    position 0 (the int4 twin of kv_cache.write_kv_slot). t is padded to a
    PACK multiple and packed arithmetically; the payload past it is left as
    it is, the scales are rewritten to max_len (zeros past t), as JAX does.
    slot/true_len: Python ints or one-element tensors."""
    dev = cache.k_p.device
    idx = _one(slot, torch.long, dev)
    for buf, sbuf, x in ((cache.k_p, cache.sk, k_new), (cache.v_p, cache.sv, v_new)):
        x4, s = _padded_quant4(x)
        rows = min(s.shape[-1] // 2, buf.shape[2])
        buf[:, :, :rows].index_copy_(0, idx, _pack_halves(x4, PACK)[None, :, :rows])
        s = torch.nn.functional.pad(s, (0, max(0, cache.max_len - s.shape[-1])))
        sbuf.index_copy_(0, idx, s[None, :, : cache.max_len])
    cache.length.index_copy_(0, idx, _one(true_len, torch.int32, dev))
    return cache


def write_kv4_chunk(cache: Int4KVCache, slot: int, k_new, v_new, start: int,
                    new_len) -> Int4KVCache:
    """Chunked-prefill write (the int4 twin of kv_cache.write_kv_chunk):
    quantize [h_kv, c, d] K/V and install them at row `slot` (a Python int),
    positions start .. start + c - 1, setting its length to `new_len`. A
    chunk may start in a pack block's second half, so the write reads each
    byte row first and replaces one nibble, in pieces of <= 128 tokens (no
    byte row twice in a piece), as append_kv4 does. The caller trims c to
    the capacity: a write past max_len raises."""
    c = k_new.shape[1]
    if start < 0 or start + c > cache.max_len:
        raise ValueError(f"chunk [{start}, {start + c}) is outside max_len {cache.max_len}")
    k4, sk = _quant4_rows(k_new.float()[None])
    v4, sv = _quant4_rows(v_new.float()[None])
    row = slice(slot, slot + 1)
    first = torch.full((1,), start, dtype=torch.long, device=cache.k_p.device)
    for c0 in range(0, c, _HALF):
        piece = slice(c0, min(c0 + _HALF, c))
        _write_tokens([(cache.k_p[row], cache.sk[row], k4[:, :, piece], sk[:, :, piece]),
                       (cache.v_p[row], cache.sv[row], v4[:, :, piece], sv[:, :, piece])],
                      first + c0)
    dev = cache.length.device
    cache.length.index_copy_(0, _one(slot, torch.long, dev), _one(new_len, torch.int32, dev))
    return cache


def read_prefix_kv4(cache: Int4KVCache, slot: int, n_tokens: int):
    """The first `n_tokens` of row `slot` (a Python int) unpacked to token
    order and dequantized: (k, v) f32 [h_kv, n_tokens, d]. Reads whole pack
    blocks and trims."""
    rows = -(-n_tokens // PACK) * _HALF

    def deq(payload, scales):
        x = unpack_tokens(payload[slot, :, :rows], PACK)[:, :n_tokens].float()
        return x * scales[slot, :, :n_tokens, None]

    return deq(cache.k_p, cache.sk), deq(cache.v_p, cache.sv)


def unpack_tokens(p: torch.Tensor, block: int) -> torch.Tensor:
    """[..., rows, d] packed bytes -> [..., 2 rows, d] int32 values in token
    order, for split-half blocks of `block` tokens."""
    *lead, rows, d = p.shape
    lo, hi = unpack_int4(p)  # the shared nibble decode (ops/int4_linear.py)
    lo = lo.reshape(*lead, rows // (block // 2), block // 2, d)
    hi = hi.reshape(*lead, rows // (block // 2), block // 2, d)
    return torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * rows, d)


def dequantize_kv4(cache: Int4KVCache):
    """Unpack to f32 K/V [b, h, max_len, d]: the tests' view."""
    k = unpack_tokens(cache.k_p, PACK).float() * cache.sk[..., None]
    v = unpack_tokens(cache.v_p, PACK).float() * cache.sv[..., None]
    return k, v


def decode_attention_int4_plain(q, cache: Int4KVCache, sm_scale=None, return_lse=False,
                                spec: int = 1):
    """B15's arithmetic in plain PyTorch: the nibbles unpacked to token
    order, then `decode_attention_plain` (q and the int4 values as bf16,
    tokens a row does not see masked with `where`; `spec` as there)."""
    dense = QuantizedKVCache(unpack_tokens(cache.k_p, PACK), cache.sk,
                             unpack_tokens(cache.v_p, PACK), cache.sv, cache.length)
    return decode_attention_plain(q, dense, sm_scale, return_lse, spec)


def _launch(q, cache: Int4KVCache, sm_scale, return_lse, spec: int):
    """Launch entry qa_decode4 on q [b, n_kv * group * spec, d] (folded)."""
    if q.ndim != 3 or q.shape[0] != cache.k_p.shape[0] or q.shape[2] != cache.k_p.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(cache.k_p.shape)}")
    if (cache.k_p.dtype, cache.v_p.dtype, cache.sk.dtype, cache.sv.dtype,
            cache.length.dtype) != (torch.int8, torch.int8, torch.float32, torch.float32,
                                    torch.int32):
        raise TypeError("cache must be int8 payloads, f32 scales and int32 lengths")
    return decode_launch.launch("qa_decode4", q, cache, cache.k_p.shape[1], cache.max_len,
                                (cache.max_len,), sm_scale, return_lse, spec)


def decode_attention_int4(q, cache: Int4KVCache, sm_scale=None, return_lse=False):
    """Single-token decode against the int4 cache: q [b, H, d], GQA as in
    kv_cache.decode_attention. Returns O [b, H, d] f32 (and the exp2 lse
    [b, H] with return_lse=True). CUDA tensors launch B15 (head_dim 64 or 128) or
    raise; CPU tensors take `decode_attention_int4_plain`. `.launches`
    counts kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_int4_plain(q, cache, sm_scale, return_lse)
    out = _launch(q, cache, sm_scale, return_lse, 1)
    decode_attention_int4.launches += 1
    return out


decode_attention_int4.launches = 0


def verify_decode_attention_int4_plain(q, cache: Int4KVCache, sm_scale=None):
    """`verify_decode_attention_int4`'s arithmetic in plain PyTorch."""
    qf, s = fold_verify(q)
    return unfold_verify(decode_attention_int4_plain(qf, cache, sm_scale, spec=s), q.shape[1])


def verify_decode_attention_int4(q, cache: Int4KVCache, sm_scale=None):
    """Speculative staircase verify over the int4 cache: q [b, H, s, d]
    (kv_cache.verify_decode_attention's contract). CUDA tensors launch B15
    with spec = s or raise; CPU tensors take the plain version. `.launches`
    counts launches."""
    if q.device.type == "cpu":
        return verify_decode_attention_int4_plain(q, cache, sm_scale)
    qf, s = fold_verify(q)
    o = _launch(qf, cache, sm_scale, False, s)
    verify_decode_attention_int4.launches += 1
    return unfold_verify(o, q.shape[1])


verify_decode_attention_int4.launches = 0
