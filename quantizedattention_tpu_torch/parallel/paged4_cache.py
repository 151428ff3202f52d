"""Paged int4 KV cache and paged int4 decode attention (B16).

Counterpart of quantizedattention_tpu/parallel/paged4_cache.py: the paged
pool of paged_cache.py with the int4 payloads of kv4_cache.py.

  k_p / v_p   : [n_kv_heads, n_pages, page_size / 2, head_dim] int8
  sk / sv     : [n_pages, n_kv_heads, page_size] f32
  page_table  : [n_seqs, max_pages_per_seq] int32 (unused entries 0)
  lengths     : [n_seqs] int32

Packing is SPLIT-HALF PER PAGE: byte row r of a page holds the page's
token r in its low nibble and token r + page_size/2 in its high nibble, so
any <= page_size/2 consecutive tokens touch distinct byte rows and the
read-modify-write append goes in pieces of that size. As in the int8 pool,
a write the JAX append drops (an inactive row, a row at table capacity)
goes to the garbage page 0, never to a live page.

`paged4_decode_attention` launches the Hopper kernel (csrc/cache_decode.cu,
entry qa_paged4_decode: B15's kernel, a byte row addressed through the
table; geometry in decode_tiling.py, launched through decode_launch.py) for
CUDA tensors and runs
`paged4_decode_attention_plain` for CPU tensors; `paged4_verify_attention`
runs the same entry's speculative-verify staircase, or
`paged4_verify_attention_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quantizedattention_tpu_torch.parallel import decode_launch
from quantizedattention_tpu_torch.parallel.kv4_cache import (
    _combine,
    _pack_halves,
    _quant4_rows,
    unpack_tokens,
)
from quantizedattention_tpu_torch.parallel.kv_cache import (
    QuantizedKVCache,
    decode_attention_plain,
    fold_verify,
    unfold_verify,
)
from quantizedattention_tpu_torch.parallel.paged_cache import (
    DEFAULT_PAGE_SIZE,
    _prompt_pages,
    _set_length,
    _check_paged_args,
    _chunk_pages,
    _token_slots,
    assign_pages,
    check_page_size,
    gather_rows,
    gather_scales,
    prefix_pages,
)

assign_pages4 = assign_pages


class Paged4KVCache(NamedTuple):
    k_p: torch.Tensor         # [h_kv, n_pages, page_size/2, d] int8 (nibbles)
    sk: torch.Tensor          # [n_pages, h_kv, page_size] f32
    v_p: torch.Tensor         # [h_kv, n_pages, page_size/2, d] int8
    sv: torch.Tensor          # [n_pages, h_kv, page_size] f32
    page_table: torch.Tensor  # [n_seqs, max_pages] int32
    lengths: torch.Tensor     # [n_seqs] int32

    @property
    def page_size(self) -> int:
        return 2 * self.k_p.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k_p.shape[1]


def init_paged4_cache(n_kv_heads: int, n_pages: int, n_seqs: int, max_pages_per_seq: int,
                      head_dim: int, page_size: int = DEFAULT_PAGE_SIZE,
                      device="cuda") -> Paged4KVCache:
    check_page_size(page_size)
    payload = (n_kv_heads, n_pages, page_size // 2, head_dim)
    scales = (n_pages, n_kv_heads, page_size)
    return Paged4KVCache(
        k_p=torch.zeros(payload, dtype=torch.int8, device=device),
        sk=torch.zeros(scales, dtype=torch.float32, device=device),
        v_p=torch.zeros(payload, dtype=torch.int8, device=device),
        sv=torch.zeros(scales, dtype=torch.float32, device=device),
        page_table=torch.zeros((n_seqs, max_pages_per_seq), dtype=torch.int32, device=device),
        lengths=torch.zeros((n_seqs,), dtype=torch.int32, device=device),
    )


def _pack_pages(v4: torch.Tensor, ps: int) -> torch.Tensor:
    """[h, t, d] nibbles (t a multiple of ps) -> [h, t/ps, ps/2, d] bytes,
    split-half per page."""
    h, t, d = v4.shape
    return _pack_halves(v4, ps).reshape(h, t // ps, ps // 2, d)


def write_prompt_paged4(cache: Paged4KVCache, seq, k_new, v_new, true_len) -> Paged4KVCache:
    """Prefill: quantize [h, t_pad, d] K/V (t_pad a multiple of page_size),
    pack whole pages arithmetically, install them in the pages `seq` owns
    and set its length to `true_len`."""
    h, t_pad, _ = k_new.shape
    ps = cache.page_size
    pages = _prompt_pages(cache, seq, t_pad)
    for buf, sbuf, x in ((cache.k_p, cache.sk, k_new), (cache.v_p, cache.sv, v_new)):
        x4, s = _quant4_rows(x.float())
        buf.index_copy_(1, pages, _pack_pages(x4, ps))
        sbuf.index_copy_(0, pages, s.reshape(h, pages.shape[0], ps).transpose(0, 1))
    _set_length(cache, seq, true_len)
    return cache


def write_chunk_paged4(cache: Paged4KVCache, seq, k_new, v_new, page_start: int,
                       new_len) -> Paged4KVCache:
    """Chunked prefill: [h, c, d] K/V (c a multiple of page_size) packed as
    whole pages into the pages of `seq` at table columns page_start ..;
    length set to `new_len`. The contract of
    paged_cache.write_chunk_paged."""
    h, c, _ = k_new.shape
    ps = cache.page_size
    pages = _chunk_pages(cache, seq, page_start, c)
    for buf, sbuf, x in ((cache.k_p, cache.sk, k_new), (cache.v_p, cache.sv, v_new)):
        x4, s = _quant4_rows(x.float())
        buf.index_copy_(1, pages, _pack_pages(x4, ps))
        sbuf.index_copy_(0, pages, s.reshape(h, pages.shape[0], ps).transpose(0, 1))
    _set_length(cache, seq, new_len)
    return cache


def read_prefix_paged4(cache: Paged4KVCache, seq, n_tokens: int):
    """The first `n_tokens` (a page multiple) of `seq` gathered, unpacked to
    token order and dequantized: (k, v) f32 [h, n_tokens, d]."""
    pages = prefix_pages(cache, seq, n_tokens)
    h, d = cache.k_p.shape[0], cache.k_p.shape[3]

    def deq(payload, scales):
        x = unpack_tokens(payload.index_select(1, pages), cache.page_size).float()
        s = scales.index_select(0, pages).transpose(0, 1)  # [h, n, ps]
        return (x * s[..., None]).reshape(h, n_tokens, d)

    return deq(cache.k_p, cache.sk), deq(cache.v_p, cache.sv)


def append_tokens_paged4(cache: Paged4KVCache, k_new, v_new, active=None) -> Paged4KVCache:
    """Batched append: k_new/v_new [n_seqs, h, t, d] at positions
    lengths .. lengths + t - 1 per row, across page edges, in pieces of at
    most page_size/2 tokens (one byte row per token, none twice in a piece).
    The active / capacity contract of paged_cache.append_tokens_paged."""
    ps = cache.page_size
    half = ps // 2
    t = k_new.shape[2]
    k4, sk = _quant4_rows(k_new.float())
    v4, sv = _quant4_rows(v_new.float())
    pages, offset, ok = _token_slots(cache, t, active)  # [s, t]
    row, hi = offset % half, (offset // half).bool()
    for c0 in range(0, t, half):
        piece = slice(c0, min(c0 + half, t))
        p, r, o = pages[:, piece], row[:, piece], offset[:, piece]
        for buf, sbuf, x4, s in ((cache.k_p, cache.sk, k4, sk), (cache.v_p, cache.sv, v4, sv)):
            # advanced indices [s, c] adjacent at dims 1, 2 -> [h, s, c, d]
            cur = buf[:, p, r]
            buf[:, p, r] = _combine(cur, x4[:, :, piece].transpose(0, 1),
                                    hi[None, :, piece, None])
            sbuf[p, :, o] = s[:, :, piece].transpose(1, 2)
    cache.lengths.add_(ok.sum(1).to(torch.int32))
    return cache


def paged4_decode_attention_plain(q, cache: Paged4KVCache, sm_scale=None, return_lse=False,
                                  spec: int = 1):
    """B16's arithmetic in plain PyTorch: pages gathered through the table and
    unpacked to token order, then `decode_attention_plain` (with `spec`)."""
    table = cache.page_table
    dense = QuantizedKVCache(
        unpack_tokens(gather_rows(cache.k_p, table), cache.page_size),
        gather_scales(cache.sk, table),
        unpack_tokens(gather_rows(cache.v_p, table), cache.page_size),
        gather_scales(cache.sv, table), cache.lengths)
    return decode_attention_plain(q, dense, sm_scale, return_lse, spec)


def _launch(q, cache: Paged4KVCache, sm_scale, return_lse, spec: int = 1):
    """Launch entry qa_paged4_decode on q [n, n_kv * group * spec, d] (folded)."""
    _check_paged_args(q, cache, cache.k_p.shape[0], spec)
    if cache.k_p.shape[3] != q.shape[2]:
        raise ValueError(f"q head_dim {q.shape[2]} does not fit the pool's {cache.k_p.shape[3]}")
    if tuple(x.dtype for x in cache) != (torch.int8, torch.float32, torch.int8, torch.float32,
                                         torch.int32, torch.int32):
        raise TypeError("paged cache must be int8 payloads, f32 scales, int32 table and lengths")
    max_pages = cache.page_table.shape[1]
    return decode_launch.launch("qa_paged4_decode", q, cache, cache.k_p.shape[0],
                                max_pages * cache.page_size,
                                (cache.n_pages, cache.page_size, max_pages), sm_scale,
                                return_lse, spec)


def paged4_decode_attention(q, cache: Paged4KVCache, sm_scale=None, return_lse=False):
    """Single-token decode against the paged int4 cache: q [n_seqs, H, d],
    as paged_cache.paged_decode_attention. CUDA tensors launch B16
    (head_dim 64 or 128) or raise; CPU tensors take the plain version.
    `.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return paged4_decode_attention_plain(q, cache, sm_scale, return_lse)
    out = _launch(q, cache, sm_scale, return_lse)
    paged4_decode_attention.launches += 1
    return out


paged4_decode_attention.launches = 0


def paged4_verify_attention_plain(q, cache: Paged4KVCache, sm_scale=None):
    """`paged4_verify_attention`'s arithmetic in plain PyTorch."""
    qf, s = fold_verify(q)
    return unfold_verify(paged4_decode_attention_plain(qf, cache, sm_scale, spec=s), q.shape[1])


def paged4_verify_attention(q, cache: Paged4KVCache, sm_scale=None):
    """Speculative staircase verify over the paged int4 cache: q [n, H, s, d]
    (kv_cache.verify_decode_attention's contract). CUDA tensors launch B16
    with spec = s or raise; CPU tensors take the plain version. `.launches`
    counts launches."""
    if q.device.type == "cpu":
        return paged4_verify_attention_plain(q, cache, sm_scale)
    qf, s = fold_verify(q)
    o = _launch(qf, cache, sm_scale, False, s)
    paged4_verify_attention.launches += 1
    return unfold_verify(o, q.shape[1])


paged4_verify_attention.launches = 0
