"""Paged int8 KV cache and paged decode attention (B14).

Counterpart of quantizedattention_tpu/parallel/paged_cache.py. K/V live in
one pool of fixed-size pages; each sequence owns pages through a row of the
page table, so the cache holds ceil(length / page_size) pages per live
sequence. Page ids come from the host's allocator
(serve/scheduler.py:make_pager); page 0 is reserved as the garbage page
that unused table entries point at. Layouts are the JAX package's:

  k_pages / v_pages : [n_kv_heads, n_pages, page_size, head_dim] int8
  sk / sv           : [n_pages, n_kv_heads, page_size] f32
  page_table        : [n_seqs, max_pages_per_seq] int32 (unused entries 0)
  lengths           : [n_seqs] int32

The writes are plain tensor code that updates the pool IN PLACE (as
kv_cache.py's do) and returns the cache. Where the JAX append drops a
write (an inactive row, or a row at table capacity) the port sends it to
page 0 instead: a scatter that drops would need the host to read the mask
back. No live page is ever written for such a row.

`page_size` may be any positive even number: the kernel walks 256-token
chunks that span pages (each token's row looked up through the table), and
the int4 pool (paged4_cache.py) splits a page into two halves. The JAX
package's 128-multiple rule is a TPU tiling rule and is not carried over.

`paged_decode_attention` launches the Hopper kernel (csrc/cache_decode.cu,
entry qa_paged_decode: B13's kernel, a token's row addressed through the
table; launched through decode_launch.py) for CUDA tensors and runs
`paged_decode_attention_plain` for CPU tensors; `paged_verify_attention`
runs the same entry's speculative-verify staircase, or
`paged_verify_attention_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quantizedattention_tpu_torch.parallel import decode_launch
from quantizedattention_tpu_torch.parallel.kv_cache import (
    QuantizedKVCache,
    _one,
    _row_quant,
    decode_attention_plain,
    fold_verify,
    unfold_verify,
)

DEFAULT_PAGE_SIZE = 128


class PagedKVCache(NamedTuple):
    k_pages: torch.Tensor     # [h_kv, n_pages, page_size, d] int8
    sk: torch.Tensor          # [n_pages, h_kv, page_size] f32
    v_pages: torch.Tensor     # [h_kv, n_pages, page_size, d] int8
    sv: torch.Tensor          # [n_pages, h_kv, page_size] f32
    page_table: torch.Tensor  # [n_seqs, max_pages] int32
    lengths: torch.Tensor     # [n_seqs] int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1]


def check_page_size(page_size: int) -> None:
    if page_size <= 0 or page_size % 2 != 0:
        raise ValueError(f"page_size={page_size} must be a positive even number")


def init_paged_cache(n_kv_heads: int, n_pages: int, n_seqs: int, max_pages_per_seq: int,
                     head_dim: int, page_size: int = DEFAULT_PAGE_SIZE,
                     device="cuda") -> PagedKVCache:
    check_page_size(page_size)
    payload = (n_kv_heads, n_pages, page_size, head_dim)
    scales = (n_pages, n_kv_heads, page_size)
    return PagedKVCache(
        k_pages=torch.zeros(payload, dtype=torch.int8, device=device),
        sk=torch.zeros(scales, dtype=torch.float32, device=device),
        v_pages=torch.zeros(payload, dtype=torch.int8, device=device),
        sv=torch.zeros(scales, dtype=torch.float32, device=device),
        page_table=torch.zeros((n_seqs, max_pages_per_seq), dtype=torch.int32, device=device),
        lengths=torch.zeros((n_seqs,), dtype=torch.int32, device=device),
    )


def assign_pages(cache, seq, pages: torch.Tensor):
    """Install a host-allocated page row [max_pages] (unused tail 0) for
    `seq` and reset its length; for the int8 and int4 pools alike."""
    idx = _one(seq, torch.long, cache.page_table.device)
    cache.page_table.index_copy_(0, idx, pages.to(torch.int32).reshape(1, -1))
    cache.lengths.index_fill_(0, idx, 0)
    return cache


def _prompt_pages(cache, seq, t_pad: int) -> torch.Tensor:
    """The pages of `seq` that a page-aligned prompt of t_pad tokens fills."""
    ps, max_pages = cache.page_size, cache.page_table.shape[1]
    if t_pad % ps != 0 or t_pad // ps > max_pages:
        raise ValueError(f"prompt of {t_pad} tokens is not a page multiple within "
                         f"{max_pages} pages of {ps}")
    row = cache.page_table.index_select(0, _one(seq, torch.long, cache.page_table.device))
    return row[0, : t_pad // ps].long()


def _set_length(cache, seq, value) -> None:
    dev = cache.lengths.device
    cache.lengths.index_copy_(0, _one(seq, torch.long, dev), _one(value, torch.int32, dev))


def write_prompt_paged(cache: PagedKVCache, seq, k_new, v_new, true_len) -> PagedKVCache:
    """Prefill: quantize [h, t_pad, d] K/V (t_pad a multiple of page_size)
    into the pages `seq` owns and set its length to `true_len`. Table
    entries past the sequence's pages are 0, so padding beyond its
    allocation lands on the garbage page. seq/true_len: Python ints or
    one-element tensors."""
    h, t_pad, d = k_new.shape
    ps = cache.page_size
    pages = _prompt_pages(cache, seq, t_pad)
    n = pages.shape[0]
    for buf, sbuf, x in ((cache.k_pages, cache.sk, k_new), (cache.v_pages, cache.sv, v_new)):
        x_i8, s = _row_quant(x.float())
        buf.index_copy_(1, pages, x_i8.reshape(h, n, ps, d))
        sbuf.index_copy_(0, pages, s.reshape(h, n, ps).transpose(0, 1))
    _set_length(cache, seq, true_len)
    return cache


def _chunk_pages(cache, seq, page_start: int, c: int) -> torch.Tensor:
    """The pages of `seq` at table columns page_start .. that a chunk of c
    tokens (a page multiple, within the table) fills."""
    ps, max_pages = cache.page_size, cache.page_table.shape[1]
    if c % ps != 0 or page_start < 0 or page_start + c // ps > max_pages:
        raise ValueError(f"chunk of {c} tokens at page {page_start} is not a page multiple "
                         f"within {max_pages} pages of {ps}")
    row = cache.page_table.index_select(0, _one(seq, torch.long, cache.page_table.device))
    return row[0, page_start: page_start + c // ps].long()


def write_chunk_paged(cache: PagedKVCache, seq, k_new, v_new, page_start: int,
                      new_len) -> PagedKVCache:
    """Chunked prefill: quantize [h, c, d] K/V (c a multiple of page_size)
    into the pages of `seq` at table columns page_start .. (the engine's
    chunk grid is page-aligned) and set its length to `new_len`. The caller
    trims c to the table, as models.transformer.prefill_chunk does; table
    entries past the sequence's pages are 0, so a padded chunk's overhang
    lands on the garbage page."""
    h, c, d = k_new.shape
    ps = cache.page_size
    pages = _chunk_pages(cache, seq, page_start, c)
    n = pages.shape[0]
    for buf, sbuf, x in ((cache.k_pages, cache.sk, k_new), (cache.v_pages, cache.sv, v_new)):
        x_i8, s = _row_quant(x.float())
        buf.index_copy_(1, pages, x_i8.reshape(h, n, ps, d))
        sbuf.index_copy_(0, pages, s.reshape(h, n, ps).transpose(0, 1))
    _set_length(cache, seq, new_len)
    return cache


def prefix_pages(cache, seq, n_tokens: int) -> torch.Tensor:
    """The first n_tokens / page_size pages of `seq` (n_tokens a page
    multiple within the table)."""
    return _chunk_pages(cache, seq, 0, n_tokens)


def read_prefix_paged(cache: PagedKVCache, seq, n_tokens: int):
    """The first `n_tokens` (a page multiple) of `seq` gathered from its
    pages and dequantized: (k, v) f32 [h, n_tokens, d], the chunked-prefill
    prefix, read back as every later decode step sees it."""
    pages = prefix_pages(cache, seq, n_tokens)
    h, d = cache.k_pages.shape[0], cache.k_pages.shape[3]

    def deq(payload, scales):
        x = payload.index_select(1, pages).float()                # [h, n, ps, d]
        s = scales.index_select(0, pages).transpose(0, 1)         # [h, n, ps]
        return (x * s[..., None]).reshape(h, n_tokens, d)

    return deq(cache.k_pages, cache.sk), deq(cache.v_pages, cache.sv)


def _token_slots(cache, t: int, active):
    """Per (row, new token): the page and in-page offset it is written to,
    and whether the write is real. Inactive rows and tokens past the table's
    capacity go to page 0 and do not count."""
    ps, max_pages = cache.page_size, cache.page_table.shape[1]
    dev = cache.lengths.device
    positions = cache.lengths.long()[:, None] + torch.arange(t, device=dev)[None]  # [s, t]
    page_idx = positions // ps
    ok = page_idx < max_pages
    if active is not None:
        ok = ok & active.to(torch.bool)[:, None]
    pages = torch.gather(cache.page_table.long(), 1, page_idx.clamp(max=max_pages - 1))
    return torch.where(ok, pages, 0), positions % ps, ok


def append_tokens_paged(cache: PagedKVCache, k_new, v_new, active=None) -> PagedKVCache:
    """Batched append: k_new/v_new [n_seqs, h, t, d] at positions
    lengths .. lengths + t - 1 of each row, across page edges. Only written
    tokens advance `lengths`; rows with active=False neither write a live
    page nor advance."""
    pages, offset, ok = _token_slots(cache, k_new.shape[2], active)
    for buf, sbuf, x in ((cache.k_pages, cache.sk, k_new), (cache.v_pages, cache.sv, v_new)):
        x_i8, s = _row_quant(x.float())  # [s, h, t, d], [s, h, t]
        # advanced indices [s, t]: adjacent ones stay in place -> [h, s, t, d];
        # split ones go first -> [s, t, h]
        buf[:, pages, offset] = x_i8.transpose(0, 1)
        sbuf[pages, :, offset] = s.transpose(1, 2)
    cache.lengths.add_(ok.sum(1).to(torch.int32))
    return cache


append_token_paged = append_tokens_paged


def gather_rows(payload: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pool rows [h, n_pages, rows, d] through the page table [n, max_pages]
    -> [n, h, max_pages * rows, d] in table order."""
    g = payload[:, table.long()]  # [h, n, max_pages, rows, d]
    h, n, mp, rows, d = g.shape
    return g.transpose(0, 1).reshape(n, h, mp * rows, d)


def gather_scales(scales: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pool scales [n_pages, h, ps] through the table -> [n, h, max_pages * ps]."""
    g = scales[table.long()]  # [n, max_pages, h, ps]
    n, mp, h, ps = g.shape
    return g.transpose(1, 2).reshape(n, h, mp * ps)


def _check_paged_args(q, cache, pool_heads: int, spec: int = 1):
    if q.ndim != 3 or q.shape[0] != cache.page_table.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} does not fit {cache.page_table.shape[0]} sequences")
    if q.shape[1] % (pool_heads * spec) != 0:
        raise ValueError(f"{q.shape[1] // spec} q heads not a multiple of {pool_heads} kv heads")


def paged_decode_attention_plain(q, cache: PagedKVCache, sm_scale=None, return_lse=False,
                                 spec: int = 1):
    """B14's arithmetic in plain PyTorch: the pages gathered into one dense
    row per sequence, then `decode_attention_plain` (tokens a row does not
    see masked with `where`; q rows folded with `spec` as there)."""
    _check_paged_args(q, cache, cache.k_pages.shape[0], spec)
    dense = QuantizedKVCache(
        gather_rows(cache.k_pages, cache.page_table), gather_scales(cache.sk, cache.page_table),
        gather_rows(cache.v_pages, cache.page_table), gather_scales(cache.sv, cache.page_table),
        cache.lengths)
    return decode_attention_plain(q, dense, sm_scale, return_lse, spec)


def _launch(q, cache: PagedKVCache, sm_scale, return_lse, spec: int = 1):
    """Launch entry qa_paged_decode on q [n, n_kv * group * spec, d] (folded)."""
    _check_paged_args(q, cache, cache.k_pages.shape[0], spec)
    if cache.k_pages.shape[3] != q.shape[2]:
        raise ValueError(f"q head_dim {q.shape[2]} does not fit the pool's "
                         f"{cache.k_pages.shape[3]}")
    if tuple(x.dtype for x in cache) != (torch.int8, torch.float32, torch.int8, torch.float32,
                                         torch.int32, torch.int32):
        raise TypeError("paged cache must be int8 payloads, f32 scales, int32 table and lengths")
    max_pages = cache.page_table.shape[1]
    return decode_launch.launch("qa_paged_decode", q, cache, cache.k_pages.shape[0],
                                max_pages * cache.page_size,
                                (cache.n_pages, cache.page_size, max_pages), sm_scale,
                                return_lse, spec)


def paged_decode_attention(q, cache: PagedKVCache, sm_scale=None, return_lse=False):
    """Single-token decode against the paged int8 cache: q [n_seqs, H, d].

    GQA as in kv_cache.decode_attention. Returns O [n_seqs, H, d] f32, and
    with return_lse=True the exp2-domain lse [n_seqs, H] (-inf for empty
    rows). CUDA tensors launch B14 (head_dim 64 or 128) or raise; CPU tensors take
    `paged_decode_attention_plain`. `.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, cache, sm_scale, return_lse)
    out = _launch(q, cache, sm_scale, return_lse)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_verify_attention_plain(q, cache: PagedKVCache, sm_scale=None):
    """`paged_verify_attention`'s arithmetic in plain PyTorch."""
    qf, s = fold_verify(q)
    return unfold_verify(paged_decode_attention_plain(qf, cache, sm_scale, spec=s), q.shape[1])


def paged_verify_attention(q, cache: PagedKVCache, sm_scale=None):
    """Speculative staircase verify over the paged int8 cache: q [n, H, s, d]
    (the contract of kv_cache.verify_decode_attention: the s tokens' K/V
    already appended, query j attends the tokens up to length - s + j).
    Returns [n, H, s, d] f32. CUDA tensors launch B14 with spec = s or raise;
    CPU tensors take the plain version. `.launches` counts launches."""
    if q.device.type == "cpu":
        return paged_verify_attention_plain(q, cache, sm_scale)
    qf, s = fold_verify(q)
    o = _launch(qf, cache, sm_scale, False, s)
    paged_verify_attention.launches += 1
    return unfold_verify(o, q.shape[1])


paged_verify_attention.launches = 0
