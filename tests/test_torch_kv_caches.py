"""PyTorch port vs the JAX package: the paged and int4 KV caches.

The same numpy inputs go to the JAX cache functions and to their
counterparts in quantizedattention_tpu_torch (CPU tensors, so the decode
wrappers run their plain versions; the Pallas kernels run in interpret mode
on the JAX side). The JAX cache writers run under jit when serving, so the
port's writers are held byte-equal, payloads and scales, to the jitted JAX
functions. The CUDA kernels (B14-B16) are held against these plain versions
on the card by chip_smoke.py.

A small LM of its own (vocab 64, d_model 128, 4 q / 2 kv heads, head_dim 64,
2 layers, max_seq 256: the JAX int4 cache wants whole 256-token pack blocks)
gives the teacher-forced decode logits of every cache kind and the engine
runs.
"""

import inspect
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.parallel import kv4_cache as j4
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu.parallel import paged4_cache as jp4
from quantizedattention_tpu.parallel import paged_cache as jpc
from quantizedattention_tpu.quantize.weights import embedding_lookup as j_embed
from quantizedattention_tpu.quantize.weights import mm as j_mm
from quantizedattention_tpu_torch.models import TransformerConfig, params_from_jax, prefill_slots
from quantizedattention_tpu_torch.models.transformer import _decode_logits
from quantizedattention_tpu_torch.parallel import kv4_cache as t4
from quantizedattention_tpu_torch.parallel import kv_cache as tkv
from quantizedattention_tpu_torch.parallel import paged4_cache as tp4
from quantizedattention_tpu_torch.parallel import paged_cache as tpc
from quantizedattention_tpu_torch.serve import ServingEngine
from quantizedattention_tpu_torch.serve.scheduler import NativePager, PyPager, make_pager

torch.set_num_threads(2)

# Decode plain version vs the Pallas kernel: only the summation order and
# where P is rounded to bf16 differ (as for B13, test_torch_kernels.py).
DECODE_TOL = 5e-3
# Logits carry that attention noise through two layers (as
# test_torch_serving.py); random-init logits are O(1).
LOGIT_TOL = 2e-2
PS = 128  # the JAX paged caches take 128-multiples
CFG = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
           n_layers=2, max_seq=256)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(tcache, jcache, skip_page0=False):
    """Every field byte-equal; for a paged pool page 0 (the garbage page,
    where the port sends the writes JAX drops) is left out."""
    for name, got, want in zip(tcache._fields, tcache, jcache):
        got, want = got.numpy(), np.asarray(want)
        if skip_page0 and name in ("k_pages", "v_pages", "k_p", "v_p"):
            got, want = got[:, 1:], want[:, 1:]
        elif skip_page0 and name in ("sk", "sv"):
            got, want = got[1:], want[1:]
        np.testing.assert_array_equal(got, want, err_msg=name)


# --------------------------------------------------------------------------
# Quantizers
# --------------------------------------------------------------------------

def test_quant4_rows_matches_jitted_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 256, 64), np.float32)
    x[0, 0, 0] = 0.0  # the 1e-12 scale floor
    q_j, s_j = jax.jit(j4._quant4_rows)(jnp.asarray(x))
    q_t, s_t = t4._quant4_rows(_t(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert q_t.min() >= 0 and q_t.max() <= 15
    # eager JAX divides by 7 and misses jitted JAX on about half the scales
    _, s_eager = j4._quant4_rows(jnp.asarray(x))
    assert (np.asarray(s_eager) != np.asarray(s_j)).mean() > 0.1


def test_rows_nibbles_and_unpack_match_jax():
    pos = np.arange(0, 1024, 7)
    for got, want in zip(t4._rows_nibbles(_t(pos)), j4._rows_nibbles(jnp.asarray(pos))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(1)
    p = rng.integers(-128, 128, (2, 3, 256, 64), dtype=np.int8)
    s = rng.uniform(0.01, 0.1, (2, 3, 512)).astype(np.float32)
    jc = j4.Int4KVCache(*(jnp.asarray(a) for a in (p, s, p, s, np.zeros(2, np.int32))))
    tc = t4.Int4KVCache(*(_t(a) for a in (p, s, p, s, np.zeros(2, np.int32))))
    for got, want in zip(t4.dequantize_kv4(tc), j4.dequantize_kv4(jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# Writers: byte-equal to the jitted JAX writers
# --------------------------------------------------------------------------

KINDS = {"int8": (jpc, tpc, "init_paged_cache", "write_prompt_paged", "append_tokens_paged"),
         "int4": (jp4, tp4, "init_paged4_cache", "write_prompt_paged4", "append_tokens_paged4")}


def _pools(kind, rng, n_pages=16, n_seqs=4, max_pages=3):
    """The same pool in both packages: random payloads and scales (so a
    read-modify-write must keep the other nibble), shuffled page rows.
    Returns (JAX cache, port cache, pages no row owns)."""
    jmod, tmod, init, _, _ = KINDS[kind]
    jc = getattr(jmod, init)(2, n_pages, n_seqs, max_pages, 64, PS)
    arrays = [rng.integers(-128, 128, x.shape, dtype=np.int8) if x.dtype == jnp.int8
              else rng.uniform(0.01, 0.1, x.shape).astype(np.float32) for x in jc[:4]]
    pages = rng.permutation(np.arange(1, n_pages))
    table = pages[: n_seqs * max_pages].reshape(n_seqs, max_pages).astype(np.int32)
    table[1, 2] = 0  # a row that owns two pages: its tail entry is the garbage page
    fields = arrays + [table, np.zeros(n_seqs, np.int32)]
    jc = type(jc)(*(jnp.asarray(a) for a in fields))
    tc = getattr(tmod, init)(2, n_pages, n_seqs, max_pages, 64, PS, "cpu")
    tc = type(tc)(*(_t(a) for a in fields))
    return jc, tc, pages[n_seqs * max_pages:]


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_assign_and_write_prompt_paged_match_jax(kind):
    rng = np.random.default_rng(2)
    jmod, tmod, _, write, _ = KINDS[kind]
    jc, tc, spare = _pools(kind, rng)
    jassign = jpc.assign_pages if kind == "int8" else jp4.assign_pages4
    tassign = tpc.assign_pages if kind == "int8" else tp4.assign_pages4
    row = np.asarray([spare[0], spare[1], 0], np.int32)
    jc = jassign(jc, jnp.int32(2), jnp.asarray(row))
    tc = tassign(tc, 2, _t(row))
    for seq, t_pad, true_len in ((0, 3 * PS, 300), (2, 2 * PS, 129), (3, PS, 5)):
        k = rng.standard_normal((2, t_pad, 64), np.float32)
        v = rng.standard_normal((2, t_pad, 64), np.float32)
        jc = getattr(jmod, write)(jc, jnp.int32(seq), jnp.asarray(k), jnp.asarray(v),
                                  jnp.int32(true_len))
        seq_t = seq if seq != 3 else torch.tensor([3])  # ints and 1-element tensors alike
        tc = getattr(tmod, write)(tc, seq_t, _t(k), _t(v), true_len)
    _assert_equal(tc, jc)
    assert tc.lengths.tolist() == [300, 0, 129, 5]
    with pytest.raises(ValueError, match="page multiple"):
        getattr(tmod, write)(tc, 0, _t(k[:, :100]), _t(v[:, :100]), 5)


# (lengths before, new tokens, active): a page edge inside the run, a write
# through an unassigned table entry (row 1 at 256: page 0 in both packages),
# inactive rows, a row at table capacity (its tail tokens are dropped), and,
# for t past half a page, an int4 append in two pieces
APPEND_CASES = [
    ([127, 256, 200, 383], 1, [True, True, True, True]),
    ([126, 5, 256, 380], 5, [True, False, True, True]),
    ([60, 120, 130, 300], 70, [True, True, False, True]),
]


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("case", range(len(APPEND_CASES)))
def test_append_tokens_paged_matches_jax(kind, case):
    lengths, t, active = APPEND_CASES[case]
    rng = np.random.default_rng(10 + case)
    jmod, tmod, _, _, append = KINDS[kind]
    jc, tc, _ = _pools(kind, rng)
    jc = jc._replace(lengths=jnp.asarray(lengths, jnp.int32))
    tc.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    before = [x.clone() for x in tc]
    k = rng.standard_normal((4, 2, t, 64), np.float32)
    v = rng.standard_normal((4, 2, t, 64), np.float32)
    jc = getattr(jmod, append)(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(active))
    tc = getattr(tmod, append)(tc, _t(k), _t(v), _t(active))
    _assert_equal(tc, jc, skip_page0=True)
    # an inactive row writes no page of its table, and does not advance
    for row, act in enumerate(active):
        if act:
            continue
        assert tc.lengths[row] == lengths[row]
        pages = [p for p in tc.page_table[row].tolist() if p]
        assert torch.equal(tc[0][:, pages], before[0][:, pages])
        assert torch.equal(tc.sk[pages], before[1][pages])


def test_write_kv4_slot_matches_jax():
    rng = np.random.default_rng(3)
    b, h, max_len = 3, 2, 512
    fields = [rng.integers(-128, 128, (b, h, max_len // 2, 64), dtype=np.int8),
              rng.uniform(0.01, 0.1, (b, h, max_len)).astype(np.float32),
              rng.integers(-128, 128, (b, h, max_len // 2, 64), dtype=np.int8),
              rng.uniform(0.01, 0.1, (b, h, max_len)).astype(np.float32),
              np.asarray([7, 9, 11], np.int32)]
    jc = j4.Int4KVCache(*(jnp.asarray(a) for a in fields))
    tc = t4.Int4KVCache(*(_t(a) for a in fields))
    write = jax.jit(j4.write_kv4_slot)  # it runs inside the jitted prefills
    for slot, t, true_len in ((1, 100, 97), (0, 300, 300), (2, 512, 400)):
        k = rng.standard_normal((h, t, 64), np.float32)
        v = rng.standard_normal((h, t, 64), np.float32)
        jc = write(jc, jnp.int32(slot), jnp.asarray(k), jnp.asarray(v), jnp.int32(true_len))
        tc = t4.write_kv4_slot(tc, torch.tensor([slot]) if slot else slot, _t(k), _t(v), true_len)
    _assert_equal(tc, jc)


def test_install_kv4_batched_matches_jax():
    rng = np.random.default_rng(4)
    jc = j4.init_kv4_cache(3, 2, 512, 64)
    tc = t4.init_kv4_cache(3, 2, 512, 64, "cpu")
    k = rng.standard_normal((3, 2, 300, 64), np.float32)
    v = rng.standard_normal((3, 2, 300, 64), np.float32)
    jc = j4.install_kv4_batched(jc, jnp.asarray(k), jnp.asarray(v))
    tc = t4.install_kv4_batched(tc, _t(k), _t(v))
    _assert_equal(tc, jc)


@pytest.mark.parametrize("t_new,use_active", [(1, False), (3, True), (130, False)])
def test_append_kv4_matches_jax(t_new, use_active):
    """Odd offsets, so both nibbles of a byte row get written; a row that
    runs past max_len (JAX drops those tokens)."""
    rng = np.random.default_rng(t_new)
    b, h, max_len = 5, 2, 512
    lengths = np.asarray([1, 127, 128, 301, 510], np.int32)
    fields = [rng.integers(-128, 128, (b, h, max_len // 2, 64), dtype=np.int8),
              rng.uniform(0.01, 0.1, (b, h, max_len)).astype(np.float32),
              rng.integers(-128, 128, (b, h, max_len // 2, 64), dtype=np.int8),
              rng.uniform(0.01, 0.1, (b, h, max_len)).astype(np.float32), lengths]
    jc = j4.Int4KVCache(*(jnp.asarray(a) for a in fields))
    tc = t4.Int4KVCache(*(_t(a) for a in fields))
    k = rng.standard_normal((b, h, t_new, 64), np.float32)
    v = rng.standard_normal((b, h, t_new, 64), np.float32)
    active = np.asarray([True, False, True, True, True]) if use_active else None
    jc = j4.append_kv4(jc, jnp.asarray(k), jnp.asarray(v),
                       active=None if active is None else jnp.asarray(active))
    tc = t4.append_kv4(tc, _t(k), _t(v), active=None if active is None else _t(active))
    _assert_equal(tc, jc)


# --------------------------------------------------------------------------
# Decode plain versions vs the JAX kernels (interpret mode)
# --------------------------------------------------------------------------

LENGTHS = [0, 1, 127, 128, 300, 384]


def _paged_decode_case(kind, rng, n_q, lengths=LENGTHS, max_pages=3):
    """A pool whose pages are shuffled across sequences; page 0 and every
    page past a row's length hold junk payloads."""
    n = len(lengths)
    jmod, tmod, init, _, _ = KINDS[kind]
    n_pages = 1 + n * max_pages
    jc = getattr(jmod, init)(2, n_pages, n, max_pages, 64, PS)
    fields = [rng.integers(-128, 128, x.shape, dtype=np.int8) if x.dtype == jnp.int8
              else rng.uniform(0.002, 0.03, x.shape).astype(np.float32) for x in jc[:4]]
    table = rng.permutation(np.arange(1, n_pages)).reshape(n, max_pages).astype(np.int32)
    for row, length in enumerate(lengths):
        table[row, -(-length // PS):] = 0
    fields += [table, np.asarray(lengths, np.int32)]
    q = rng.standard_normal((n, n_q, 64), np.float32)
    tcls = tpc.PagedKVCache if kind == "int8" else tp4.Paged4KVCache
    return q, type(jc)(*(jnp.asarray(a) for a in fields)), tcls(*(_t(a) for a in fields))


def _assert_decode_close(o_t, lse_t, o_j, lse_j, lengths):
    assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= DECODE_TOL
    live = np.asarray(lengths) > 0
    assert np.abs(lse_t.numpy()[live] - np.asarray(lse_j)[live]).max() <= DECODE_TOL
    assert (o_t[~torch.from_numpy(live)] == 0).all()
    assert torch.isneginf(lse_t[~torch.from_numpy(live)]).all()


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("n_q", [2, 8])
def test_paged_decode_plain_matches_jax(kind, n_q):
    rng = np.random.default_rng(n_q)
    q, jc, tc = _paged_decode_case(kind, rng, n_q)
    if kind == "int8":
        o_j, lse_j = jpc.paged_decode_attention(jnp.asarray(q), jc, return_lse=True)
        o_t, lse_t = tpc.paged_decode_attention(_t(q), tc, return_lse=True)
    else:
        o_j, lse_j = jp4.paged4_decode_attention(jnp.asarray(q), jc, return_lse=True)
        o_t, lse_t = tp4.paged4_decode_attention(_t(q), tc, return_lse=True)
    _assert_decode_close(o_t, lse_t, o_j, lse_j, LENGTHS)


@pytest.mark.parametrize("n_q", [2, 8])
def test_decode4_plain_matches_jax(n_q):
    rng = np.random.default_rng(20 + n_q)
    lengths = [0, 1, 127, 128, 129, 255, 300, 512]
    b, max_len = len(lengths), 512
    fields = [rng.integers(-128, 128, (b, 2, max_len // 2, 64), dtype=np.int8),
              rng.uniform(0.002, 0.03, (b, 2, max_len)).astype(np.float32),
              rng.integers(-128, 128, (b, 2, max_len // 2, 64), dtype=np.int8),
              rng.uniform(0.002, 0.03, (b, 2, max_len)).astype(np.float32),
              np.asarray(lengths, np.int32)]
    q = rng.standard_normal((b, n_q, 64), np.float32)
    jc = j4.Int4KVCache(*(jnp.asarray(a) for a in fields))
    tc = t4.Int4KVCache(*(_t(a) for a in fields))
    o_j, lse_j = j4.decode_attention_int4(jnp.asarray(q), jc, return_lse=True)
    o_t, lse_t = t4.decode_attention_int4(_t(q), tc, return_lse=True)
    _assert_decode_close(o_t, lse_t, o_j, lse_j, lengths)


def test_decode_plains_ignore_stale_entries_past_length():
    """Non-finite scales past a row's length (the tail of its last page, the
    high half of a half-live int4 byte row, page 0) leave every output as
    it was: the plain versions mask with `where`."""
    rng = np.random.default_rng(5)
    lengths = [1, 127, 129, 300]
    for kind, fn in (("int8", tpc.paged_decode_attention), ("int4", tp4.paged4_decode_attention)):
        q, _, clean = _paged_decode_case(kind, rng, 4, lengths)
        stale = type(clean)(*(x.clone() for x in clean))
        for row, length in enumerate(lengths):
            for j, page in enumerate(clean.page_table[row].tolist()):
                tok = j * PS + torch.arange(PS)
                dead = tok >= length
                stale.sk[page, :, dead] = float("nan")
                stale.sv[page, :, dead] = float("inf")
        o_s, o_c = fn(_t(q), stale), fn(_t(q), clean)
        assert torch.isfinite(o_s).all()
        torch.testing.assert_close(o_s, o_c, rtol=0, atol=0)
    # slotted int4: stale scales past the length, in both nibble halves
    fields = [torch.from_numpy(rng.integers(-128, 128, (4, 2, 256, 64), dtype=np.int8)),
              torch.rand(4, 2, 512) * 0.03 + 0.002,
              torch.from_numpy(rng.integers(-128, 128, (4, 2, 256, 64), dtype=np.int8)),
              torch.rand(4, 2, 512) * 0.03 + 0.002, torch.tensor(lengths, dtype=torch.int32)]
    clean = t4.Int4KVCache(*fields)
    stale = t4.Int4KVCache(*(x.clone() for x in fields))
    dead = torch.arange(512)[None, None] >= clean.length[:, None, None]
    stale.sk[dead.expand_as(stale.sk)] = float("nan")
    stale.sv[dead.expand_as(stale.sv)] = float("inf")
    q = torch.randn(4, 4, 64)
    o_s = t4.decode_attention_int4(q, stale)
    assert torch.isfinite(o_s).all()
    torch.testing.assert_close(o_s, t4.decode_attention_int4(q, clean), rtol=0, atol=0)


def test_paged_plains_equal_their_slotted_twins_on_shuffled_pages():
    """The same K/V dense and through shuffled pages give the same output:
    paged int8 == slotted int8 (B14 vs B13's arithmetic), and paged int4 at
    a page of 256 tokens == slotted int4 (the page is the pack block)."""
    rng = np.random.default_rng(6)
    lengths = [0, 1, 255, 256, 300, 512]
    n, ps, max_pages = len(lengths), 256, 2
    q = torch.randn(n, 8, 64)
    perm = torch.from_numpy(rng.permutation(np.arange(1, 1 + n * max_pages)))
    table = perm.reshape(n, max_pages).to(torch.int32)
    for kind in ("int8", "int4"):
        rows = ps if kind == "int8" else ps // 2
        dense_k = torch.from_numpy(rng.integers(-128, 128, (n, 2, max_pages * rows, 64),
                                                dtype=np.int8))
        dense_v = torch.from_numpy(rng.integers(-128, 128, (n, 2, max_pages * rows, 64),
                                                dtype=np.int8))
        sk = torch.rand(n, 2, max_pages * ps) * 0.03 + 0.002
        sv = torch.rand(n, 2, max_pages * ps) * 0.03 + 0.002
        length = torch.tensor(lengths, dtype=torch.int32)
        n_pages = 1 + n * max_pages
        pool_k = torch.zeros((2, n_pages, rows, 64), dtype=torch.int8)
        pool_v = torch.zeros_like(pool_k)
        pool_sk = torch.full((n_pages, 2, ps), float("nan"))
        pool_sv = torch.full((n_pages, 2, ps), float("nan"))
        for s in range(n):
            for j in range(max_pages):
                p = int(table[s, j])
                pool_k[:, p] = dense_k[s, :, j * rows:(j + 1) * rows]
                pool_v[:, p] = dense_v[s, :, j * rows:(j + 1) * rows]
                pool_sk[p] = sk[s, :, j * ps:(j + 1) * ps]
                pool_sv[p] = sv[s, :, j * ps:(j + 1) * ps]
        if kind == "int8":
            want = tkv.decode_attention(q, tkv.QuantizedKVCache(dense_k, sk, dense_v, sv, length))
            got = tpc.paged_decode_attention(
                q, tpc.PagedKVCache(pool_k, pool_sk, pool_v, pool_sv, table, length))
        else:
            want = t4.decode_attention_int4(q, t4.Int4KVCache(dense_k, sk, dense_v, sv, length))
            got = tp4.paged4_decode_attention(
                q, tp4.Paged4KVCache(pool_k, pool_sk, pool_v, pool_sv, table, length))
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_decode_wrappers_refuse_bad_shapes():
    cache = tpc.init_paged_cache(2, 4, 2, 2, 64, 16, "cpu")
    with pytest.raises(ValueError, match="multiple"):
        tpc.paged_decode_attention(torch.randn(2, 3, 64), cache)
    with pytest.raises(ValueError, match="sequences"):
        tpc.paged_decode_attention(torch.randn(3, 4, 64), cache)
    with pytest.raises(ValueError, match="even"):
        tp4.init_paged4_cache(2, 4, 2, 2, 64, 15, "cpu")
    with pytest.raises(ValueError, match="256"):
        t4.init_kv4_cache(2, 2, 384, 64, "cpu")


# --------------------------------------------------------------------------
# The LM on every cache kind
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**CFG)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, TransformerConfig(**CFG), params_from_jax(jparams, "cpu")


def _caches(kind, n, package):
    """One layer's empty cache of `kind` for n rows, in `package`."""
    max_pages = CFG["max_seq"] // PS
    n_pages = 1 + n * max_pages
    if package == "jax":
        return {"int8": lambda: jkv.init_kv_cache(n, 2, CFG["max_seq"], 64),
                "int4": lambda: j4.init_kv4_cache(n, 2, CFG["max_seq"], 64),
                "paged": lambda: jpc.init_paged_cache(2, n_pages, n, max_pages, 64, PS),
                "paged4": lambda: jp4.init_paged4_cache(2, n_pages, n, max_pages, 64, PS)}[kind]()
    return {"int8": lambda: tkv.init_kv_cache(n, 2, CFG["max_seq"], 64, "cpu"),
            "int4": lambda: t4.init_kv4_cache(n, 2, CFG["max_seq"], 64, "cpu"),
            "paged": lambda: tpc.init_paged_cache(2, n_pages, n, max_pages, 64, PS, "cpu"),
            "paged4": lambda: tp4.init_paged4_cache(2, n_pages, n, max_pages, 64, PS,
                                                    "cpu")}[kind]()


def _jax_decode_logits(params, caches, last_tok, pos, active, cfg):
    """decode_step_batched of the JAX package up to its logits, through its
    own cache-kind dispatch."""
    x = j_embed(params["embed"], last_tok)[:, None, :]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = jtr.rmsnorm(x, layer["ln1"])
        q, k, v = jtr._project_qkv(layer, h, cfg, pos[:, None])
        cache = jtr._cache_append(cache, k, v, active=active)
        o = jtr._cache_decode(q[:, :, 0, :], cache)
        o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim)
        x = jtr._mlp_residual(layer, x + j_mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    x = jtr.rmsnorm(x, params["final_norm"])
    return j_mm(x[:, 0], params["unembed"]), new_caches


@pytest.mark.parametrize("kind", ["int8", "int4", "paged", "paged4"])
def test_teacher_forced_decode_matches_jax(lm, kind):
    """Prefill two requests into rows 1 and 0, then four teacher-forced
    decode steps (one with row 1 inactive): the port's logits stay within
    LOGIT_TOL of the JAX package's on every cache kind."""
    jcfg, jparams, cfg, tparams = lm
    rng = np.random.default_rng(7)
    lens = [20, 9]
    tokens = np.zeros((2, PS), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 64, n)
    slots = np.asarray([1, 0], np.int32)
    jcaches = [_caches(kind, 2, "jax") for _ in range(2)]
    tcaches = [_caches(kind, 2, "torch") for _ in range(2)]
    if kind.startswith("paged"):  # rows 0 and 1 own shuffled pages
        rows = np.asarray([[4, 1], [2, 3]], np.int32)
        jassign = jpc.assign_pages if kind == "paged" else jp4.assign_pages4
        for s in range(2):
            jcaches = [jassign(c, jnp.int32(s), jnp.asarray(rows[s])) for c in jcaches]
            tcaches = [tpc.assign_pages(c, s, _t(rows[s])) for c in tcaches]
    _, jcaches = jtr.prefill_slots(jparams, jcaches, jnp.asarray(tokens), jnp.asarray(lens),
                                   jnp.asarray(slots), jcfg)
    _, tcaches = prefill_slots(tparams, tcaches, _t(tokens).long(), _t(lens),
                               _t(slots).long(), cfg)
    pos = np.asarray([9, 20], np.int32)  # row 0 holds the 9-token prompt
    forced = rng.integers(0, 64, (4, 2), dtype=np.int32)
    actives = [[True, True], [True, False], [True, True], [True, True]]
    for step, (tok, act) in enumerate(zip(forced, actives)):
        act = np.asarray(act)
        jl, jcaches = _jax_decode_logits(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos),
                                         jnp.asarray(act), jcfg)
        tl, tcaches = _decode_logits(tparams, tcaches, _t(tok).long(), _t(pos).long(),
                                     _t(act), cfg)
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL, f"{kind} step {step}"
        pos = pos + act
    length = "lengths" if kind.startswith("paged") else "length"
    assert getattr(tcaches[0], length).tolist() == [13, 23]
    np.testing.assert_array_equal(getattr(tcaches[1], length).numpy(),
                                  np.asarray(getattr(jcaches[1], length)))


PROMPTS = [[1, 2, 3], [10, 20, 30, 40, 50, 60, 7], [5] * 12, [63, 0, 42, 17],
           [9, 8, 7, 6, 5, 4, 3, 2, 1]]
BUDGETS = [4, 7, 3, 6, 5]


def _serve(tparams, cfg, **options):
    eng = ServingEngine(tparams, cfg, "cpu", n_slots=2, **options)
    rids = [eng.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    out = eng.run()
    return eng, [out[r].tokens for r in rids]


@pytest.mark.parametrize("kv_quant", [None, "int4"])
def test_engine_paged_tokens_equal_slotted(lm, kv_quant):
    """5 requests on 2 slots: the paged pool serves the slotted cache's
    tokens, token for token, with int8 and with int4 payloads."""
    _, _, cfg, tparams = lm
    _, slotted = _serve(tparams, cfg, kv_quant=kv_quant, scheduler="python", decode_horizon=2)
    eng, paged = _serve(tparams, cfg, kv_quant=kv_quant, cache="paged", page_size=16)
    assert paged == slotted
    assert all(len(t) == b for t, b in zip(paged, BUDGETS))
    stats = eng.stats()
    assert stats["cache"] == "paged" and stats["pages_free"] == 2 * 16
    assert type(eng.caches[0]) is (tp4.Paged4KVCache if kv_quant else tpc.PagedKVCache)


@pytest.mark.parametrize("scheduler", ["native", "python"])
def test_engine_small_pool_requeues_and_returns_every_page(lm, scheduler):
    """A pool of 3 usable 8-token pages holds one 2-page request at a time:
    admission requeues, pages are recycled while banks of 3 steps are in
    flight, and the tokens still equal the slotted engine's."""
    _, _, cfg, tparams = lm
    _, want = _serve(tparams, cfg, scheduler="python")
    eng = ServingEngine(tparams, cfg, "cpu", n_slots=2, cache="paged", page_size=8, n_pages=4,
                        decode_horizon=3, scheduler=scheduler)
    requeues = []
    requeue = eng.sched.requeue
    eng.sched.requeue = lambda slot: (requeues.append(slot), requeue(slot))
    rids = [eng.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    out = eng.run()
    assert [out[r].tokens for r in rids] == want
    assert requeues and eng.stats()["pages_free"] == 3 and eng.stats()["completed"] == 5
    with pytest.raises(ValueError, match="pages > pool"):
        eng.submit([1] * 20, max_new_tokens=8)  # 4 pages of 8


def test_native_pager_matches_python_step_for_step():
    nat, py = make_pager("native", 10), make_pager("python", 10)
    assert isinstance(nat, NativePager) and isinstance(py, PyPager)
    rng = random.Random(0)
    held = []
    for _ in range(400):
        if held and rng.random() < 0.45:
            pages = held.pop(rng.randrange(len(held)))
            extra = [0, 10, pages[0]] if rng.random() < 0.2 else []  # ignored by both
            nat.free(pages + extra)
            py.free(pages + extra)
        else:
            n = rng.randint(0, 4)
            a, b = nat.alloc(n), py.alloc(n)
            assert a == b, f"alloc({n}): native {a}, python {b}"
            if a is not None:
                assert 0 not in a
                held.append(a)
        assert nat.num_free == py.num_free
    with pytest.raises(ValueError):
        make_pager("native", 1)
    with pytest.raises(ValueError):
        make_pager("cuda", 8)


@pytest.mark.parametrize("init", [t4.init_kv4_cache, tpc.init_paged_cache, tp4.init_paged4_cache])
def test_cache_constructors_default_to_the_card(init):
    """A caller that names no device gets the cache on the card, as the
    slotted int8 cache's constructor, which takes no default, makes the
    caller say."""
    assert inspect.signature(init).parameters["device"].default == "cuda"
    slotted = inspect.signature(tkv.init_kv_cache).parameters["device"]
    assert slotted.default is inspect.Parameter.empty
