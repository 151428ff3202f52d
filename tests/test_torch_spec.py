"""PyTorch port vs the JAX package: speculative decoding.

The same numpy inputs go to the JAX package and to quantizedattention_tpu_torch
(CPU tensors, so the verify wrappers run their plain versions; the JAX side's
Pallas kernels run in interpret mode). Held here:

  * the four verify plains (the spec > 1 staircase of B13-B16) against the
    JAX verify functions on shuffled tables, across a page edge, on rows a
    query cannot see into, and at s = 1;
  * greedy `verify_step_batched` against JAX's on all four cache kinds, with
    drafts that are all accepted and drafts that are all rejected, and the
    append-verify-rollback cache sequence byte for byte;
  * the port's sampled verify: realization-equal to its own draft-free loop,
    seeded, and distributed as softmax(logits / T);
  * the n-gram drafter, Python and native, against the JAX package's;
  * the engine's spec_decode against the port's plain engine and the JAX spec
    engine, EOS, validation, and requests that fill the cache, including the
    paged one whose verify the JAX engine misaligns (ROADMAP.md, C2).

The CUDA kernels are held against these plain versions, and bit for bit
against their own spec = 1 launches, by chip_smoke.py on the card.
"""

import dataclasses
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
from quantizedattention_tpu.serve import ServingEngine as JaxEngine
from quantizedattention_tpu.serve import spec as jspec
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    params_from_jax,
    prefill_batched,
    prefill_slots,
    verify_step_batched,
)
from quantizedattention_tpu_torch.models.transformer import (
    _cache_append,
    _cache_rollback,
    _mlp_residual,
    _mlp_residual_per_position,
    gumbel_draws,
    rmsnorm,
)
from quantizedattention_tpu_torch.parallel import kv4_cache as t4
from quantizedattention_tpu_torch.parallel import kv_cache as tkv
from quantizedattention_tpu_torch.parallel import paged4_cache as tp4
from quantizedattention_tpu_torch.parallel import paged_cache as tpc
from quantizedattention_tpu_torch.serve import ServingEngine
from quantizedattention_tpu_torch.serve import spec as tspec

torch.set_num_threads(2)

# Verify plain vs the Pallas kernel: only the summation order and where P is
# rounded to bf16 differ (the decode kernels' tolerance, test_torch_kv_caches).
DECODE_TOL = 5e-3
PS = 128  # the JAX paged caches take 128-multiples
KINDS = ("int8", "int4", "paged", "paged4")


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# The verify plains vs the JAX verify functions
# --------------------------------------------------------------------------

# with s = 4: a row that no query sees into (0), one whose first queries see
# nothing (3 < s), one whose queries straddle the page edge at 128 (127-130),
# and two that cross later edges
LENGTHS = [0, 3, 130, 258, 383]


def _verify_case(kind, rng, n_kv, max_pages=3):
    """The same cache in both packages: random payloads and scales, for a
    paged pool a shuffled table whose entries past each row's pages are 0."""
    n = len(LENGTHS)
    lengths = np.asarray(LENGTHS, np.int32)
    if kind in ("int8", "int4"):
        max_len = 512 if kind == "int4" else 384
        rows = max_len // 2 if kind == "int4" else max_len
        pay, sc = (n, n_kv, rows, 64), (n, n_kv, max_len)
        extra = []
    else:
        n_pages = 1 + n * max_pages
        pay = (n_kv, n_pages, PS // 2 if kind == "paged4" else PS, 64)
        sc = (n_pages, n_kv, PS)
        table = rng.permutation(np.arange(1, n_pages)).reshape(n, max_pages).astype(np.int32)
        for row, length in enumerate(LENGTHS):
            table[row, -(-length // PS):] = 0
        extra = [table]
    fields = [rng.integers(-128, 128, pay, dtype=np.int8),
              rng.uniform(0.002, 0.03, sc).astype(np.float32),
              rng.integers(-128, 128, pay, dtype=np.int8),
              rng.uniform(0.002, 0.03, sc).astype(np.float32), *extra, lengths]
    jcls = {"int8": jkv.QuantizedKVCache, "int4": j4.Int4KVCache, "paged": jpc.PagedKVCache,
            "paged4": jp4.Paged4KVCache}[kind]
    tcls = {"int8": tkv.QuantizedKVCache, "int4": t4.Int4KVCache, "paged": tpc.PagedKVCache,
            "paged4": tp4.Paged4KVCache}[kind]
    return jcls(*(jnp.asarray(a) for a in fields)), tcls(*(_t(a) for a in fields))


JAX_VERIFY = {"int8": jkv.verify_decode_attention, "int4": j4.verify_decode_attention_int4,
              "paged": jpc.paged_verify_attention, "paged4": jp4.paged4_verify_attention}
VERIFY = {"int8": tkv.verify_decode_attention, "int4": t4.verify_decode_attention_int4,
          "paged": tpc.paged_verify_attention, "paged4": tp4.paged4_verify_attention}
DECODE = {"int8": tkv.decode_attention, "int4": t4.decode_attention_int4,
          "paged": tpc.paged_decode_attention, "paged4": tp4.paged4_decode_attention}


def _check_verify(kind, n_q, n_kv, s, seed):
    rng = np.random.default_rng(seed)
    jc, tc = _verify_case(kind, rng, n_kv)
    q = rng.standard_normal((len(LENGTHS), n_q, s, 64), np.float32)
    got = VERIFY[kind](_t(q), tc)
    want = np.asarray(JAX_VERIFY[kind](jnp.asarray(q), jc))
    assert got.shape == (len(LENGTHS), n_q, s, 64) and got.dtype == torch.float32
    # query j sees the tokens before length - s + 1 + j; where that is none,
    # the port gives 0 and the JAX kernel NaN (exp2(-inf - -inf) in its
    # alpha), except on rows where no block runs at all (length 0)
    sees = (np.asarray(LENGTHS)[:, None] - s + 1 + np.arange(s)[None]) > 0  # [n, s]
    seen = np.broadcast_to(sees[:, None, :, None], want.shape)
    assert np.abs(got.numpy()[seen] - want[seen]).max() <= DECODE_TOL
    assert (got.numpy()[~seen] == 0).all()
    assert np.isfinite(got.numpy()).all()
    return got, tc, q


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_q,n_kv", [(4, 4), (4, 2), (8, 1)])
def test_verify_plain_matches_jax(kind, n_q, n_kv):
    """Each verify plain against the JAX verify function, and each query row
    against the port's own decode at that row's causal bound."""
    got, tc, q = _check_verify(kind, n_q, n_kv, 4, seed=n_q * 10 + n_kv)
    for j in range(4):
        bound = (tc[-1] - 3 + j).clamp(min=0).to(torch.int32)
        want = DECODE[kind](_t(q[:, :, j]), type(tc)(*tc[:-1], bound))
        torch.testing.assert_close(got[:, :, j], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_verify_plain_single_query_matches_jax_and_decode(kind):
    """s = 1, the draft-free loop of the sampling oracle: the JAX verify
    function and the port's decode."""
    got, tc, q = _check_verify(kind, 4, 2, 1, seed=99)
    torch.testing.assert_close(got[:, :, 0], DECODE[kind](_t(q[:, :, 0]), tc), rtol=0, atol=0)


def test_verify_plains_ignore_stale_scales():
    """NaN/inf scales past every row's length leave the verify outputs as
    they were: the staircase is masked with `where`."""
    rng = np.random.default_rng(5)
    for kind in KINDS:
        _, clean = _verify_case(kind, rng, 2)
        stale = type(clean)(*(x.clone() for x in clean))
        q = torch.randn(len(LENGTHS), 4, 3, 64)
        if kind in ("int8", "int4"):
            dead = torch.arange(stale.sk.shape[-1])[None, None] >= clean[-1][:, None, None]
            stale.sk[dead.expand_as(stale.sk)] = float("nan")
            stale.sv[dead.expand_as(stale.sv)] = float("inf")
        else:  # page 0 and every unowned page, and each row's dead tail
            stale.sk[0], stale.sv[0] = float("nan"), float("inf")
            for row, length in enumerate(LENGTHS):
                for j, page in enumerate(clean.page_table[row].tolist()):
                    dead = j * PS + torch.arange(PS) >= length
                    if page:
                        stale.sk[page, :, dead] = float("nan")
                        stale.sv[page, :, dead] = float("inf")
        o_s, o_c = VERIFY[kind](q, stale), VERIFY[kind](q, clean)
        assert torch.isfinite(o_s).all()
        torch.testing.assert_close(o_s, o_c, rtol=0, atol=0)


def test_verify_wrappers_refuse_bad_shapes():
    cache = tkv.init_kv_cache(2, 2, 128, 64, "cpu")
    with pytest.raises(ValueError, match=r"\[b, H, s, d\]"):
        tkv.verify_decode_attention(torch.randn(2, 4, 64), cache)
    with pytest.raises(ValueError, match="multiple"):
        tkv.verify_decode_attention(torch.randn(2, 3, 2, 64), cache)


# --------------------------------------------------------------------------
# verify_step_batched vs JAX, greedy, on every cache kind
# --------------------------------------------------------------------------

CFG = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
           n_layers=2, max_seq=256)


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


def _prefilled(lm, kind):
    """Two prompts prefilled into rows 1 and 0 of both packages' caches (on
    shuffled pages for a paged kind). Returns (JAX caches, port caches,
    first tokens, positions)."""
    jcfg, jparams, cfg, tparams = lm
    rng = np.random.default_rng(7)
    lens = [20, 9]
    tokens = np.zeros((2, PS), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 64, n)
    slots = np.asarray([1, 0], np.int32)
    jcaches = [_caches(kind, 2, "jax") for _ in range(2)]
    tcaches = [_caches(kind, 2, "torch") for _ in range(2)]
    if kind.startswith("paged"):
        rows = np.asarray([[4, 1], [2, 3]], np.int32)
        jassign = jpc.assign_pages if kind == "paged" else jp4.assign_pages4
        for s in range(2):
            jcaches = [jassign(c, jnp.int32(s), jnp.asarray(rows[s])) for c in jcaches]
            tcaches = [tpc.assign_pages(c, s, _t(rows[s])) for c in tcaches]
    first, jcaches = jtr.prefill_slots(jparams, jcaches, jnp.asarray(tokens), jnp.asarray(lens),
                                       jnp.asarray(slots), jcfg)
    _, tcaches = prefill_slots(tparams, tcaches, _t(tokens).long(), _t(lens),
                               _t(slots).long(), cfg)
    first = np.asarray(first)[np.argsort(slots)]  # by row
    return jcaches, tcaches, first, np.asarray([9, 20], np.int32)


def _assert_caches_match(tcaches, jcaches, paged):
    """Lengths equal, payloads and scales as close as the two packages' f32
    projections allow (a paged pool's page 0 left out: the port parks the
    writes JAX drops there). The projections round differently in f32: a
    K/V row's absmax, so its scale, moves by up to 2e-6 relative, and a
    value on a rounding boundary lands one int8 step away (1 in 65,536
    here). test_append_verify_rollback_is_byte_equal holds the cache side
    byte for byte on the same K/V."""
    for tc, jc in zip(tcaches, jcaches):
        for name, got, want in zip(tc._fields, tc, jc):
            got, want = got.numpy(), np.asarray(want)
            if paged and name in ("k_pages", "v_pages", "k_p", "v_p"):
                got, want = got[:, 1:], want[:, 1:]
            elif paged and name in ("sk", "sv"):
                got, want = got[1:], want[1:]
            if name in ("sk", "sv"):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=name)
            elif name in ("length", "lengths", "page_table"):
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:  # int8 payloads (int4: nibble pairs, compared as bytes)
                off = got != want
                assert off.mean() <= 1e-3, name
                if name in ("k_i8", "v_i8", "k_pages", "v_pages"):
                    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("drafts", ["accepted", "rejected"])
def test_verify_step_greedy_matches_jax(lm, kind, drafts):
    """Drafts equal to JAX's own greedy continuation are all accepted
    (n_emit = s); drafts off by 7 are all rejected (n_emit = 1). emitted,
    n_emit and the caches after the rollback equal JAX's."""
    jcfg, jparams, cfg, tparams = lm
    s = 4
    jcaches, tcaches, first, pos = _prefilled(lm, kind)
    active = np.asarray([True, True])
    # JAX's plain greedy continuation after `first`, on a copy (its appends
    # donate their cache buffers)
    stream, tok, p = [], jnp.asarray(first), jnp.asarray(pos)
    jc = jax.tree.map(jnp.copy, jcaches)
    for _ in range(s - 1):
        tok, jc = jtr.decode_step_batched(jparams, jc, tok, p, jnp.asarray(active), jcfg)
        p = p + 1
        stream.append(np.asarray(tok))
    draft = np.stack(stream, 1).astype(np.int32)
    if drafts == "rejected":
        draft = (draft + 7) % CFG["vocab_size"]
    j_emit, j_n, jcaches = jtr.verify_step_batched(
        jparams, jcaches, jnp.asarray(first), jnp.asarray(draft), jnp.asarray(pos),
        jnp.asarray(active), jcfg)
    t_emit, t_n, tcaches = verify_step_batched(
        tparams, tcaches, _t(first).long(), _t(draft), _t(pos).long(), _t(active), cfg)
    assert t_n.tolist() == np.asarray(j_n).tolist() == ([s, s] if drafts == "accepted" else [1, 1])
    assert t_emit.tolist() == np.asarray(j_emit).tolist()
    _assert_caches_match(tcaches, jcaches, kind.startswith("paged"))
    length = "lengths" if kind.startswith("paged") else "length"
    assert getattr(tcaches[0], length).tolist() == (pos + t_n.numpy()).tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_mlp_runs_each_position_as_a_decode_step(dtype):
    """The verify pass's MLP: position i's down projection is the [n, d_ff]
    product of its own contiguous rows (a decode step's), and the whole is
    `_mlp_residual` up to the products' rounding (2e-6 in f32; in bf16 two
    ulps of outputs below 4)."""
    n, s, d, d_ff = 3, 5, 16, 48
    g = torch.Generator().manual_seed(0)
    layer = {"ln2": (1 + 0.1 * torch.randn(d, generator=g)).to(dtype),
             "w1": (torch.randn(d, d_ff, generator=g) * d ** -0.5).to(dtype),
             "w2": (torch.randn(d_ff, d, generator=g) * d_ff ** -0.5).to(dtype)}
    x = torch.randn(n, s, d, generator=g).to(dtype)
    got = _mlp_residual_per_position(layer, x)
    h = torch.nn.functional.gelu(rmsnorm(x, layer["ln2"]) @ layer["w1"], approximate="tanh")
    for i in range(s):
        assert torch.equal(got[:, i], x[:, i] + h[:, i].contiguous() @ layer["w2"])
    tol = 2e-6 if dtype == torch.float32 else 2 * 2 ** -6
    torch.testing.assert_close(got.float(), _mlp_residual(layer, x).float(), rtol=0, atol=tol)


@pytest.mark.parametrize("kind", KINDS)
def test_append_verify_rollback_is_byte_equal(kind):
    """The cache side of a verify step on the same K/V in both packages: s
    tokens appended across a page edge (one row inactive), then rolled back
    by 0..s-1; every payload, scale and length equals JAX's."""
    rng = np.random.default_rng(11)
    n, s = 3, 5
    jc, tc = _caches(kind, n, "jax"), _caches(kind, n, "torch")
    lengths = np.asarray([126, 60, 200], np.int32)
    if kind.startswith("paged"):
        table = np.asarray([[3, 5], [1, 0], [6, 2]], np.int32)
        jc = jc._replace(page_table=jnp.asarray(table))
        tc.page_table.copy_(_t(table))
    fields = [f for f in jc._fields if f not in ("page_table", "lengths", "length")]
    for name in fields:  # the same random contents, so a nibble write keeps its twin
        x = np.asarray(getattr(jc, name))
        x = (rng.integers(-128, 128, x.shape, dtype=np.int8) if x.dtype == np.int8
             else rng.uniform(0.01, 0.1, x.shape).astype(np.float32))
        jc = jc._replace(**{name: jnp.asarray(x)})
        getattr(tc, name).copy_(_t(x))
    length = "lengths" if kind.startswith("paged") else "length"
    jc = jc._replace(**{length: jnp.asarray(lengths)})
    getattr(tc, length).copy_(_t(lengths))
    k = rng.standard_normal((n, 2, s, 64), np.float32)
    v = rng.standard_normal((n, 2, s, 64), np.float32)
    active = np.asarray([True, False, True])
    jc = jtr._cache_append(jc, jnp.asarray(k), jnp.asarray(v), active=jnp.asarray(active))
    tc = _cache_append(tc, _t(k), _t(v), active=_t(active))
    drop = np.asarray([4, 2, 0], np.int32) * active
    jc = jtr._cache_rollback(jc, jnp.asarray(drop))
    tc = _cache_rollback(tc, _t(drop))
    for name, got, want in zip(tc._fields, tc, jc):
        got, want = got.numpy(), np.asarray(want)
        if kind.startswith("paged") and name in ("k_pages", "v_pages", "k_p", "v_p"):
            got, want = got[:, 1:], want[:, 1:]
        elif kind.startswith("paged") and name in ("sk", "sv"):
            got, want = got[1:], want[1:]
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert getattr(tc, length).tolist() == [127, 60, 205]


# --------------------------------------------------------------------------
# Sampled verify: the port's own oracle and the law
# --------------------------------------------------------------------------

def _fresh(tparams, cfg, prompt):
    b = prompt.shape[0]
    caches = [tkv.init_kv_cache(b, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim, "cpu")
              for _ in tparams["layers"]]
    first, caches = prefill_batched(tparams, caches, prompt, cfg)
    return caches, first, torch.full((b,), prompt.shape[1], dtype=torch.long)


@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_verify_step_sampled_realization_exact(lm, temperature):
    """Sampled spec decode equals the draft-free sampled verify loop (s = 1)
    under the same seed, draw for draw, whether every draft is accepted (the
    oracle's own future tokens) or rejected (shifted by half the vocab): a
    draw is keyed by (seed, row, absolute position)."""
    _, _, cfg, tparams = lm
    b, s, n, seed = 2, 4, 8, 42
    prompt = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]])
    active = torch.ones(b, dtype=torch.bool)
    caches, last, pos = _fresh(tparams, cfg, prompt)
    oracle = []
    for _ in range(n):
        emitted, n_emit, caches = verify_step_batched(
            tparams, caches, last, torch.zeros((b, 0), dtype=torch.long), pos, active, cfg,
            temperature, seed)
        assert n_emit.tolist() == [1, 1]
        last, pos = emitted[:, 0], pos + 1
        oracle.append(last)
    want = torch.stack(oracle, 1).tolist()

    def run_spec(shift):
        caches, last, p = _fresh(tparams, cfg, prompt)
        got = [[] for _ in range(b)]
        while min(len(g) for g in got) < n:
            draft = torch.tensor([((want[i] + [0] * s)[len(got[i]):len(got[i]) + s - 1])
                                  for i in range(b)])
            draft = (draft + shift) % cfg.vocab_size
            emitted, n_emit, caches = verify_step_batched(
                tparams, caches, last, draft, p, active, cfg, temperature, seed)
            for i in range(b):
                got[i].extend(emitted[i, :n_emit[i]].tolist())
            last, p = emitted[torch.arange(b), n_emit - 1], p + n_emit
        return [g[:n] for g in got]

    assert run_spec(0) == want
    assert run_spec(cfg.vocab_size // 2) == want


def test_gumbel_draws_follow_the_softmax():
    """Chi-square test of 30,000 draws on a 6-token vocab against
    softmax(logits / T), and the counter-based keying: the same (seed, row,
    position) draws the same token, another seed another stream."""
    logits = torch.tensor([1.0, 0.0, -0.5, 2.0, 0.3, -1.0])
    t, rows, positions = 0.7, 3000, 10
    lg = logits.expand(rows, positions, 6)
    pos = torch.arange(positions)[None].expand(rows, -1)
    draws = gumbel_draws(lg, t, 1234, torch.arange(rows), pos)
    counts = torch.bincount(draws.flatten(), minlength=6).double()
    expect = torch.softmax(logits.double() / t, 0) * rows * positions
    chi2 = ((counts - expect) ** 2 / expect).sum().item()
    assert chi2 < 20.52  # chi-square, 5 degrees of freedom, p = 0.001
    assert torch.equal(draws, gumbel_draws(lg, t, 1234, torch.arange(rows), pos))
    other = gumbel_draws(lg, t, 1235, torch.arange(rows), pos)
    assert (other != draws).float().mean() > 0.3
    # a draw depends on its own (row, position) only
    part = gumbel_draws(lg[5:7, 2:4], t, 1234, torch.tensor([5, 6]), pos[5:7, 2:4])
    assert torch.equal(part, draws[5:7, 2:4])


def test_engine_spec_sampling_is_seeded(lm):
    """Sampled spec serving: the same seed gives the same streams, another
    seed others, tokens in vocab."""
    _, _, cfg, tparams = lm
    prompts = [[5, 6, 7] * 8, [12, 33, 2, 47]]

    def run(seed):
        eng = ServingEngine(tparams, cfg, "cpu", n_slots=2, scheduler="python", spec_decode=3,
                            temperature=0.8, seed=seed)
        rids = [eng.submit(p, 10) for p in prompts]
        out = eng.run()
        return [out[r].tokens for r in rids]

    a = run(3)
    assert a == run(3) and run(4) != a
    assert all(len(t) == 10 and all(0 <= x < cfg.vocab_size for x in t) for t in a)


# --------------------------------------------------------------------------
# The n-gram drafter
# --------------------------------------------------------------------------

def test_propose_lookup_python_native_and_jax_agree():
    """The port's Python and native proposers equal the JAX package's
    propose_lookup on random, periodic and edge-case histories."""
    rng = random.Random(0)
    cases = [[], [3], [1, 2, 1, 2, 1, 2], [7, 8, 9, 1, 2, 5, 7, 8], list(range(50))]
    for _ in range(200):
        vocab = rng.choice([2, 3, 8, 50])
        cases.append([rng.randrange(vocab) for _ in range(rng.randrange(0, 60))])
    for hist in cases:
        for k in (1, 3, 8):
            for mx in (1, 2, 3, 5):
                want = jspec.propose_lookup(hist, k, max_ngram=mx)
                assert tspec.propose_lookup(hist, k, max_ngram=mx) == want, (hist, k, mx)
                assert tspec.propose_lookup_native(hist, k, max_ngram=mx) == want, (hist, k, mx)
    assert tspec.propose_lookup([7, 8, 9, 1, 2, 5, 7, 8], 3) == [9, 1, 2]


def test_make_lookup_kinds():
    assert tspec.make_lookup("native") is tspec.propose_lookup_native
    assert tspec.make_lookup("python") is tspec.propose_lookup
    with pytest.raises(ValueError, match="proposer"):
        tspec.make_lookup("cuda")


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

# the JAX package's own spec-decode LM (tests/test_spec_decode.py): head_dim 32
SMALL = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, n_layers=2,
             max_seq=128)
ENGINE_KINDS = {"slotted": {}, "paged": {"cache": "paged", "n_pages": 16},
                "int4": {"kv_quant": "int4"},
                "paged4": {"cache": "paged", "n_pages": 16, "kv_quant": "int4"}}


@pytest.fixture(scope="module")
def small_lm():
    jcfg = jtr.TransformerConfig(**SMALL, attention="bf16")
    jparams = jtr.init_transformer(jax.random.key(3), jcfg)
    return jcfg, jparams, TransformerConfig(**SMALL), params_from_jax(jparams, "cpu")


def _run(params, cfg, prompts, budget=24, jax_engine=False, **kw):
    if jax_engine:
        eng = JaxEngine(params, cfg, n_slots=2, scheduler="python", **kw)
    else:
        eng = ServingEngine(params, cfg, "cpu", n_slots=2, scheduler="python", **kw)
    rids = [eng.submit(p, budget) for p in prompts]
    out = eng.run()
    return [out[r].tokens for r in rids], eng


@pytest.mark.parametrize("kind", list(ENGINE_KINDS))
def test_engine_spec_matches_plain_and_jax(small_lm, kind):
    """Greedy spec serving on each cache kind: the port's spec tokens equal
    its plain engine's and the JAX spec engine's, and the periodic prompt
    banks accepted drafts."""
    jcfg, jparams, cfg, tparams = small_lm
    kw = dict(ENGINE_KINDS[kind])
    if kind == "int4":  # whole 256-token pack blocks
        jcfg, cfg = dataclasses.replace(jcfg, max_seq=256), dataclasses.replace(cfg, max_seq=256)
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], [12, 33, 2, 47]]
    plain, _ = _run(tparams, cfg, prompts, **kw)
    spec, eng = _run(tparams, cfg, prompts, spec_decode=3, **kw)
    jax_spec, _ = _run(jparams, jcfg, prompts, jax_engine=True, spec_decode=3, **kw)
    assert spec == plain == jax_spec
    st = eng.stats()["spec"]
    assert st["accepted"] > 0 and st["tokens_per_pass"] > 1.0
    assert st["emitted"] >= sum(len(t) for t in spec) - len(spec)
    assert eng.stats()["completed"] == 2


def test_engine_spec_eos_and_validation(small_lm):
    _, _, cfg, tparams = small_lm
    prompts = [[4, 4, 5, 4, 4, 5, 4, 4]]
    plain, _ = _run(tparams, cfg, prompts, budget=16)
    eos = plain[0][5]
    plain_eos, _ = _run(tparams, cfg, prompts, budget=16, eos_id=eos)
    spec_eos, eng = _run(tparams, cfg, prompts, budget=16, eos_id=eos, spec_decode=4)
    assert spec_eos == plain_eos and spec_eos[0][-1] == eos
    assert eng.stats()["completed"] == 1
    with pytest.raises(ValueError, match="horizon"):
        ServingEngine(tparams, cfg, "cpu", decode_horizon=4, spec_decode=2)
    with pytest.raises(ValueError, match="spec_decode"):
        ServingEngine(tparams, cfg, "cpu", spec_decode=0)
    with pytest.raises(ValueError, match="proposer"):
        ServingEngine(tparams, cfg, "cpu", scheduler="cuda", spec_decode=2)


@pytest.mark.parametrize("kind", list(ENGINE_KINDS))
def test_engine_spec_at_full_capacity(small_lm, kind):
    """A request whose prompt + budget fills max_seq: a verify appends
    spec + 1 tokens past the last position. Slotted caches take them in their
    slack rows, a paged row on page 0 through its wider table; spec tokens
    equal plain tokens (JAX's test_engine_spec_at_full_capacity, every kind)."""
    _, _, cfg, tparams = small_lm
    kw = dict(ENGINE_KINDS[kind])
    if kind == "int4":
        cfg = dataclasses.replace(cfg, max_seq=256)
    budget = 24
    prompt = ([5, 6, 7] * cfg.max_seq)[: cfg.max_seq - budget]
    plain, _ = _run(tparams, cfg, [prompt], budget=budget, **kw)
    spec, eng = _run(tparams, cfg, [prompt], budget=budget, spec_decode=4, **kw)
    assert spec == plain and len(plain[0]) == budget
    assert eng.stats()["spec"]["accepted"] > 0
    if kind.startswith("paged"):  # ceil((max_seq + spec) / page_size) entries
        assert eng.caches[0].page_table.shape == (2, 2)
        assert eng.stats()["pages_free"] == 15


def test_paged_verify_at_table_capacity_stays_aligned():
    """The JAX engine's defect, pinned: a row of one 128-token page at length
    125 appends 5 verify tokens. The JAX paged append drops the two past the
    table's end and does not count them, so lengths end at 128 and every
    verify row sees the wrong keys. The port's engine gives a row
    ceil((max_seq + spec) / page_size) entries, the extra ones page 0: the
    overshoot lands there and counts, and each verify row equals decode at
    its own bound."""
    rng = np.random.default_rng(3)
    s, base = 5, 125
    j_cache = jpc.init_paged_cache(2, 3, 1, 1, 64, PS)
    j_cache = jpc.assign_pages(j_cache, jnp.int32(0), jnp.asarray([2]))
    t_cache = tpc.init_paged_cache(2, 3, 1, 2, 64, PS, "cpu")
    t_cache = tpc.assign_pages(t_cache, 0, torch.tensor([2, 0]))
    k0 = rng.standard_normal((1, 2, base, 64), np.float32)
    v0 = rng.standard_normal((1, 2, base, 64), np.float32)
    k1 = rng.standard_normal((1, 2, s, 64), np.float32)
    v1 = rng.standard_normal((1, 2, s, 64), np.float32)
    q = rng.standard_normal((1, 4, s, 64), np.float32)
    on = np.asarray([True])
    for k, v in ((k0, v0), (k1, v1)):
        j_cache = jpc.append_tokens_paged(j_cache, jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(on))
        t_cache = tpc.append_tokens_paged(t_cache, _t(k), _t(v), _t(on))
    assert np.asarray(j_cache.lengths).tolist() == [128]
    assert t_cache.lengths.tolist() == [base + s]
    j_got = np.asarray(jpc.paged_verify_attention(jnp.asarray(q), j_cache))
    t_got = tpc.paged_verify_attention(_t(q), t_cache)
    # the three rows whose positions (125..127) lie on the row's own page
    for j in range(3):
        bound = base + 1 + j
        t_want = tpc.paged_decode_attention(_t(q[:, :, j]), t_cache._replace(
            lengths=torch.tensor([bound], dtype=torch.int32)))
        torch.testing.assert_close(t_got[:, :, j], t_want, rtol=0, atol=1e-5)
        j_want = np.asarray(jpc.paged_decode_attention(jnp.asarray(q[:, :, j]), j_cache._replace(
            lengths=jnp.asarray([bound], jnp.int32))))
        assert np.abs(j_got[:, :, j] - j_want).max() > 1e-2
