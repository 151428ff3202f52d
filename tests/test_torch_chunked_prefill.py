"""PyTorch port vs the JAX package: chunked prefill.

The chunk writers of the four cache kinds are held byte-equal to the jitted
JAX writers (payloads, scales, lengths; page 0 left out of the paged pools,
where the port parks a padded chunk's overhang as JAX does), including a
last chunk that overhangs a capacity that is not a chunk multiple; the
prefix readers equal JAX's; `_merge_partials` equals JAX's. The port's
`prefill_chunk`, chunk by chunk on every cache kind, matches JAX's: the last
chunk's logits within LOGIT_TOL and the caches as test_torch_serving.py
holds prefill. The engines (port and JAX, the JAX package's own chunked
workloads) give equal greedy tokens, and decodes advance between chunks.

The LM is the one of test_torch_serving.py at max_seq 512 (the int4
cache's pack blocks), initialised in JAX and carried over with
params_from_jax; the port runs on CPU tensors (B1's plain version), the JAX
package's Pallas kernels in interpret mode.
"""

import dataclasses

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
from quantizedattention_tpu.parallel.ring import _merge_partials as j_merge
from quantizedattention_tpu.serve import ServingEngine as JaxEngine
from quantizedattention_tpu_torch.models import TransformerConfig, params_from_jax
from quantizedattention_tpu_torch.models import transformer as ttr
from quantizedattention_tpu_torch.parallel import kv4_cache as t4
from quantizedattention_tpu_torch.parallel import kv_cache as tkv
from quantizedattention_tpu_torch.parallel import paged4_cache as tp4
from quantizedattention_tpu_torch.parallel import paged_cache as tpc
from quantizedattention_tpu_torch.parallel.ring import _merge_partials
from quantizedattention_tpu_torch.serve import ServingEngine

torch.set_num_threads(2)

# Logits differ by the attention's bf16-P rounding (test_torch_serving.py)
# carried through two layers; random-init logits are O(1).
LOGIT_TOL = 2e-2
MERGE_TOL = 1e-6
PS = 128
CFG = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
           n_layers=2, max_seq=512)
KINDS = ("int8", "paged", "int4", "paged4")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(tcache, jcache, paged):
    """Every field byte-equal; a paged pool's page 0 left out."""
    for name, got, want in zip(tcache._fields, tcache, jcache):
        got, want = _np(got), _np(want)
        if paged and name in ("k_pages", "v_pages", "k_p", "v_p"):
            got, want = got[:, 1:], want[:, 1:]
        elif paged and name in ("sk", "sv"):
            got, want = got[1:], want[1:]
        np.testing.assert_array_equal(got, want, err_msg=name)


# --------------------------------------------------------------------------
# Caches of both packages from the same numpy arrays
# --------------------------------------------------------------------------

def _caches(kind, rng, capacity, random_fill=True, n_rows=2):
    """(JAX cache, port cache) of `kind` with `capacity` tokens a row; with
    random_fill the payloads and scales hold random bytes (a chunk write
    must keep what it does not cover, the other nibble included). A paged
    pool gives row 1 shuffled pages, row 0 others."""
    h, d = 2, 64
    if kind in ("int8", "int4"):
        jc = (jkv.init_kv_cache(n_rows, h, capacity, d) if kind == "int8"
              else j4.init_kv4_cache(n_rows, h, capacity, d))
        tcls = tkv.QuantizedKVCache if kind == "int8" else t4.Int4KVCache
        fields = [np.asarray(x) for x in jc]
        paged = False
    else:
        max_pages = capacity // PS
        n_pages = 1 + n_rows * max_pages
        jc = (jpc.init_paged_cache(h, n_pages, n_rows, max_pages, d, PS) if kind == "paged"
              else jp4.init_paged4_cache(h, n_pages, n_rows, max_pages, d, PS))
        tcls = tpc.PagedKVCache if kind == "paged" else tp4.Paged4KVCache
        fields = [np.asarray(x) for x in jc]
        fields[4] = (rng.permutation(np.arange(1, n_pages))
                     .reshape(n_rows, max_pages).astype(np.int32))
        paged = True
    if random_fill:
        for i in range(4):
            fields[i] = (rng.integers(-128, 128, fields[i].shape, dtype=np.int8)
                         if fields[i].dtype == np.int8
                         else rng.uniform(0.01, 0.1, fields[i].shape).astype(np.float32))
    return (type(jc)(*(jnp.asarray(a) for a in fields)),
            tcls(*(_t(a) for a in fields)), paged)


_J_WRITE = {
    "int8": jax.jit(jkv.write_kv_chunk),
    "int4": jax.jit(j4.write_kv4_chunk),
    "paged": jax.jit(jpc.write_chunk_paged, static_argnums=(4,)),
    "paged4": jax.jit(jp4.write_chunk_paged4, static_argnums=(4,)),
}


def _jax_write_chunk(kind, cache, slot, k, v, chunk_start, new_len):
    """JAX prefill_chunk's write (transformer.py:573-590): the chunk cut at
    the capacity, then the jitted writer."""
    c = k.shape[1]
    if kind.startswith("paged"):
        c_write = min(c, cache.page_table.shape[1] * PS - chunk_start)
        return _J_WRITE[kind](cache, jnp.int32(slot), k[:, :c_write], v[:, :c_write],
                              chunk_start // PS, jnp.int32(new_len))
    c_write = min(c, cache.max_len - chunk_start)
    return _J_WRITE[kind](cache, jnp.int32(slot), k[:, :c_write], v[:, :c_write],
                          chunk_start, jnp.int32(new_len))


def _jax_read_prefix(kind, cache, slot, n):
    if kind == "int8":  # inline in JAX prefill_chunk (transformer.py:602-609)
        return (cache.k_i8[slot, :, :n].astype(jnp.float32) * cache.sk[slot, :, :n, None],
                cache.v_i8[slot, :, :n].astype(jnp.float32) * cache.sv[slot, :, :n, None])
    read = {"int4": j4.read_prefix_kv4, "paged": jpc.read_prefix_paged,
            "paged4": jp4.read_prefix_paged4}[kind]
    return read(cache, jnp.int32(slot), n)


# (kind, capacity, chunk, prompt length): the last chunk overhangs the
# capacity in the second and third of each kind (a max_seq that is not a
# chunk multiple; the int4 cache holds whole 256-token pack blocks)
WRITE_CASES = [(kind, capacity, chunk, true_end) for kind in KINDS
               for capacity, chunk, true_end in ((512, 128, 300), (384, 256, 300),
                                                 (512, 384, 500))
               if not (kind == "int4" and capacity % t4.PACK)]


@pytest.mark.parametrize("kind,capacity,chunk,true_end", WRITE_CASES)
def test_chunk_writers_and_prefix_readers_match_jax(kind, capacity, chunk, true_end):
    """Each chunk of a prompt written into row 1 of a randomly filled cache:
    every field byte-equal to the jitted JAX writer after every chunk, and
    the dequantized prefix before each chunk equal to JAX's."""
    rng = np.random.default_rng(capacity + chunk)
    jc, tc, paged = _caches(kind, rng, capacity)
    for start in range(0, true_end, chunk):
        k = rng.standard_normal((2, chunk, 64), np.float32)
        v = rng.standard_normal((2, chunk, 64), np.float32)
        new_len = min(start + chunk, true_end)
        if start:
            for got, want in zip(ttr._cache_read_prefix(tc, 1, start),
                                 _jax_read_prefix(kind, jc, 1, start)):
                assert got.dtype == torch.float32 and got.shape == (2, start, 64)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jc = _jax_write_chunk(kind, jc, 1, jnp.asarray(k), jnp.asarray(v), start, new_len)
        tc = ttr._cache_write_chunk(tc, 1, _t(k), _t(v), start, new_len)
        _assert_equal(tc, jc, paged)


def test_chunk_writers_refuse_writes_past_capacity():
    rng = np.random.default_rng(0)
    _, tc, _ = _caches("int8", rng, 384)
    k = torch.zeros((2, 256, 64))
    with pytest.raises(ValueError, match="max_len"):
        tkv.write_kv_chunk(tc, 0, k, k, 256, 300)
    _, tc4, _ = _caches("int4", rng, 512)
    with pytest.raises(ValueError, match="max_len"):
        t4.write_kv4_chunk(tc4, 0, k, k, 384, 500)
    _, tp, _ = _caches("paged", rng, 384)
    with pytest.raises(ValueError, match="page"):
        tpc.write_chunk_paged(tp, 0, k, k, 2, 300)
    with pytest.raises(ValueError, match="page"):
        tpc.write_chunk_paged(tp, 0, k[:, :100], k[:, :100], 0, 100)


def test_merge_partials_matches_jax():
    """Random partials with rows where one lse is -inf and rows where both
    are (O = 0, lse -inf), within MERGE_TOL."""
    rng = np.random.default_rng(4)
    o1, o2 = (rng.standard_normal((2, 3, 40, 64), np.float32) for _ in range(2))
    lse1, lse2 = (rng.standard_normal((2, 3, 40), np.float32) * 4 for _ in range(2))
    lse1[0, 0, :5] = -np.inf
    lse2[0, 1, 3:9] = -np.inf
    lse1[1, 2, 10:14] = lse2[1, 2, 10:14] = -np.inf
    got_o, got_l = _merge_partials(_t(o1), _t(lse1), _t(o2), _t(lse2))
    want_o, want_l = (np.asarray(x) for x in j_merge(*(jnp.asarray(a)
                                                      for a in (o1, lse1, o2, lse2))))
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=0, atol=MERGE_TOL)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=MERGE_TOL)
    empty = np.isneginf(want_l)
    assert empty.sum() == 4 and (got_o.numpy()[empty] == 0).all()
    np.testing.assert_array_equal(np.isneginf(got_l.numpy()), empty)


# --------------------------------------------------------------------------
# prefill_chunk against JAX's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**CFG)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, TransformerConfig(**CFG), params_from_jax(jparams, "cpu")


def _logits_instead_of_tokens(monkeypatch):
    """JAX's prefill_chunk returns the last chunk's logits in place of its
    sampled token (the port's prefill_chunk_logits does so itself)."""
    monkeypatch.setattr(jtr, "sample_token", lambda logits, *a, **k: logits)


def _assert_caches_close(tcaches, jcaches, kind):
    """As test_torch_serving.py holds prefill: layer 0's payloads come from
    identical f32 arithmetic (equal but for rounding ties); every layer's
    lengths are equal and its dequantized K/V close. An int4 step is
    absmax / 7, so a value that a deeper layer's attention noise tips
    across a rounding boundary moves by one step: a few such flips are
    allowed there."""
    int4 = kind in ("int4", "paged4")
    payload = ("k_p", "v_p") if int4 else (("k_pages", "v_pages") if kind == "paged"
                                           else ("k_i8", "v_i8"))
    for layer, (tc, jc) in enumerate(zip(tcaches, jcaches)):
        lengths = tc.lengths if kind.startswith("paged") else tc.length
        jlengths = jc.lengths if kind.startswith("paged") else jc.length
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
        got_p = getattr(tc, payload[0]).numpy().astype(np.int32)
        want_p = np.asarray(getattr(jc, payload[0]), np.int32)
        if layer == 0:
            assert (got_p != want_p).mean() <= 1e-3
        for name in payload:
            tk = getattr(tc, name)
            jk = getattr(jc, name)
            sname = "sk" if name.startswith("k") else "sv"
            got = _dequant(tk, getattr(tc, sname), kind)
            want = _dequant(_t(jk), _t(getattr(jc, sname)), kind)
            diff = np.abs(got - want)
            if int4:
                assert (diff > 3e-2).mean() <= 2e-3, (layer, name, (diff > 3e-2).mean())
            else:
                assert diff.max() <= 3e-2, (layer, name, diff.max())


def _dequant(payload, scales, kind):
    if kind == "int8":
        return payload.float().numpy() * scales.numpy()[..., None]
    if kind == "int4":
        return t4.unpack_tokens(payload, t4.PACK).float().numpy() * scales.numpy()[..., None]
    if kind == "paged":
        return payload.float().numpy() * scales.transpose(0, 1).numpy()[..., None]
    return (t4.unpack_tokens(payload, payload.shape[2] * 2).float().numpy()
            * scales.transpose(0, 1).numpy()[..., None])


_J_CHUNK = {}


def _jax_chunk(jcfg):
    """JAX prefill_chunk jitted as the JAX engine runs it (its cache
    writers' numerics are jitted ones)."""
    if jcfg not in _J_CHUNK:
        def chunk(params, caches, tokens, true_end, slot, chunk_start, last):
            return jtr.prefill_chunk(params, caches, tokens, chunk_start, true_end, slot,
                                     jcfg, last)

        _J_CHUNK[jcfg] = jax.jit(chunk, static_argnames=("chunk_start", "last"))
    return _J_CHUNK[jcfg]


@pytest.mark.parametrize("kind,capacity,chunk", [(k, 512, 128) for k in KINDS]
                         + [("int8", 384, 256), ("paged", 384, 256)])
def test_prefill_chunk_matches_jax(lm, monkeypatch, kind, capacity, chunk):
    """A 300-token prompt chunk by chunk into row 1 of fresh caches (the
    last two cases: the last chunk overhangs a capacity of 384): the last
    chunk's logits within LOGIT_TOL of JAX's, the caches close after every
    chunk."""
    jcfg, jparams, cfg, tparams = lm
    _logits_instead_of_tokens(monkeypatch)
    _J_CHUNK.clear()  # trace with the patched sample_token
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG["vocab_size"], 300, dtype=np.int32)
    pairs = [_caches(kind, rng, capacity, random_fill=False) for _ in range(CFG["n_layers"])]
    jcaches, tcaches = [p[0] for p in pairs], [p[1] for p in pairs]
    n_chunks = -(-len(prompt) // chunk)
    for i in range(n_chunks):
        piece = np.zeros(chunk, np.int32)
        part = prompt[i * chunk:(i + 1) * chunk]
        piece[: len(part)] = part
        last = i == n_chunks - 1
        jout, jcaches = _jax_chunk(jcfg)(jparams, jcaches, jnp.asarray(piece),
                                          jnp.int32(len(prompt)), jnp.int32(1),
                                          chunk_start=i * chunk, last=last)
        tout, tcaches = ttr.prefill_chunk_logits(tparams, tcaches, _t(piece).long(), i * chunk,
                                                 len(prompt), 1, cfg, last)
        _assert_caches_close(tcaches, jcaches, kind)
        assert (tout is None) == (not last) == (jout is None)
    err = np.abs(tout.float().numpy() - np.asarray(jout)).max()
    assert err <= LOGIT_TOL, err


def test_prefill_chunk_runs_b1_twice_past_the_first_chunk(lm, monkeypatch):
    """The first chunk attends causally to itself only; a later chunk runs
    B1 causal on itself and non-causal on its dequantized prefix, whatever
    cfg.attention is."""
    _, _, cfg, tparams = lm
    calls = []
    real = ttr.flash_attention_fwd

    def spy(q, k, v, causal=False, **kw):
        calls.append((q.shape[2], k.shape[2], causal, k.dtype))
        return real(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(ttr, "flash_attention_fwd", spy)
    int8_cfg = dataclasses.replace(cfg, attention="int8")
    caches = [tkv.init_kv_cache(1, 2, 512, 64, "cpu") for _ in range(2)]
    tokens = torch.arange(128) % 64
    tok, caches = ttr.prefill_chunk(tparams, caches, tokens, 0, 200, 0, int8_cfg, False)
    assert tok is None and calls == [(128, 128, True, torch.float32)] * 2
    calls.clear()
    tok, caches = ttr.prefill_chunk(tparams, caches, tokens, 128, 200, 0, int8_cfg, True)
    assert calls == [(128, 128, True, torch.float32), (128, 128, False, torch.float32)] * 2
    assert tok.shape == () and caches[0].length.tolist() == [200]


# --------------------------------------------------------------------------
# The engine, against the JAX engine on the JAX package's own workloads
# --------------------------------------------------------------------------

# tests/test_serving.py's small_cfg (vocab 64, d_model 64, 2 heads, 2 layers)
SMALL = dict(vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=64, n_layers=2)


def _small(max_seq, seed=0):
    jcfg = jtr.TransformerConfig(**SMALL, max_seq=max_seq)
    jparams = jtr.init_transformer(jax.random.key(seed), jcfg)
    return jcfg, jparams, TransformerConfig(**SMALL, max_seq=max_seq), \
        params_from_jax(jparams, "cpu")


def _serve(params, cfg, prompts, budget, jax_engine=False, n_slots=2, **kw):
    if jax_engine:
        eng = JaxEngine(params, cfg, n_slots=n_slots, scheduler="python", **kw)
    else:
        eng = ServingEngine(params, cfg, "cpu", n_slots=n_slots, scheduler="python", **kw)
    rids = [eng.submit(p, budget) for p in prompts]
    out = eng.run()
    return [out[r].tokens for r in rids], eng


@pytest.fixture(scope="module")
def small512():
    return _small(512)


@pytest.mark.parametrize("cache", ["slotted", "paged"])
def test_engine_chunked_prefill_matches_unchunked_and_jax(small512, cache):
    """JAX tests/test_serving.py:270: a multi-chunk prompt beside a short
    one on 2 slots; the port's chunked tokens equal its one-shot tokens and
    the JAX chunked engine's."""
    jcfg, jparams, cfg, tparams = small512
    long_prompt = list(range(2, 50))
    longer = ([7, 3, 9, 11] * 80)[: cfg.max_seq - 40]
    prompts = [longer, long_prompt]
    plain, _ = _serve(tparams, cfg, prompts, 8, cache=cache)
    chunked, _ = _serve(tparams, cfg, prompts, 8, cache=cache, prefill_chunk=128)
    jax_chunked, _ = _serve(jparams, jcfg, prompts, 8, jax_engine=True, cache=cache,
                            prefill_chunk=128)
    assert chunked == plain == jax_chunked


def test_engine_chunked_prefill_nonaligned_capacity():
    """JAX tests/test_serving.py:294: the last chunk overhangs a max_seq of
    384 with chunks of 256; tokens equal the one-shot engine's and JAX's."""
    jcfg, jparams, cfg, tparams = _small(384)
    prompt = [int(x % 63) + 1 for x in range(300)]
    plain, _ = _serve(tparams, cfg, [prompt], 6, n_slots=1)
    chunked, eng = _serve(tparams, cfg, [prompt], 6, n_slots=1, prefill_chunk=256)
    jax_chunked, _ = _serve(jparams, jcfg, [prompt], 6, jax_engine=True, n_slots=1,
                            prefill_chunk=256)
    assert chunked == plain == jax_chunked
    assert eng.ledger()["dispatches"] >= 2


def test_engine_chunked_prefill_interleaves_decodes(small512):
    """JAX tests/test_serving.py:315: a running request keeps emitting tokens
    while a long prompt prefills chunk by chunk, and a decode bank runs
    between every two chunks."""
    _, _, cfg, tparams = small512
    eng = ServingEngine(tparams, cfg, "cpu", n_slots=2, scheduler="python", prefill_chunk=128)
    actions = []
    real_chunk, real_decode = eng._do_prefill_chunk, eng._do_decode
    eng._do_prefill_chunk = lambda: (actions.append("chunk"), real_chunk())[1]
    eng._do_decode = lambda: (actions.append("decode"), real_decode())[1]
    ra = eng.submit([5, 6, 7], 20)
    eng.step()
    eng.step()
    eng._flush_pending()
    before = len(eng._outputs[ra])
    long_prompt = ([1, 2, 3, 4] * 90)[: cfg.max_seq - 30]
    rb = eng.submit(long_prompt, 4)
    actions.clear()
    while not eng._outputs[rb]:
        assert eng.step()
        eng._flush_pending()
    assert len(eng._outputs[ra]) > before
    n_chunks = -(-len(long_prompt) // 128)
    assert actions == ["chunk", "decode"] * (n_chunks - 1) + ["chunk"]
    res = eng.run()
    assert len(res[rb].tokens) == 4 and len(res[ra].tokens) == 20


@pytest.fixture(scope="module")
def small256():
    return _small(256)


def test_engine_kv4_chunked_prefill_matches_jax():
    """JAX tests/test_int4_kv_cache.py:205 on its LM (head_dim 32, seed 5):
    slotted int4, a 199-token prompt in two chunks of 128 (the second
    writes high nibbles); tokens equal the one-shot int4 engine's and the
    JAX chunked engine's. The JAX test's prompt, 1 .. 199, runs past the
    vocab of 64, which the JAX engine's gather clamps and the port's
    submit refuses: here it is taken mod 64."""
    shape = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                 n_layers=2, max_seq=256)
    jcfg = jtr.TransformerConfig(**shape)
    jparams = jtr.init_transformer(jax.random.key(5), jcfg)
    cfg, tparams = TransformerConfig(**shape), params_from_jax(jparams, "cpu")
    prompt = [x % 64 for x in range(1, 200)]
    plain, _ = _serve(tparams, cfg, [prompt], 8, kv_quant="int4")
    chunked, _ = _serve(tparams, cfg, [prompt], 8, kv_quant="int4", prefill_chunk=128)
    jax_chunked, _ = _serve(jparams, jcfg, [prompt], 8, jax_engine=True, kv_quant="int4",
                            prefill_chunk=128)
    assert chunked == plain == jax_chunked


def test_engine_paged4_chunked_prefill_matches_paged4(small256):
    """The paged int4 pool chunked: tokens equal its one-shot engine's."""
    _, _, cfg, tparams = small256
    prompts = [[x % 64 for x in range(1, 200)], [9, 4, 2]]
    plain, _ = _serve(tparams, cfg, prompts, 8, cache="paged", kv_quant="int4")
    chunked, _ = _serve(tparams, cfg, prompts, 8, cache="paged", kv_quant="int4",
                        prefill_chunk=128)
    assert chunked == plain


@pytest.mark.parametrize("options,match", [
    ({"prefill_chunk": 100}, "multiple of 128"), ({"prefill_chunk": 0}, "multiple of 128"),
    ({"prefill_chunk": 128, "cache": "paged", "page_size": 256}, "page_size"),
    ({"adaptive_horizon": 0}, "adaptive_horizon"),
    ({"spec_decode": 2, "adaptive_horizon": 8}, "adaptive_horizon"),
])
def test_engine_refuses_what_jax_refuses(small256, options, match):
    """The constructor's checks, with the JAX engine's exception type."""
    jcfg, jparams, cfg, tparams = small256
    with pytest.raises(ValueError, match=match):
        JaxEngine(jparams, jcfg, scheduler="python", **options)
    with pytest.raises(ValueError, match=match):
        ServingEngine(tparams, cfg, "cpu", scheduler="python", **options)


def test_engine_chunked_with_spec_decode(small256):
    """Spec decoding over a chunked admission: tokens equal the plain
    chunked engine's (JAX accepts the combination too)."""
    _, _, cfg, tparams = small256
    prompts = [[5, 6, 7, 5, 6, 7] * 30, [12, 33, 2, 47]]
    plain, _ = _serve(tparams, cfg, prompts, 12, prefill_chunk=128)
    spec, eng = _serve(tparams, cfg, prompts, 12, prefill_chunk=128, spec_decode=3)
    assert spec == plain and eng.stats()["spec"]["accepted"] > 0


def _horizon_picks(eng):
    """Record every bank size the engine picks."""
    picks, real = [], eng._pick_horizon

    def spy(active):
        picks.append(real(active))
        return picks[-1]

    eng._pick_horizon = spy
    return picks


@pytest.mark.parametrize("budgets", [(13, 13), (5, 11, 3)])
def test_adaptive_horizon_picks_match_jax(budgets):
    """JAX tests/test_serving.py:638's workload (its small LM at max_seq 128,
    init key 42), and one with a request waiting for a slot: the port's bank
    sizes equal the JAX engine's one for one, powers of two, and the tokens
    equal the fixed-horizon engine's and JAX's."""
    jcfg = jtr.TransformerConfig(**SMALL, max_seq=128)
    jparams = jtr.init_transformer(jax.random.key(42), jcfg)
    cfg, tparams = TransformerConfig(**SMALL, max_seq=128), params_from_jax(jparams, "cpu")
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]][:len(budgets)]
    runs = {}
    for name, params, c, jax_engine, kw in (
            ("fixed", tparams, cfg, False, {}), ("port", tparams, cfg, False,
                                                 {"adaptive_horizon": 32}),
            ("jax", jparams, jcfg, True, {"adaptive_horizon": 32})):
        if jax_engine:
            eng = JaxEngine(params, c, n_slots=2, scheduler="python", decode_horizon=4, **kw)
        else:
            eng = ServingEngine(params, c, "cpu", n_slots=2, scheduler="python",
                                decode_horizon=4, **kw)
        picks = _horizon_picks(eng)
        rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        out = eng.run()
        runs[name] = ([out[r].tokens for r in rids], picks)
    assert runs["port"][0] == runs["fixed"][0] == runs["jax"][0]
    assert runs["port"][1] == runs["jax"][1]
    assert all(h & (h - 1) == 0 for h in runs["port"][1]) and runs["fixed"][1] == \
        [4] * len(runs["fixed"][1])
    if budgets == (13, 13):  # the JAX test's: one ceil-bucket bank drains the queue
        assert max(runs["port"][1]) == 16
