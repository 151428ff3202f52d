"""PyTorch port vs the JAX package: the prefix cache.

The port's prefix store (quantizedattention_tpu_torch/serve/prefix_store.py)
runs the cases of the JAX package's own store tests (tests/test_prefix_store.py,
tests/test_prefix_store_native.py) as parametrised cases against the port's
Python store and its native one (native/prefix_store.cpp built into
build/), gives the JAX Python store's results on randomized operation
sequences, and is held native against Python. The engine with
`prefix_cache=True` serves the JAX package's prefix workloads
(tests/test_prefix_cache.py) with the JAX engine's greedy tokens and prefix
statistics, and a warm engine's tokens equal a cold one's.
"""

import importlib.util
import os
import random

import jax
import pytest
import torch

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.serve import ServingEngine as JaxEngine
from quantizedattention_tpu.serve.prefix_store import PyPrefixStore as JaxPyPrefixStore
from quantizedattention_tpu_torch import _build
from quantizedattention_tpu_torch.models import TransformerConfig, params_from_jax
from quantizedattention_tpu_torch.serve import ServingEngine
from quantizedattention_tpu_torch.serve import prefix_store as tps

torch.set_num_threads(2)


def _load(name):
    """A module of the JAX package's tests, loaded under a name of its own
    (its test functions are run below, not collected from here)."""
    path = os.path.join(os.path.dirname(__file__), f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_cases_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_STORE_CASES = _load("test_prefix_store")
_NATIVE_CASES = _load("test_prefix_store_native")
# the stress case reads the Python store's internals (`_by_page`)
STORE_CASES = [(kind, name) for kind in ("python", "native")
               for name in sorted(n for n in vars(_STORE_CASES) if n.startswith("test_"))
               if not (kind == "native" and name == "test_stress_random_ops_conserve_pages")]


@pytest.mark.parametrize("kind,case", STORE_CASES)
def test_jax_store_cases_on_the_port(monkeypatch, kind, case):
    """Each case of the JAX package's tests/test_prefix_store.py with the
    port's store in place of JAX's PyPrefixStore."""
    monkeypatch.setattr(_STORE_CASES, "PyPrefixStore",
                        lambda ps: tps.make_prefix_store(kind, ps))
    getattr(_STORE_CASES, case)()


@pytest.mark.parametrize("case", ["test_native_basic_chain",
                                  "test_native_acquire_unknown_page_raises",
                                  "test_native_matches_python_randomized"])
def test_jax_native_store_cases_on_the_port(monkeypatch, case):
    """The JAX package's native-store cases (tests/test_prefix_store_native.py,
    the randomized differential one at :51 included) on the port's native
    and Python stores. The native store must build: no skip, no fallback."""
    monkeypatch.setattr(_NATIVE_CASES, "NativePrefixStore", tps.NativePrefixStore)
    monkeypatch.setattr(_NATIVE_CASES, "PyPrefixStore", tps.PyPrefixStore)
    monkeypatch.setattr(_NATIVE_CASES, "_native_or_skip", tps.NativePrefixStore)
    getattr(_NATIVE_CASES, case)()


@pytest.mark.parametrize("seed", range(3))
def test_python_store_matches_jax_randomized(seed):
    """Random lookup / acquire / register / release / evict streams on the
    port's Python store and the JAX package's: every return value and every
    observable equal."""
    rng = random.Random(seed)
    ps = rng.choice((2, 4))
    port, ref = tps.PyPrefixStore(ps), JaxPyPrefixStore(ps)
    prompts = [[rng.randrange(5) for _ in range(rng.randrange(ps, 8 * ps))] for _ in range(12)]
    next_page, held = [1], []
    for _ in range(500):
        op, prompt = rng.random(), rng.choice(prompts)
        if op < 0.3:
            cap = rng.choice((None, 0, 1, 3))
            assert port.lookup(prompt, max_pages=cap) == ref.lookup(prompt, max_pages=cap)
        elif op < 0.6:
            n_full = len(prompt) // ps
            hit = port.lookup(prompt, max_pages=max(0, n_full - 1))
            assert hit == ref.lookup(prompt, max_pages=max(0, n_full - 1))
            port.acquire(hit)
            ref.acquire(hit)
            row = hit + list(range(next_page[0], next_page[0] + n_full + 1 - len(hit)))
            next_page[0] += n_full + 1 - len(hit)
            owned = port.register(prompt, row)
            assert owned == ref.register(prompt, row)
            held.append(owned)
        elif op < 0.85 and held:
            owned = held.pop(rng.randrange(len(held)))
            port.release(owned)
            ref.release(owned)
        else:
            n = rng.randrange(1, 5)
            assert port.evict(n) == ref.evict(n)
        assert (port.n_nodes, port.n_evictable, port.hits, port.misses) == \
            (ref.n_nodes, ref.n_evictable, ref.hits, ref.misses)
        for page in range(1, next_page[0]):
            assert port.refcount(page) == ref.refcount(page)


def test_make_prefix_store_builds_native_or_raises(monkeypatch):
    """"native" loads build/libprefix_store.so (never native/'s), "python"
    the twin; a native build that fails raises: no fallback."""
    assert isinstance(tps.make_prefix_store("native", 4), tps.NativePrefixStore)
    assert isinstance(tps.make_prefix_store("python", 4), tps.PyPrefixStore)
    assert "prefix_store" in _build.NATIVE
    assert os.path.dirname(_build._native_paths("prefix_store")[1]) == _build.BUILD_DIR
    with pytest.raises(ValueError, match="unknown"):
        tps.make_prefix_store("cuda", 4)
    with pytest.raises(ValueError, match="page_size"):
        tps.make_prefix_store("native", 0)

    def broken(name):
        raise RuntimeError(f"build of {name} failed")

    monkeypatch.setattr(tps, "load_native", broken)
    with pytest.raises(RuntimeError, match="prefix_store"):
        tps.make_prefix_store("native", 4)


# --------------------------------------------------------------------------
# The engine, on the JAX package's prefix workloads (tests/test_prefix_cache.py)
# --------------------------------------------------------------------------

SMALL = dict(vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=64, n_layers=2,
             max_seq=512)
PROMPT_A = [int(x % 61) + 1 for x in range(300)]  # 2 full pages + 44 tail
STATS = ("prefix_nodes", "prefix_hit_pages", "prefix_miss_pages", "pages_free")


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**SMALL)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, TransformerConfig(**SMALL), params_from_jax(jparams, "cpu")


def _engine(params, cfg, prefix_cache, jax_engine=False, **kw):
    kw = {"n_slots": 2, "scheduler": "python", "cache": "paged", "page_size": 128,
          "prefill_chunk": 128, "prefix_cache": prefix_cache, **kw}
    if jax_engine:
        return JaxEngine(params, cfg, **kw)
    return ServingEngine(params, cfg, "cpu", **kw)


def _waves(eng, waves):
    """Each wave's requests submitted together and run; their tokens, and
    the prefix statistics after each wave."""
    tokens, stats = [], []
    for wave in waves:
        rids = [eng.submit(p, b) for p, b in wave]
        out = eng.run()
        tokens.append([out[r].tokens for r in rids])
        stats.append({k: eng.stats().get(k) for k in STATS})
    return tokens, stats


# tests/test_prefix_cache.py's workloads, one after another on one engine:
# A; B extending A's two full pages; A again (an exact repeat still
# computes its last tokens); two concurrent sharers, one finishing long
# after the other
WAVES = [[(PROMPT_A, 8)],
         [(PROMPT_A[:256] + [int(x % 53) + 2 for x in range(60)], 8)],
         [(PROMPT_A, 8)],
         [(PROMPT_A[:256] + [3, 5, 7, 9], 4), (PROMPT_A[:256] + [11, 13], 24)]]


def test_prefix_cache_matches_jax_and_the_cold_engine(lm):
    """JAX tests/test_prefix_cache.py:43-120 on one warm engine: tokens and
    prefix statistics after every wave equal the JAX warm engine's, tokens
    equal the port's cold (no prefix cache) engine's, and the sharers'
    references are all released at the end."""
    jcfg, jparams, cfg, tparams = lm
    warm = _engine(tparams, cfg, True)
    got, stats = _waves(warm, WAVES)
    want, jstats = _waves(_engine(jparams, jcfg, True, jax_engine=True), WAVES)
    cold, _ = _waves(_engine(tparams, cfg, False), WAVES)
    assert got == want == cold
    assert stats == jstats
    assert stats[0]["prefix_nodes"] == 2 and stats[1]["prefix_hit_pages"] >= 2
    store = warm._prefix_stores[0]
    chain = store.lookup(PROMPT_A[:256])
    assert len(chain) == 2 and all(store.refcount(p) == 0 for p in chain)
    # nothing live: every page is free or cached in the store
    assert stats[-1]["pages_free"] + stats[-1]["prefix_nodes"] == warm.caches[0].n_pages - 1


def test_eviction_under_pool_pressure_matches_jax(lm):
    """JAX tests/test_prefix_cache.py:123: a pool of 4 usable pages; A caches
    2 of them, an unrelated prompt C needs 3, so the store evicts. Tokens
    equal the cold engine's and the JAX engine's, statistics JAX's."""
    jcfg, jparams, cfg, tparams = lm
    prompt_c = [int(x % 47) + 4 for x in range(290)]
    waves = [[(PROMPT_A, 8)], [(prompt_c, 8)]]
    kw = {"n_slots": 1, "n_pages": 5}
    got, stats = _waves(_engine(tparams, cfg, True, **kw), waves)
    want, jstats = _waves(_engine(jparams, jcfg, True, jax_engine=True, **kw), waves)
    cold, _ = _waves(_engine(tparams, cfg, False, **kw), waves)
    assert got == want == cold and stats == jstats
    assert stats[0]["prefix_nodes"] == 2 and stats[0]["pages_free"] == 2
    assert stats[1]["prefix_nodes"] >= 2


def test_prefix_cache_with_native_components(lm):
    """JAX tests/test_prefix_cache.py:150: scheduler="native" builds the C++
    scheduler, pager and prefix store (no fallback) and serves the tokens
    and statistics of the Python twins."""
    _, _, cfg, tparams = lm
    waves = WAVES[:2]
    nat = _engine(tparams, cfg, True, scheduler="native")
    assert isinstance(nat._prefix_stores[0], tps.NativePrefixStore)
    assert _waves(nat, waves) == _waves(_engine(tparams, cfg, True), waves)


@pytest.mark.parametrize("options", [{}, {"kv_quant": "int4"}, {"spec_decode": 3}], ids=str)
def test_prefix_hit_rounds_to_the_chunk_grid(lm, options):
    """With chunks of 256 and pages of 128, a cached chain of 3 pages is
    used as 2 (the chunk grid); the tail prefill starts at 256, tokens equal
    the cold engine's: on the paged int8 and int4 pools, and with spec
    decoding (whose table rows are wider than the pool's rows)."""
    _, _, cfg, tparams = lm
    prompt = [int(x % 59) + 1 for x in range(420)]
    waves = [[(prompt, 4)], [(prompt[:400] + [7, 7, 7], 4)]]
    warm = _engine(tparams, cfg, True, prefill_chunk=256, **options)
    starts = []
    real = warm._start_chunked_prefill

    def spy(rid, slot, prompt):
        starts.append(warm._slot_prefix[slot])
        return real(rid, slot, prompt)

    warm._start_chunked_prefill = spy
    got, stats = _waves(warm, waves)
    cold, _ = _waves(_engine(tparams, cfg, False, prefill_chunk=256, **options), waves)
    assert got == cold
    assert starts == [0, 256] and stats[0]["prefix_nodes"] == 3


def test_prefix_cache_requires_paged_and_chunked(lm):
    jcfg, jparams, cfg, tparams = lm
    for eng, args in ((JaxEngine, (jparams, jcfg)), (ServingEngine, (tparams, cfg, "cpu"))):
        with pytest.raises(ValueError, match="paged"):
            eng(*args, cache="slotted", prefill_chunk=128, prefix_cache=True,
                scheduler="python")
        with pytest.raises(ValueError, match="prefill_chunk"):
            eng(*args, cache="paged", prefix_cache=True, scheduler="python")
