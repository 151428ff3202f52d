"""The port's mesh serving engine against its one-device engine.

ServingEngine(mesh=make_attention_mesh(data=2, model=2)) runs in 4 gloo
ranks (parallel/launch.py:RankPool, spawned once for the module; each rank
serves through serve/mesh_jobs.py:serve) on the same f32 LM (vocab 128,
d_model 128, 4 q / 4 kv heads, head_dim 64, 2 layers) and the same
requests as the one-device engine in this process. The rule is the JAX
package's (tests/test_serving.py:244, :342, :369,
tests/test_int8_weights.py:252): greedy tokens equal on every request, here
on every cache kind and option, and every rank records the same tokens.
Sampling under a mesh keys each draw by (seed, global slot, position): a
seeded run gives the same tokens at data=1 (model=4) and data=2 (model=2),
and top_k=1 gives the greedy tokens (tests/test_sampling.py:168). The
options a mesh cannot take raise ValueError on every rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quantizedattention_tpu_torch.models import TransformerConfig, init_transformer
from quantizedattention_tpu_torch.parallel.launch import RankPool
from quantizedattention_tpu_torch.serve import ServingEngine, mesh_jobs

torch.set_num_threads(2)

CFG = TransformerConfig(vocab_size=128, d_model=128, n_heads=4, n_kv_heads=4, head_dim=64,
                        n_layers=2, max_seq=256)
LONG = dataclasses.replace(CFG, max_seq=512)  # room for chunked and prefix prompts
PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [2, 4], [7] * 20, [3, 1, 4, 1, 5, 9, 2, 6]]
BUDGETS = [5, 4, 6, 3, 7, 5]
CHUNK_PROMPTS = [([3, 1, 4, 1, 5] * 70)[:330], [9, 8, 7], [5] * 200, [2, 4]]
CHUNK_BUDGETS = [5, 4, 6, 3]
# two requests share 256 prompt tokens (two pages, two chunks) beyond which
# they differ; served twice, the second wave hits the prefix store
SHARED = [int(x) for x in np.random.default_rng(3).integers(1, 128, 256)]
PREFIX_PROMPTS = [SHARED + [11, 12, 13], SHARED + [21, 22], [7, 7, 7]]
PREFIX_BUDGETS = [6, 5, 4]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


@pytest.fixture(scope="module")
def params():
    return init_transformer(CFG, torch.Generator().manual_seed(2), "cpu")


def _one_device(params, cfg, prompts, budgets, runs=1, **kw):
    eng = ServingEngine(params, cfg, "cpu", n_slots=4, scheduler="python", **kw)
    out = []
    for _ in range(runs):
        rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        res = eng.run()
        out.append([res[r].tokens for r in rids])
    return out, eng.stats()


def _mesh(pool, params, cfg, prompts, budgets, shape=(2, 2), runs=1, **kw):
    outs = pool.run(mesh_jobs.serve, cfg, shape, prompts, budgets, params=params, runs=runs,
                    device_type="cpu", n_slots=4, scheduler="python", **kw)
    for o in outs[1:]:
        assert o["tokens"] == outs[0]["tokens"]  # every rank records the same tokens
    return outs[0]


@pytest.mark.parametrize("options", [
    {}, {"decode_horizon": 3}, {"cache": "paged", "decode_horizon": 4},
    {"kv_quant": "int4"}, {"cache": "paged", "kv_quant": "int4", "adaptive_horizon": 4},
    {"weight_quant": "int8"}, {"spec_decode": 2}, {"cache": "paged", "spec_decode": 3},
], ids=["slotted", "horizon3", "paged_h4", "kv4", "paged4_adaptive", "w8", "spec2",
        "paged_spec3"])
def test_mesh_engine_matches_one_device(pool, params, options):
    want, stats = _one_device(params, CFG, PROMPTS, BUDGETS, **options)
    got = _mesh(pool, params, CFG, PROMPTS, BUDGETS, **options)
    assert got["tokens"] == want
    if options.get("cache") == "paged":  # every page back in both shards' pools
        assert got["stats"]["pages_free"] == stats["pages_free"] == 2 * 2 * 2
    if options.get("spec_decode"):
        assert got["stats"]["spec"]["steps"] > 0


@pytest.mark.parametrize("cache", ["slotted", "paged"])
def test_mesh_engine_chunked_prefill_matches_one_device(pool, params, cache):
    """Chunked prefill under the mesh (the owner-masked psum over data):
    tokens equal the one-device unchunked engine's, as
    tests/test_serving.py:342."""
    want, _ = _one_device(params, LONG, CHUNK_PROMPTS, CHUNK_BUDGETS)
    got = _mesh(pool, params, LONG, CHUNK_PROMPTS, CHUNK_BUDGETS, cache=cache,
                prefill_chunk=128, decode_horizon=2 if cache == "paged" else 1)
    assert got["tokens"] == want


def test_mesh_engine_prefix_cache_matches_one_device(pool, params):
    """Per-shard prefix stores: two waves of the same requests; the second
    hits cached pages in its shard's store, and every token equals the
    one-device prefix engine's and the cold run's."""
    kw = dict(cache="paged", prefill_chunk=128, prefix_cache=True)
    want, stats = _one_device(params, LONG, PREFIX_PROMPTS, PREFIX_BUDGETS, runs=2, **kw)
    got = _mesh(pool, params, LONG, PREFIX_PROMPTS, PREFIX_BUDGETS, runs=2, **kw)
    assert got["tokens"] == want and want[0] == want[1]
    assert got["stats"]["prefix_hit_pages"] > 0 and stats["prefix_hit_pages"] > 0


def test_mesh_sampling_is_keyed_by_global_slot(pool, params):
    """A seeded sampled run (top-k / top-p filtered) gives the same tokens
    at data=1 (model=4) and data=2 (model=2): each draw depends on (seed,
    global slot, position), not on how the slots are split; another seed
    differs; top_k=1 at temperature 1 gives the greedy tokens."""
    kw = dict(temperature=1.0, top_k=16, top_p=0.9, seed=5)
    wide = _mesh(pool, params, CFG, PROMPTS, BUDGETS, shape=(1, 4), **kw)
    split = _mesh(pool, params, CFG, PROMPTS, BUDGETS, shape=(2, 2), **kw)
    other = _mesh(pool, params, CFG, PROMPTS, BUDGETS, **{**kw, "seed": 6})
    assert wide["tokens"] == split["tokens"] != other["tokens"]
    assert all(0 <= t < CFG.vocab_size for toks in split["tokens"][0] for t in toks)
    top1 = _mesh(pool, params, CFG, PROMPTS, BUDGETS, temperature=1.0, top_k=1, seed=5)
    greedy = _mesh(pool, params, CFG, PROMPTS, BUDGETS)
    assert top1["tokens"] == greedy["tokens"]


def test_dryrun_serving_twin_matches_one_device(pool):
    """mesh_jobs.dryrun_serving (the serving half of the JAX package's
    dryrun_multichip, which chip_smoke.py runs on the card) on the CPU: its
    two sharded greedy decode steps give the one-device decode steps'
    tokens, its sharded verify the one-device verify's emitted tokens and
    n_emit, its int8-weight steps over the int4 cache tokens in vocab, and
    every rank the same outputs."""
    from quantizedattention_tpu_torch.models.transformer import (
        decode_step_batched,
        prefill_batched,
        verify_step_batched,
    )
    from quantizedattention_tpu_torch.parallel.kv_cache import init_kv_cache

    outs = pool.run(mesh_jobs.dryrun_serving, "cpu")
    cfg = TransformerConfig(vocab_size=128, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                            n_layers=2, max_seq=256)
    params = init_transformer(cfg, torch.Generator().manual_seed(10), "cpu")
    n_slots = 2 * outs[0]["shape"][0]
    prompt = torch.randint(0, cfg.vocab_size, (n_slots, 16),
                           generator=torch.Generator().manual_seed(11))
    caches = [init_kv_cache(n_slots, 2, cfg.max_seq, 64, "cpu") for _ in range(cfg.n_layers)]
    tok, caches = prefill_batched(params, caches, prompt, cfg)
    pos, active = torch.full((n_slots,), 16), torch.ones((n_slots,), dtype=torch.bool)
    toks = []
    for _ in range(2):
        tok, caches = decode_step_batched(params, caches, tok, pos, active, cfg)
        toks.append(tok)
        pos = pos + 1
    emitted, n_emit, _ = verify_step_batched(params, caches, tok, torch.arange(3).repeat(
        n_slots, 1), pos, active, cfg)
    for out in outs:
        assert torch.equal(out["decode"], torch.stack(toks))
        assert torch.equal(out["verify"], torch.cat([emitted, n_emit[:, None]], dim=1))
        assert ((out["quantized"] >= 0) & (out["quantized"] < cfg.vocab_size)).all()
        assert torch.equal(out["quantized"], outs[0]["quantized"])


@pytest.mark.parametrize("shape,cfg,kw,match", [
    ((2, 2), CFG, {"weight_quant": "int4"}, "int4"),
    ((1, 4), dataclasses.replace(CFG, n_kv_heads=2), {}, "model axis"),
    ((2, 2), CFG, {"n_slots": 3}, "data axis"),
], ids=["int4_weights", "kv_heads", "slots"])
def test_mesh_engine_rejects(pool, params, shape, cfg, kw, match):
    """The JAX engine's ValueErrors under a mesh, on every rank."""
    p = params if cfg is CFG else init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    errors = pool.run(mesh_jobs.engine_error, p, cfg, shape, "cpu", **kw)
    assert all(e is not None and match in e for e in errors), errors
