"""PyTorch port vs the JAX package: the serving slice end to end.

A small LM (vocab 64, d_model 128, 4 q / 2 kv heads, head_dim 64, 2 layers,
max_seq 128) is initialised in JAX and carried over with params_from_jax, so
both packages compute the same function. The port runs on CPU tensors,
i.e. through its kernels' plain versions.

Anchors: prefill logits and cache, teacher-forced decode logits against the
JAX package; the serving engine's tokens against the port's own `generate`
(the same anchor as tests/test_serving.py); the native scheduler against its
Python twin.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu.quantize.weights import embedding_lookup as j_embed
from quantizedattention_tpu.quantize.weights import mm as j_mm
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    decode_horizon_batched,
    decode_step_batched,
    generate,
    init_transformer,
    params_from_jax,
    prefill_batched,
    prefill_slot,
    prefill_slots,
    sample_token,
    transformer_forward,
)
from quantizedattention_tpu_torch.models.transformer import _decode_logits
from quantizedattention_tpu_torch.parallel.kv_cache import QuantizedKVCache, init_kv_cache
from quantizedattention_tpu_torch.quantize.weights import QuantizedWeight, QuantizedWeight4
from quantizedattention_tpu_torch.serve import PyScheduler, ServingEngine
from quantizedattention_tpu_torch.serve.scheduler import (
    DECODE,
    IDLE,
    PREFILL,
    NativeScheduler,
    make_scheduler,
)

torch.set_num_threads(2)

CFG = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
           n_layers=2, max_seq=128)
# Logits differ by the attention's bf16-P rounding (see test_torch_kernels)
# carried through two layers; random-init logits are O(1).
LOGIT_TOL = 2e-2
# argmax is compared only where the JAX top-2 gap exceeds this: closer pairs
# can flip on the last bits, as greedy serving tie-flips do in the JAX package.
GAP = 1e-2


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**CFG)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, TransformerConfig(**CFG), params_from_jax(jparams, "cpu")


def _clear_top(logits):
    """Rows whose top-2 logit gap exceeds GAP (argmax is unambiguous)."""
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > GAP


def _assert_same_argmax(tokens, jax_logits):
    jl = np.asarray(jax_logits)
    clear = _clear_top(jl)
    assert clear.mean() >= 0.5  # not vacuous
    np.testing.assert_array_equal(np.asarray(tokens)[clear], jl.argmax(-1)[clear])


def _assert_caches_close(tcaches, jcaches):
    # layer 0's K/V come from identical f32 arithmetic: byte-equal payloads
    # except rounding ties; deeper layers inherit the attention's bf16 noise,
    # so they are compared dequantized
    t0, j0 = tcaches[0], jcaches[0]
    diff = np.abs(t0.k_i8.numpy().astype(np.int32) - np.asarray(j0.k_i8, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    for tc, jc in zip(tcaches, jcaches):
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        for p, s, jp, js in ((tc.k_i8, tc.sk, jc.k_i8, jc.sk), (tc.v_i8, tc.sv, jc.v_i8, jc.sv)):
            got = p.float().numpy() * s.numpy()[..., None]
            want = np.asarray(jp, np.float32) * np.asarray(js)[..., None]
            assert np.abs(got - want).max() <= 3e-2


def test_init_transformer_shapes_match_jax(lm):
    jcfg, jparams, cfg, _ = lm
    tparams = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    flat_t = [tparams["embed"], tparams["unembed"], tparams["final_norm"]]
    flat_j = [jparams["embed"], jparams["unembed"], jparams["final_norm"]]
    for lt, lj in zip(tparams["layers"], jparams["layers"]):
        assert lt.keys() == lj.keys()
        flat_t += [lt[k] for k in lj]
        flat_j += [lj[k] for k in lj]
    for t, j in zip(flat_t, flat_j):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        assert float(t.float().std()) == pytest.approx(float(jnp.std(j)), rel=0.2, abs=1e-6)


def test_forward_and_prefill_batched_match_jax(lm):
    jcfg, jparams, cfg, tparams = lm
    prompt = np.random.default_rng(0).integers(0, 64, (2, 24), dtype=np.int32)
    jl = jtr.transformer_forward(jparams, jnp.asarray(prompt), jcfg)
    tl = transformer_forward(tparams, torch.from_numpy(prompt).long(), cfg)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL

    jcaches = [jkv.init_kv_cache(2, 2, 128, 64) for _ in range(2)]
    jtok, jcaches = jtr.prefill_batched(jparams, jcaches, jnp.asarray(prompt), jcfg)
    tcaches = [init_kv_cache(2, 2, 128, 64, "cpu") for _ in range(2)]
    ttok, tcaches = prefill_batched(tparams, tcaches, torch.from_numpy(prompt).long(), cfg)
    _assert_caches_close(tcaches, jcaches)
    _assert_same_argmax(ttok.numpy(), np.asarray(jl)[:, -1])
    np.testing.assert_array_equal(np.asarray(jtok), np.asarray(jl)[:, -1].argmax(-1))


def _jax_decode_logits(params, caches, last_tok, pos, active, cfg):
    """decode_step_batched (JAX package, models/transformer.py) up to its
    logits, composed of the JAX package's own functions."""
    x = j_embed(params["embed"], last_tok)[:, None, :]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = jtr.rmsnorm(x, layer["ln1"])
        q, k, v = jtr._project_qkv(layer, h, cfg, pos[:, None])
        cache = jkv.append_kv(cache, k, v, active=active)
        o = jkv.decode_attention(q[:, :, 0, :], cache)
        o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim)
        x = jtr._mlp_residual(layer, x + j_mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    x = jtr.rmsnorm(x, params["final_norm"])
    return j_mm(x[:, 0], params["unembed"]), new_caches


def test_teacher_forced_decode_matches_jax(lm):
    jcfg, jparams, cfg, tparams = lm
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 64, (2, 20), dtype=np.int32)
    forced = rng.integers(0, 64, (6, 2), dtype=np.int32)
    actives = [[True, True]] * 3 + [[True, False]] + [[True, True]] * 2
    jcaches = [jkv.init_kv_cache(2, 2, 128, 64) for _ in range(2)]
    _, jcaches = jtr.prefill_batched(jparams, jcaches, jnp.asarray(prompt), jcfg)
    tcaches = [init_kv_cache(2, 2, 128, 64, "cpu") for _ in range(2)]
    _, tcaches = prefill_batched(tparams, tcaches, torch.from_numpy(prompt).long(), cfg)
    pos = np.full((2,), 20, np.int32)
    tokens, logits = [], []
    for step, (tok, act) in enumerate(zip(forced, actives)):
        act = np.asarray(act)
        if step == 0:  # the helper mirrors the JAX package's decode step
            jtok, _ = jtr.decode_step_batched(
                jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(act), jcfg)
        jl, jcaches = _jax_decode_logits(
            jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(act), jcfg)
        if step == 0:
            np.testing.assert_array_equal(np.asarray(jtok), np.asarray(jl).argmax(-1))
        tl, tcaches = _decode_logits(
            tparams, tcaches, torch.from_numpy(tok).long(), torch.from_numpy(pos).long(),
            torch.from_numpy(act), cfg)
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL, f"step {step}"
        tokens.append(tl.argmax(-1).numpy())
        logits.append(np.asarray(jl))
        pos = pos + act
    _assert_same_argmax(np.concatenate(tokens), np.concatenate(logits))
    _assert_caches_close(tcaches, jcaches)


def test_decode_step_and_horizon_are_the_chained_logits(lm):
    _, _, cfg, tparams = lm
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (3, 10))).long()

    def prefilled():
        caches = [init_kv_cache(3, 2, 128, 64, "cpu") for _ in range(2)]
        return prefill_batched(tparams, caches, prompt, cfg)

    active = torch.tensor([True, False, True])
    tok, caches = prefilled()
    pos = torch.full((3,), 10)
    want = []
    for _ in range(4):
        tok, caches = decode_step_batched(tparams, caches, tok, pos, active, cfg)
        want.append(tok)
        pos = pos + active.long()
    tok0, caches = prefilled()
    bank, caches, last, pos_h = decode_horizon_batched(
        tparams, caches, tok0, torch.full((3,), 10), active, cfg, horizon=4)
    torch.testing.assert_close(bank, torch.stack(want), rtol=0, atol=0)
    assert torch.equal(last, want[-1]) and torch.equal(pos_h, pos)
    assert caches[0].length.tolist() == [14, 10, 14]


def test_prefill_slot_and_slots_match_jax(lm):
    jcfg, jparams, cfg, tparams = lm
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, n, dtype=np.int32) for n in (20, 9)]
    padded = np.zeros((2, 32), np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
    # JAX: one request per call into slots 1 and 0
    jcaches = [jkv.init_kv_cache(2, 2, 128, 64) for _ in range(2)]
    for i, slot in ((0, 1), (1, 0)):
        _, jcaches = jtr.prefill_slot(jparams, jcaches, jnp.asarray(padded[i]),
                                      jnp.int32(len(prompts[i])), jnp.int32(slot), jcfg)
    jl = np.asarray(jtr.transformer_forward(jparams, jnp.asarray(padded), jcfg))
    want_logits = np.stack([jl[i, len(p) - 1] for i, p in enumerate(prompts)])
    # port, one call per request
    single = [init_kv_cache(2, 2, 128, 64, "cpu") for _ in range(2)]
    toks = []
    for i, slot in ((0, 1), (1, 0)):
        tok, single = prefill_slot(tparams, single, torch.from_numpy(padded[i]).long(),
                                   len(prompts[i]), slot, cfg)
        toks.append(int(tok))
    _assert_caches_close(single, jcaches)
    _assert_same_argmax(np.asarray(toks), want_logits)
    # port, both requests in one batched call
    batched = [init_kv_cache(2, 2, 128, 64, "cpu") for _ in range(2)]
    btoks, batched = prefill_slots(
        tparams, batched, torch.from_numpy(padded).long(), torch.tensor([20, 9]),
        torch.tensor([1, 0]), cfg)
    assert btoks.tolist() == toks
    for a, b in zip(single, batched):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


# --------------------------------------------------------------------------
# Serving engine
# --------------------------------------------------------------------------

PROMPTS = [[1, 2, 3], [10, 20, 30, 40, 50, 60, 7], [5] * 12, [63, 0, 42, 17],
           [9, 8, 7, 6, 5, 4, 3, 2, 1]]
BUDGETS = [4, 7, 3, 6, 5]


@pytest.mark.parametrize("scheduler,horizon", [("native", 1), ("python", 3)])
def test_engine_continuous_batching_matches_generate(lm, scheduler, horizon):
    """5 requests on 2 slots: every request's tokens equal its own
    single-request `generate` run."""
    _, _, cfg, tparams = lm
    eng = ServingEngine(tparams, cfg, "cpu", n_slots=2, scheduler=scheduler,
                        decode_horizon=horizon)
    rids = [eng.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    results = eng.run()
    assert len(results) == len(PROMPTS)
    for rid, p, b in zip(rids, PROMPTS, BUDGETS):
        want = generate(tparams, torch.tensor([p]), cfg, max_new_tokens=b)
        assert results[rid].tokens == want[0, len(p):].tolist(), f"request {rid} diverged"
        assert results[rid].finish_reason == "length"
    stats = eng.stats()
    assert stats["completed"] == 5 and stats["tokens_generated"] == sum(BUDGETS)
    led = eng.ledger()
    assert led["tokens"] == sum(BUDGETS) and led["dispatches"] >= 2


def test_engine_batched_admission_and_bf16(lm):
    """Requests waiting together are admitted in one batched prefill; with
    bf16 weights the tokens equal `generate` on the same batch."""
    _, _, cfg, tparams = lm
    prompts = [[4, 5, 6, 7], [8, 9, 10, 11], [12, 13, 14, 15]]
    eng = ServingEngine(tparams, cfg, "cpu", n_slots=3, decode_horizon=2,
                        param_dtype=torch.bfloat16)
    streamed = []
    rids = [eng.submit(p, 5, on_token=lambda r, t, d: streamed.append((r, t, d)))
            for p in prompts]
    results = eng.run()
    assert eng.ledger()["dispatches"] == 1 + 2  # one prefill, two banks of 2 decode steps
    want = generate(eng.params, torch.tensor(prompts), cfg, max_new_tokens=5)
    for i, rid in enumerate(rids):
        assert results[rid].tokens == want[i, 4:].tolist()
        assert [t for r, t, _ in streamed if r == rid] == results[rid].tokens
    assert sum(d for _, _, d in streamed) == 3


def test_engine_eos_stops_early(lm):
    _, _, cfg, tparams = lm
    prompt = [1, 2, 3, 4]
    ref = generate(tparams, torch.tensor([prompt]), cfg, max_new_tokens=4)[0, 4:].tolist()
    eos = ref[1]
    eng = ServingEngine(tparams, cfg, "cpu", n_slots=1, eos_id=eos, scheduler="python")
    rid = eng.submit(prompt, max_new_tokens=10)
    res = eng.run()[rid]
    assert res.finish_reason == "eos"
    assert res.tokens == ref[: ref.index(eos) + 1]


def test_engine_sampling_is_seeded(lm):
    _, _, cfg, tparams = lm

    def run(seed):
        eng = ServingEngine(tparams, cfg, "cpu", n_slots=2, temperature=0.8, seed=seed)
        rids = [eng.submit(p, b) for p, b in zip(PROMPTS[:3], BUDGETS[:3])]
        out = eng.run()
        return [out[r].tokens for r in rids]

    first = run(5)
    assert first == run(5)
    assert all(0 <= t < cfg.vocab_size for toks in first for t in toks)
    with pytest.raises(ValueError, match="Generator"):
        generate(tparams, torch.tensor([[1, 2]]), cfg, max_new_tokens=2, temperature=0.5)


def test_engine_rejects_bad_requests(lm):
    _, _, cfg, tparams = lm
    eng = ServingEngine(tparams, cfg, "cpu", n_slots=1, scheduler="python")
    with pytest.raises(ValueError, match="rejected"):
        eng.submit([1] * 100, max_new_tokens=64)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit([1, 64], max_new_tokens=2)


@pytest.mark.parametrize(
    "option,value",
    [("mesh", object()), ("cache", "paged"), ("kv_quant", "int4"),
     ("spec_decode", 2), ("prefix_cache", True), ("prefill_chunk", 128),
     ("adaptive_horizon", 8), ("top_k", 5), ("top_p", 0.9)],
)
def test_engine_unported_options_raise(lm, option, value):
    _, _, cfg, tparams = lm
    with pytest.raises(NotImplementedError, match=option):
        ServingEngine(tparams, cfg, "cpu", **{option: value})


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_engine_weight_quant_is_ported(lm, weight_quant):
    """weight_quant quantizes every projection and the unembedding (and the
    embedding, per row in int8); formats the JAX engine rejects raise."""
    _, _, cfg, tparams = lm
    eng = ServingEngine(tparams, cfg, "cpu", weight_quant=weight_quant)
    want = QuantizedWeight4 if weight_quant == "int4" else QuantizedWeight
    assert all(isinstance(layer[key], want) for layer in eng.params["layers"]
               for key in ("wq", "wk", "wv", "wo", "w1", "w2"))
    assert isinstance(eng.params["unembed"], want)
    assert isinstance(eng.params["embed"], QuantizedWeight) and eng.params["embed"].axis == 0
    with pytest.raises(ValueError, match="weight_quant"):
        ServingEngine(tparams, cfg, "cpu", weight_quant="fp4")


def test_unported_model_paths_raise(lm):
    _, _, cfg, tparams = lm
    with pytest.raises(TypeError, match="unexpected"):
        ServingEngine(tparams, cfg, "cpu", page_size=64)
    # int8 attention prefills, generates and serves
    # (tests/test_torch_int8_inference.py holds them against the JAX package)
    int8_cfg = TransformerConfig(**{**CFG, "attention": "int8"})
    eng = ServingEngine(tparams, int8_cfg, "cpu", n_slots=1, scheduler="python")
    rid = eng.submit([1, 2, 3, 4], max_new_tokens=2)
    want = generate(tparams, torch.tensor([[1, 2, 3, 4]]), int8_cfg, 2)
    assert eng.run()[rid].tokens == want[0, 4:].tolist()


def test_sample_token():
    logits = torch.tensor([[0.0, 3.0, 1.0], [5.0, -1.0, 2.0]])
    assert sample_token(logits).tolist() == [1, 0]
    assert sample_token(logits[0]).item() == 1
    g = torch.Generator().manual_seed(0)
    draws = sample_token(logits.repeat(200, 1), 1.0, g)
    assert draws.shape == (400,) and draws.min() >= 0 and draws.max() <= 2
    hot = torch.tensor([[0.0, 50.0, 0.0]]).repeat(50, 1)
    assert (sample_token(hot, 0.5, g) == 1).all()
    with pytest.raises(ValueError):
        sample_token(logits, -1.0, g)


# --------------------------------------------------------------------------
# Scheduler: native core vs Python twin
# --------------------------------------------------------------------------

def test_scheduler_basic_lifecycle():
    for sched in (PyScheduler(2, 64), NativeScheduler(2, 64)):
        assert sched.next_action()[0] == IDLE
        assert sched.submit(0, prompt_len=8, max_new_tokens=2)
        act, rid, slot = sched.next_action()
        assert (act, rid) == (PREFILL, 0) and slot in (0, 1)
        assert not sched.report_token(slot, False)
        assert sched.next_action()[0] == DECODE
        assert sched.report_token(slot, False)
        assert sched.num_active == 0 and sched.num_completed == 1
        assert sched.next_action()[0] == IDLE
        assert not sched.submit(1, prompt_len=60, max_new_tokens=10)
    with pytest.raises(ValueError):
        make_scheduler("cuda", 2, 64)


def test_scheduler_native_matches_python_differential():
    """Randomized workload: identical action traces from both cores."""
    nat, py = make_scheduler("native", 3, 64), make_scheduler("python", 3, 64)
    rng = random.Random(0)
    next_id = 0
    for _ in range(500):
        if rng.random() < 0.3:
            plen, mnt = rng.randint(1, 40), rng.randint(1, 40)
            assert nat.submit(next_id, plen, mnt) == py.submit(next_id, plen, mnt)
            next_id += 1
        a_n, a_p = nat.next_action(), py.next_action()
        assert a_n == a_p, f"diverged: native={a_n} python={a_p}"
        act, _rid, slot = a_n
        if act == PREFILL:
            if rng.random() < 0.15:
                nat.requeue(slot)
                py.requeue(slot)
                continue
            assert nat.report_token(slot, False) == py.report_token(slot, False)
        elif act == DECODE:
            for s in range(3):
                if py.slot_request(s) >= 0:
                    assert nat.slot_request(s) == py.slot_request(s)
                    eos = rng.random() < 0.1
                    assert nat.report_token(s, eos) == py.report_token(s, eos)
        assert (nat.num_active, nat.num_waiting, nat.num_completed) == (
            py.num_active, py.num_waiting, py.num_completed)


def test_cache_type_is_the_jax_layout():
    c = init_kv_cache(2, 3, 40, 64, "cpu")
    assert isinstance(c, QuantizedKVCache) and c._fields == jkv.QuantizedKVCache._fields
    assert c.k_i8.shape == (2, 3, 40, 64) and c.sk.shape == (2, 3, 40) and c.max_len == 40
    assert (c.k_i8.dtype, c.sk.dtype, c.length.dtype) == (torch.int8, torch.float32, torch.int32)
