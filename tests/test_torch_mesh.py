"""PyTorch port vs the JAX package: the serving mesh's steps on a (2, 2) mesh.

The JAX side runs its shard_map steps on 4 of the 8 emulated CPU devices
(tests/conftest.py) at mesh (data=2, model=2); the port runs the same steps
in 4 gloo ranks (parallel/launch.py:RankPool, spawned once for the module),
each on its own shard (serve/mesh_jobs.py). The same inputs go to both: a
small LM (vocab 128, d_model 128, 4 q heads over 4 or 2 kv heads, head_dim
64, 2 layers, max_seq 256, f32) initialised in JAX and carried over with
params_from_jax, and caches filled by JAX prefills. A rank's outputs are
held against the matching block of JAX's global arrays: rank r sits at
(data r // 2, model r % 2) in both meshes.

Tolerances: logits within LOGIT_TOL (the attention's bf16-P rounding
through two layers, as tests/test_torch_serving.py; the model-axis psum
adds f32 rounding only); argmax tokens equal where JAX's top-2 gap exceeds
GAP; caches as test_torch_serving.py holds prefill (dequantized within
CACHE_TOL and one int8 step of the row, lengths and page tables equal).
tests/test_torch_mesh_chunk.py holds the chunked prefill, context-sharded
decode, sharded attention and the parameter shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu.parallel import make_attention_mesh as j_mesh
from quantizedattention_tpu.parallel import paged_cache as jpc
from quantizedattention_tpu.quantize.weights import embedding_lookup as j_embed
from quantizedattention_tpu.quantize.weights import mm as j_mm
from quantizedattention_tpu.serve import engine as jeng
from quantizedattention_tpu_torch.models import TransformerConfig, params_from_jax
from quantizedattention_tpu_torch.parallel import PagedKVCache, QuantizedKVCache
from quantizedattention_tpu_torch.parallel.launch import RankPool
from quantizedattention_tpu_torch.serve import mesh_jobs
from quantizedattention_tpu_torch.serve.engine import serving_shardings

torch.set_num_threads(2)

LOGIT_TOL = 2e-2
GAP = 1e-2
CACHE_TOL = 3e-2
MESH = (2, 2)
N_SLOTS = 4
PROMPTS = [[int(x) for x in np.random.default_rng(i).integers(1, 128, n)]
           for i, n in enumerate((20, 9, 33, 5))]


def _cfg(n_kv):
    return dict(vocab_size=128, d_model=128, n_heads=4, n_kv_heads=n_kv, head_dim=64,
                n_layers=2, max_seq=256)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


@pytest.fixture(scope="module", params=[4, 2], ids=["4q4kv", "4q2kv"])
def lm(request):
    jcfg = jtr.TransformerConfig(**_cfg(request.param))
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, TransformerConfig(**_cfg(request.param)), params_from_jax(jparams, "cpu")


@pytest.fixture(scope="module")
def jmesh():
    return j_mesh(data=2, model=2, context=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tcaches(jcaches):
    return [type_(*map(_t, c)) for c, type_ in
            zip(jcaches, [QuantizedKVCache if hasattr(c, "k_i8") else PagedKVCache
                          for c in jcaches])]


def _block(a, spec, rank):
    """Rank `rank`'s block of the global array `a` under `spec`."""
    a = np.asarray(a)
    coords = {"data": rank // MESH[1], "model": rank % MESH[1]}
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = MESH[0] if axis == "data" else MESH[1]
        size = a.shape[dim] // n
        index.append(slice(coords[axis] * size, (coords[axis] + 1) * size))
    return a[tuple(index)]


def _deq(cache):
    """The dequantized K and V of a (numpy) cache and their scales, per
    token row: [(values, scales broadcast to them)] for K and V."""
    if hasattr(cache, "k_i8"):
        pairs, order = ((cache.k_i8, cache.sk), (cache.v_i8, cache.sv)), (0, 1, 2)
    else:
        pairs, order = ((cache.k_pages, cache.sk), (cache.v_pages, cache.sv)), (1, 0, 2)
    return [(np.asarray(p, np.float32) * np.asarray(s).transpose(order)[..., None],
             np.asarray(s).transpose(order)[..., None]) for p, s in pairs]


def _assert_rank_caches(per_rank, jcaches, spec):
    """Every rank's local caches against its block of JAX's global ones."""
    for rank, tcaches in enumerate(per_rank):
        for tc, jc in zip(tcaches, jcaches):
            local = type(tc)(*(_block(x, s, rank) for x, s in zip(jc, spec)))
            for name in ("length", "lengths", "page_table"):
                if hasattr(tc, name):
                    np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                                  getattr(local, name), err_msg=name)
            for (got, s_got), (want, s_want) in zip(_deq(tc), _deq(local)):
                # a K/V entry near a rounding edge may land one int8 step
                # (its row's scale) away under the bf16 noise
                assert np.all(np.abs(got - want) <= CACHE_TOL + np.maximum(s_got, s_want))


def _prefilled(jcfg, jparams, cache="slotted"):
    """JAX caches with PROMPTS prefilled into slots 0-3 (one device), and
    the decode state: last tokens, positions, active."""
    if cache == "paged":
        pages = -(-jcfg.max_seq // 128)
        per_shard = 1 + (N_SLOTS // MESH[0]) * pages
        caches = [jpc.init_paged_cache(jcfg.n_kv_heads, per_shard * MESH[0], N_SLOTS, pages,
                                       jcfg.head_dim) for _ in range(jcfg.n_layers)]
        for slot in range(N_SLOTS):  # shard-local ids: each shard's pages 1..pages
            row = jnp.asarray([1 + (slot % 2) * pages + i for i in range(pages)], jnp.int32)
            caches = [jpc.assign_pages(c, jnp.int32(slot), row) for c in caches]
    else:
        caches = [jkv.init_kv_cache(N_SLOTS, jcfg.n_kv_heads, jcfg.max_seq, jcfg.head_dim)
                  for _ in range(jcfg.n_layers)]
    toks = []
    for slot, p in enumerate(PROMPTS):
        pad = -(-len(p) // 128) * 128 if cache == "paged" else 64
        tok, caches = jtr.prefill_slot(jparams, caches, jnp.asarray(p + [0] * (pad - len(p))),
                                       jnp.int32(len(p)), jnp.int32(slot), jcfg)
        toks.append(int(tok))
    state = (np.asarray(toks, np.int32), np.asarray([len(p) for p in PROMPTS], np.int32),
             np.asarray([True, True, False, True]))
    return caches, state


def _put(jmesh, jcfg, jparams, jcaches, state, cache="slotted", weight_quant=None):
    pshard, cshard, vshard = jeng.serving_shardings(jmesh, jcfg, cache, weight_quant)
    return (jax.device_put(jparams, pshard), jax.device_put(jcaches, cshard),
            *(jax.device_put(jnp.asarray(x), vshard) for x in state))


def _jax_decode_logits(params, caches, last_tok, pos, active, cfg):
    """The JAX package's decode step up to its logits (one device)."""
    x = j_embed(params["embed"], last_tok)[:, None, :]
    for layer, cache in zip(params["layers"], caches):
        h = jtr.rmsnorm(x, layer["ln1"])
        q, k, v = jtr._project_qkv(layer, h, cfg, pos[:, None])
        cache = jkv.append_kv(cache, k, v, active=active)
        o = jkv.decode_attention(q[:, :, 0, :], cache)
        o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim)
        x = jtr._mlp_residual(layer, x + j_mm(o.astype(x.dtype), layer["wo"]))
    return j_mm(jtr.rmsnorm(x, params["final_norm"])[:, 0], params["unembed"])


def _clear(jlogits):
    top2 = np.sort(np.asarray(jlogits, np.float32), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > GAP


def _state(state):
    return tuple(torch.from_numpy(x).long() if x.dtype != bool else torch.from_numpy(x)
                 for x in state)


@pytest.mark.parametrize("horizon", [1, 3])
def test_sharded_decode_step_and_horizon_match_jax(pool, lm, jmesh, horizon):
    """make_sharded_decode_step: one step's logits (gathered over data)
    against JAX's within LOGIT_TOL, the tokens (or the bank of `horizon`
    steps) equal to JAX's shard_map step, every rank's caches its block of
    JAX's."""
    jcfg, jparams, cfg, tparams = lm
    jcaches, state = _prefilled(jcfg, jparams)
    jstep = jeng.make_sharded_decode_step(jmesh, jcfg, horizon=horizon)
    jout = jstep(*_put(jmesh, jcfg, jparams, jcaches, state))
    tstate = _state(state)
    outs = pool.run(mesh_jobs.mesh_steps, "decode", cfg, MESH, tparams, _tcaches(jcaches),
                    [tstate], horizon=horizon, device_type="cpu")
    spec = serving_shardings(cfg)[1][0]
    if horizon == 1:
        jl = np.asarray(_jax_decode_logits(jparams, jcaches, *map(jnp.asarray, state), jcfg))
        logits = pool.run(mesh_jobs.mesh_steps, "decode_logits", cfg, MESH, tparams,
                          _tcaches(jcaches), [tstate], device_type="cpu")
        for (got,), _ in logits:
            got = got[0].numpy()
            assert np.abs(got - jl).max() <= LOGIT_TOL
            assert np.array_equal(got, logits[0][0][0][0].numpy())  # the same on every rank
        clear = _clear(jl)
        assert clear.mean() >= 0.5
        np.testing.assert_array_equal(outs[0][0][0][0].numpy()[clear], jl.argmax(-1)[clear])
        np.testing.assert_array_equal(outs[0][0][0][0].numpy(), np.asarray(jout[0]))
    else:
        bank, _, last, pos = jout
        got_bank, got_last, got_pos = outs[0][0][0]
        np.testing.assert_array_equal(got_bank.numpy(), np.asarray(bank))
        np.testing.assert_array_equal(got_last.numpy(), np.asarray(last))
        np.testing.assert_array_equal(got_pos.numpy(), np.asarray(pos))
    for (out, _) in outs[1:]:  # every rank hands back the same full outputs
        for a, b in zip(out[0], outs[0][0][0]):
            assert torch.equal(a, b)
    _assert_rank_caches([c for _, c in outs], jout[1], spec)


def test_sharded_prefill_slot_matches_jax(pool, lm, jmesh):
    """make_sharded_prefill_slot into slots 1 (data shard 0) and 2 (shard
    1): first tokens equal JAX's, and only the owning shard's cache rows are
    written, as in JAX."""
    jcfg, jparams, cfg, tparams = lm
    jcaches = [jkv.init_kv_cache(N_SLOTS, jcfg.n_kv_heads, jcfg.max_seq, jcfg.head_dim)
               for _ in range(jcfg.n_layers)]
    tcaches = _tcaches(jcaches)
    jfill = jeng.make_sharded_prefill_slot(jmesh, jcfg)
    pshard, cshard, _ = jeng.serving_shardings(jmesh, jcfg)
    jp, jc = jax.device_put(jparams, pshard), jax.device_put(jcaches, cshard)
    calls, want = [], []
    for slot, p in ((1, PROMPTS[0]), (2, PROMPTS[2])):
        tokens = p + [0] * (64 - len(p))
        tok, jc = jfill(jp, jc, jnp.asarray(tokens), jnp.int32(len(p)), jnp.int32(slot))
        want.append(int(tok))
        calls.append((torch.tensor(tokens), len(p), slot))
    outs = pool.run(mesh_jobs.mesh_steps, "prefill", cfg, MESH, tparams, tcaches, calls,
                    device_type="cpu")
    for out, _ in outs:
        assert [int(o[0]) for o in out] == want
    _assert_rank_caches([c for _, c in outs], jc, serving_shardings(cfg)[1][0])


def test_sharded_verify_step_matches_jax(pool, lm, jmesh):
    """make_sharded_verify_step: 3 drafts a slot (two of them the greedy
    continuation where it is clear), packed emitted tokens and n_emit,
    last tokens, positions and rolled-back caches equal JAX's."""
    jcfg, jparams, cfg, tparams = lm
    jcaches, state = _prefilled(jcfg, jparams)
    draft = np.random.default_rng(5).integers(1, 128, (N_SLOTS, 3)).astype(np.int32)
    jstep = jeng.make_sharded_verify_step(jmesh, jcfg)
    put = _put(jmesh, jcfg, jparams, jcaches, state)
    jout = jstep(*put[:3], jnp.asarray(draft), *put[3:])
    last, pos, active = _state(state)
    outs = pool.run(mesh_jobs.mesh_steps, "verify", cfg, MESH, tparams, _tcaches(jcaches),
                    [(last, torch.from_numpy(draft).long(), pos, active)], device_type="cpu")
    for out, _ in outs:
        packed, got_last, got_pos = out[0]
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(got_last.numpy(), np.asarray(jout[2]))
        np.testing.assert_array_equal(got_pos.numpy(), np.asarray(jout[3]))
    _assert_rank_caches([c for _, c in outs], jout[1], serving_shardings(cfg)[1][0])


def test_cache_specs_match_jax(lm, jmesh):
    """serving_shardings' cache specs name the same axes as the JAX
    package's, field by field, for every cache kind."""
    jcfg, _, cfg, _ = lm
    for cache in ("slotted", "paged"):
        for kv_quant in (None, "int4"):
            tspec = serving_shardings(cfg, cache, None, kv_quant)[1][0]
            jspec = jeng.serving_shardings(jmesh, jcfg, cache, None, kv_quant)[1][0]
            assert type(tspec).__name__ == type(jspec).__name__
            for got, want in zip(tspec, jspec):
                assert tuple(got) == tuple(want.spec)
