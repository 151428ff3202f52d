"""PyTorch port vs the JAX package: the serving mesh's chunked prefill,
context-sharded decode, sharded attention and parameter shards.

The second half of tests/test_torch_mesh.py, whose LM, inputs, rank
layout and tolerances it shares (imported from there): the JAX side on 4 of
the 8 emulated CPU devices, the port in 4 gloo ranks of its own pool.
Tolerances: caches and tokens as there; context_sharded_decode within
DECODE_TOL of JAX's and of the one-device decode (each shard's P is
rounded to bf16 against its own max); sharded attention within ATTN_TOL of
JAX's by kind and, for the bf16 gradients, GRAD_REL_L2; int8 weight shards
byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from quantizedattention_tpu.models.sharded_train import param_specs as j_param_specs
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu.parallel import make_attention_mesh as j_mesh
from quantizedattention_tpu.parallel import paged_cache as jpc
from quantizedattention_tpu.parallel.sharded import make_sharded_attention as j_sharded_attention
from quantizedattention_tpu.quantize.weights import quantize_lm_specs as j_quant_specs
from quantizedattention_tpu.quantize.weights import quantize_lm_weights as j_quant_weights
from quantizedattention_tpu.serve import engine as jeng
from quantizedattention_tpu_torch.parallel import QuantizedKVCache
from quantizedattention_tpu_torch.parallel.kv_cache import decode_attention_plain
from quantizedattention_tpu_torch.quantize.weights import QuantizedWeight
from quantizedattention_tpu_torch.serve import mesh_jobs
from quantizedattention_tpu_torch.serve.engine import serving_shardings
from tests.test_torch_mesh import (  # noqa: F401 (the fixtures)
    MESH,
    _assert_rank_caches,
    _block,
    _prefilled,
    _t,
    _tcaches,
    jmesh,
    lm,
    pool,
)

torch.set_num_threads(2)

# sharded attention vs JAX's on the same blocks: B1 bf16 (O 5e-3, as
# test_torch_kernels.py), the int8 path (its per-block quantization rounds
# alike on both sides; O within 2e-2 of O's unit scale), B1 fp32 (1e-4)
ATTN_TOL = {"bf16": 5e-3, "int8": 2e-2, "jvp": 1e-4}
# the bf16 backward (B2/B3 fast mode rounds every product's operands to
# bf16; JAX's runs in f32 on the CPU): relative L2 per block, as
# tests/test_torch_train.py holds fast mode
GRAD_REL_L2 = 1e-2
DECODE_TOL = 5e-3


@pytest.mark.parametrize("cache", ["slotted", "paged"])
def test_sharded_prefill_chunk_matches_jax(pool, lm, jmesh, cache):
    """make_sharded_prefill_chunk: a 300-token prompt in chunks of 128 into
    slot 3 (data shard 1): the owner merges the prefix and the masked psum
    over data hands its output to shard 0. The last chunk's token and every
    rank's caches against JAX's."""
    jcfg, jparams, cfg, tparams = lm
    jcaches, _ = _prefilled(jcfg, jparams, cache)
    if cache == "paged":  # slot 3 starts afresh on its own pages
        pages = -(-jcfg.max_seq // 128)
        row = jnp.asarray([1 + pages + i for i in range(pages)], jnp.int32)
        jcaches = [jpc.assign_pages(c, jnp.int32(3), row) for c in jcaches]
    else:
        jcaches = [c._replace(length=c.length.at[3].set(0)) for c in jcaches]
    tcaches = _tcaches(jcaches)
    prompt = [int(x) for x in np.random.default_rng(7).integers(1, 128, 300)]
    jchunk = jeng.make_sharded_prefill_chunk(jmesh, jcfg, cache=cache)
    pshard, cshard, _ = jeng.serving_shardings(jmesh, jcfg, cache)
    jp, jc = jax.device_put(jparams, pshard), jax.device_put(jcaches, cshard)
    calls = []
    for i in range(3):
        piece = prompt[i * 128:(i + 1) * 128]
        piece = piece + [0] * (128 - len(piece))
        tok, jc = jchunk(jp, jc, jnp.asarray(piece), i * 128, len(prompt), jnp.int32(3), i == 2)
        calls.append((torch.tensor(piece), i * 128, len(prompt), 3, i == 2))
    outs = pool.run(mesh_jobs.mesh_steps, "chunk", cfg, MESH, tparams, tcaches, calls,
                    cache=cache, device_type="cpu")
    for out, _ in outs:
        assert out[0][0] is None and int(out[2][0]) == int(tok)
    _assert_rank_caches([c for _, c in outs], jc, serving_shardings(cfg, cache)[1][0])


@pytest.mark.parametrize("context", [2, 4])
def test_context_sharded_decode_matches_jax(pool, context):
    """context_sharded_decode: B13 with its lse on each rank's token slice,
    merged by lse_weighted_merge over context (the pool's other ranks as
    data replicas), against JAX's on a (1, 1, context) mesh and against the one-device decode over the whole cache;
    rows of length 0 and rows whose tokens lie on one rank only included."""
    rng = np.random.default_rng(context)
    b, h, h_kv, t, d = 4, 8, 2, 512, 64
    k = rng.standard_normal((b, h_kv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, t, d)).astype(np.float32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    cache = jkv.append_kv(jkv.init_kv_cache(b, h_kv, t, d), jnp.asarray(k), jnp.asarray(v))
    cache = cache._replace(length=jnp.asarray([0, 100, 300, 512], jnp.int32))
    jm = j_mesh(data=1, model=1, context=context)
    seq, scale = P(None, None, "context", None), P(None, None, "context")
    fn = jax.shard_map(lambda q, c: jkv.context_sharded_decode(q, c, "context"), mesh=jm,
                       in_specs=(P(), jkv.QuantizedKVCache(seq, scale, seq, scale, P())),
                       out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(q), cache))
    tcache = QuantizedKVCache(*map(_t, cache))
    outs = pool.run(mesh_jobs.context_decode, torch.from_numpy(q), tcache, context, "cpu")
    whole = decode_attention_plain(torch.from_numpy(q), tcache).numpy()
    for got in outs:
        got = got.numpy()
        assert np.isfinite(got).all() and np.all(got[0] == 0)
        assert np.abs(got - want).max() <= DECODE_TOL
        assert np.abs(got - whole).max() <= DECODE_TOL
        assert np.array_equal(got, outs[0].numpy())


@pytest.mark.parametrize("kind", ["bf16", "int8", "jvp"])
def test_sharded_attention_matches_jax(pool, jmesh, kind):
    """make_sharded_attention: each rank's (batch, head) block of O against
    JAX's shard_map output, causal, batch 4 on data and 4 q / 2 kv heads on
    model (4 kv heads for jvp, which takes no GQA); with bf16 also the
    gradients of sum(O * dO) against jax.grad."""
    rng = np.random.default_rng(11)
    h_kv = 4 if kind == "jvp" else 2  # attention_jvp takes no GQA
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((4, 4, 128, 64), (4, h_kv, 128, 64), (4, h_kv, 128, 64),
                             (4, 4, 128, 64)))
    jfn = j_sharded_attention(jmesh, kind, causal=True)
    want = np.asarray(jfn(*map(jnp.asarray, (q, k, v))))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    if kind == "bf16":
        jgrads = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v) * do), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
        outs = pool.run(mesh_jobs.sharded_attention, kind, *args, True, torch.from_numpy(do),
                        device_type="cpu")
    else:
        outs = [(o,) for o in pool.run(mesh_jobs.sharded_attention, kind, *args, True,
                                       device_type="cpu")]
    spec = ("data", "model", None, None)
    for rank, out in enumerate(outs):
        assert np.abs(out[0].numpy() - _block(want, spec, rank)).max() <= ATTN_TOL[kind]
        if kind == "bf16":
            for got, jg in zip(out[1:], jgrads):
                want_g = _block(jg, spec, rank).astype(np.float64)
                err = np.linalg.norm(got.numpy() - want_g) / np.linalg.norm(want_g)
                assert err <= GRAD_REL_L2


def test_shard_params_int8_is_jax_shards(pool, lm, jmesh):
    """shard_params(weight_quant="int8") quantizes the full weights, then
    slices: every rank's payloads and scales are byte-equal to the JAX
    shards jax.device_put makes of quantize_lm_weights under
    quantize_lm_specs (column scales with their columns, wo/w2's scale
    replicated); plain params slice to JAX's shards bit for bit."""
    jcfg, jparams, cfg, tparams = lm
    for quant in (None, "int8"):
        jp = j_quant_weights(jparams) if quant else jparams
        specs = j_param_specs(jcfg)
        specs = j_quant_specs(specs) if quant else specs
        placed = jax.device_put(jp, jax.tree_util.tree_map(lambda s: NamedSharding(jmesh, s),
                                                           specs))
        outs = pool.run(mesh_jobs.sharded_params, tparams, cfg, MESH, quant, "cpu")
        devices = list(np.asarray(jmesh.devices).reshape(-1))
        for rank, local in enumerate(outs):
            dev = devices[rank]

            def shard_of(arr):
                return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)

            pairs = [(local["embed"], placed["embed"]), (local["unembed"], placed["unembed"])]
            for tl, jl in zip(local["layers"], placed["layers"]):
                pairs += [(tl[key], jl[key]) for key in jl]
            for got, want in pairs:
                if isinstance(got, QuantizedWeight):
                    assert got.w_i8.dtype == torch.int8
                    assert np.array_equal(got.w_i8.numpy(), shard_of(want.w_i8))
                    assert np.array_equal(got.scale.numpy(), shard_of(want.scale))
                else:
                    assert np.array_equal(got.numpy(), shard_of(want))
