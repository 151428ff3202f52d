"""PyTorch port vs the JAX package: the sequence-parallel train step.

`make_sharded_train_step` runs in 4 gloo ranks (parallel/launch.py:RankPool,
spawned once for the module; models/sharded_jobs.py:train), each on its own
parameter shards and (data, context) token block, on a (data 1, model 2,
context 2) mesh, or (2, 1, 2) for Ulysses. Its first step's loss (the global
mean) and every parameter's gradient (summed over data and context, the
model-sharded ones gathered to whole tensors on rank 0) are held against the
JAX package with the same params (initialised in JAX, carried over with
params_from_jax) and tokens:
- bf16 strategies: JAX's one-device jax.value_and_grad(lm_loss). A wrong
  factor in a collective's transpose shows here, not in AdamW's first step,
  which is close to sign(g).
- int8 ring, zigzag and all-gather: JAX's shard_map'd loss of the same strategy
  (sharded_train.py:_sharded_forward under shard_map, as
  make_sharded_train_step builds it; zigzag with tokens and targets permuted
  by zigzag_perm) on 4 of the 8 emulated devices: each shard is quantized on
  its own grain, so that is the only reference on the same grid.
- int8 Ulysses quantizes each head's whole sequence: JAX's one-device int8
  lm_loss.
Tolerances: tests/test_torch_train.py's and tests/test_torch_int8.py's.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.models.sharded_train import (
    make_sharded_train_step as j_make_sharded_train_step,
)
from quantizedattention_tpu.parallel import scaling_model as j_scaling_model
from quantizedattention_tpu.models.sharded_train import _sharded_forward as j_sharded_forward
from quantizedattention_tpu.models.sharded_train import param_specs as j_param_specs
from quantizedattention_tpu.parallel import make_attention_mesh as j_mesh
from quantizedattention_tpu.parallel.zigzag import zigzag_perm as j_zigzag_perm
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    make_sharded_train_step,
    params_from_jax,
    shard_params,
)
from quantizedattention_tpu_torch.models import sharded_jobs
from quantizedattention_tpu_torch.models.sharded_train import (
    STRATEGIES,
    auto_sp_arguments,
    resolve_attention_sp,
)
from quantizedattention_tpu_torch.parallel.launch import RankPool

torch.set_num_threads(2)

# bf16 against one device (tests/test_torch_train.py:286-287): both run the
# same bf16 forward rounding and a fast backward, the JAX side in f32 on the
# CPU; the ring and zigzag round P against each shard's running max
LOSS_REL, GRAD_REL_L2 = 1e-4, 3e-2
# int8 against JAX's same strategy (tests/test_torch_int8.py:454-455)
INT8_LOSS_REL, LM_GRAD_REL_L2 = 1e-4, 1e-2

B, T = 2, 256


def _cfg(n_kv, attention="bf16"):
    return dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=n_kv, head_dim=64, n_layers=1,
                max_seq=T, attention=attention)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 64, (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jflat(tree) -> dict:
    out = {k: np.asarray(tree[k]) for k in ("embed", "unembed", "final_norm")}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": np.asarray(v) for k, v in layer.items()})
    return out


@functools.cache
def _jax_params(n_kv):
    return jtr.init_transformer(jax.random.key(0), jtr.TransformerConfig(**_cfg(n_kv)))


@functools.cache
def _one_device(n_kv, attention, tokens_key):
    tokens, targets = (np.frombuffer(x, np.int32).reshape(B, T) for x in tokens_key)
    jcfg = jtr.TransformerConfig(**_cfg(n_kv, attention))
    loss, grads = jax.value_and_grad(jtr.lm_loss)(_jax_params(n_kv), jnp.asarray(tokens),
                                                  jnp.asarray(targets), jcfg)
    return float(loss), _jflat(grads)


def _sharded_reference(n_kv, attention, sp, shape, tokens, targets):
    """JAX's shard_map'd loss of `sp` (make_sharded_train_step:_build_loss)
    and its gradients."""
    jcfg = jtr.TransformerConfig(**_cfg(n_kv, attention))
    mesh = j_mesh(*shape)
    tok_spec = P("data", "context")

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(j_param_specs(jcfg), tok_spec, tok_spec), out_specs=P(),
                       check_vma=False)
    def loss_fn(params, tok, tgt):
        logits = j_sharded_forward(params, tok, jcfg, None, attention, sp)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        return (jax.lax.psum(jnp.sum(nll), ("data", "context"))
                / jax.lax.psum(nll.size, ("data", "context")))

    if sp == "zigzag":
        zp = np.asarray(j_zigzag_perm(shape[2], T))
        tokens, targets = tokens[:, zp], targets[:, zp]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(_jax_params(n_kv), jnp.asarray(tokens),
                                                      jnp.asarray(targets))
    return float(loss), _jflat(grads)


def _run(pool, n_kv, attention, sp, shape, batch):
    tokens, targets = batch
    cfg = TransformerConfig(**_cfg(n_kv, attention))
    params = params_from_jax(_jax_params(n_kv), "cpu")
    outs = pool.run(sharded_jobs.train, cfg, shape, params, torch.from_numpy(tokens),
                    torch.from_numpy(targets), 1, attention, sp, "cpu")
    losses = [o["losses"][0] for o in outs]
    assert all(x == losses[0] for x in losses), losses
    assert all(o["grads"] is None for o in outs[1:])
    return losses[0], {k: v.numpy() for k, v in outs[0]["grads"].items()}


def _hold(loss, grads, want_loss, want, loss_rel, grad_rel):
    assert abs(loss - want_loss) <= loss_rel * abs(want_loss)
    assert grads.keys() == want.keys()
    for name, w in want.items():
        g = grads[name]
        assert g.shape == w.shape, name
        rel = np.linalg.norm(g.astype(np.float64) - w) / np.linalg.norm(w)
        assert rel <= grad_rel, (name, rel)


BF16_CASES = [  # (n_kv_heads, attention_sp, mesh)
    (4, "ring", (1, 2, 2)),
    (2, "ring", (1, 2, 2)),
    (4, "allgather", (1, 2, 2)),
    (4, "zigzag", (1, 2, 2)),
    (2, "zigzag", (1, 2, 2)),
    (4, "ulysses", (2, 1, 2)),
    (2, "ulysses", (2, 1, 2)),
]


@pytest.mark.parametrize("n_kv,sp,shape", BF16_CASES,
                         ids=lambda x: x if isinstance(x, str) else str(x))
def test_bf16_step_matches_one_device(pool, batch, n_kv, sp, shape):
    loss, grads = _run(pool, n_kv, "bf16", sp, shape, batch)
    want_loss, want = _one_device(n_kv, "bf16", tuple(x.tobytes() for x in batch))
    _hold(loss, grads, want_loss, want, LOSS_REL, GRAD_REL_L2)


@pytest.mark.parametrize("sp", ["ring", "zigzag", "allgather"])
def test_int8_step_matches_jax_sharded(pool, batch, sp):
    shape = (1, 2, 2)
    loss, grads = _run(pool, 2, "int8", sp, shape, batch)
    want_loss, want = _sharded_reference(2, "int8", sp, shape, *batch)
    _hold(loss, grads, want_loss, want, INT8_LOSS_REL, LM_GRAD_REL_L2)


def test_int8_ulysses_step_matches_one_device(pool, batch):
    loss, grads = _run(pool, 2, "int8", "ulysses", (2, 1, 2), batch)
    want_loss, want = _one_device(2, "int8", tuple(x.tobytes() for x in batch))
    _hold(loss, grads, want_loss, want, INT8_LOSS_REL, LM_GRAD_REL_L2)


# --------------------------------------------------------------------------
# The step's refusals, before any collective
# --------------------------------------------------------------------------

class _Mesh:
    """Enough of a DeviceMesh for the construction-time checks."""

    mesh_dim_names = ("data", "model", "context")

    def __init__(self, shape):
        self.shape = shape

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        return 0


def _local(n_kv, shape, **kw):
    cfg = TransformerConfig(**{**_cfg(n_kv), **kw})
    return cfg, shard_params(params_from_jax(_jax_params(n_kv), "cpu"), cfg, _Mesh(shape))


def test_step_refusals():
    cfg, params = _local(4, (1, 2, 2))
    # the default "auto" resolves, at construction, to the model's pick
    _, step = make_sharded_train_step(_Mesh((1, 2, 2)), cfg, params)
    assert step.attention_sp == resolve_attention_sp(cfg, 2, 2, "bf16")
    assert step.attention_sp in STRATEGIES and step.last_attention_sp is None
    # the int8 all-gather's refusal (JAX collective.py:153-154), from the
    # step, before any collective: 100 tokens a shard
    _, step = make_sharded_train_step(_Mesh((1, 2, 2)), cfg, params, attention="int8",
                                      attention_sp="allgather")
    with pytest.raises(ValueError, match="t_local % 128"):
        step(torch.zeros((B, 100), dtype=torch.long), torch.zeros((B, 100), dtype=torch.long))
    with pytest.raises(ValueError, match="divisible by the context axis"):
        make_sharded_train_step(_Mesh((1, 2, 4)), cfg, params, attention_sp="ulysses")
    with pytest.raises(ValueError, match="unknown attention_sp"):
        make_sharded_train_step(_Mesh((1, 2, 2)), cfg, params, attention_sp="tree")
    with pytest.raises(ValueError, match="n_kv_heads must divide"):
        make_sharded_train_step(_Mesh((1, 4, 1)), TransformerConfig(**_cfg(2)), params,
                                attention_sp="ring")
    _, step = make_sharded_train_step(_Mesh((1, 2, 2)), cfg, params, attention_sp="zigzag")
    tokens = torch.zeros((B, 127), dtype=torch.long)  # 254 tokens: not a multiple of 4
    with pytest.raises(ValueError, match="cannot shard sequence length 254"):
        step(tokens, tokens)


# --------------------------------------------------------------------------
# attention_sp="auto": the JAX default (sharded_train.py:166-181, :205-233)
# --------------------------------------------------------------------------

def test_auto_step_matches_jax_auto_step(pool, batch):
    """JAX's test_train_step_attention_sp_auto_resolves
    (tests/test_distributed.py:597) on the file's params and batch: the
    port's default step and JAX's, each under its own constants (their picks
    may differ: ROADMAP.md §C), give the same first loss within the bf16 SP
    tolerance, and the port's gradients hold against one device's."""
    n_kv, shape = 4, (1, 2, 2)
    loss, grads = _run(pool, n_kv, "bf16", "auto", shape, batch)
    jcfg = jtr.TransformerConfig(**_cfg(n_kv))
    optimizer, step = j_make_sharded_train_step(j_mesh(*shape), jcfg)  # auto
    params = _jax_params(n_kv)
    _, _, want_loss = step(params, optimizer.init(params), *(jnp.asarray(x) for x in batch))
    _, want = _one_device(n_kv, "bf16", tuple(x.tobytes() for x in batch))
    _hold(loss, grads, float(want_loss), want, LOSS_REL, GRAD_REL_L2)
    bad = TransformerConfig(vocab_size=64, d_model=96, n_heads=3, n_kv_heads=3, head_dim=32,
                            n_layers=1, max_seq=256)
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_train_step(_Mesh((2, 1, 2)), bad, {}, attention_sp="ulysses")


class _Recorded(Exception):
    pass


class _JaxMeshShape:
    """What JAX's make_sharded_train_step reads of its mesh before it asks
    the model."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("attention", ["bf16", "int8"])
def test_resolver_hands_jax_arguments_to_the_model(monkeypatch, attention):
    """auto_sp_arguments gives best_sp_variant what JAX's step gives it (JAX's
    call recorded, then stopped), over head counts, GQA, head dims, lengths
    and meshes; without a context axis both take the ring without asking
    (JAX's branch is read, not run: its step would need a real mesh)."""
    seen = []

    def record(**kw):
        seen.append(kw)
        raise _Recorded

    monkeypatch.setattr(j_scaling_model, "best_sp_variant", record)
    for (h, h_kv), d, max_seq, (model, context) in itertools.product(
            [(4, 4), (4, 2), (16, 4), (8, 8)], (32, 64, 128), (100, 256, 1000, 2048, 8192),
            [(1, 2), (2, 2), (1, 4), (2, 4), (1, 8), (2, 1)]):
        if h % model or h_kv % model:
            continue
        kw = dict(vocab_size=64, d_model=h * d, n_heads=h, n_kv_heads=h_kv, head_dim=d,
                  n_layers=1, max_seq=max_seq)
        cfg = TransformerConfig(**kw)
        if context == 1:  # JAX: `... if n_ctx > 1 else "ring"`
            assert resolve_attention_sp(cfg, model, context, attention) == "ring"
            continue
        mesh = _JaxMeshShape({"data": 1, "model": model, "context": context})
        seen.clear()
        with pytest.raises(_Recorded):
            j_make_sharded_train_step(mesh, jtr.TransformerConfig(**kw), attention=attention)
        assert seen == [auto_sp_arguments(cfg, model, context, attention)], kw


# a length the pick cannot shard runs the ring under "auto" and raises when
# the strategy is named; (attention, max_seq, the step's tokens) on (1, 1,
# 4) with 2 kv heads (no Ulysses). Zigzag: the pick at a max_seq long enough
# that compute dominates, where the striped ring's balanced FLOPs beat the
# contiguous ring and the all-gather under any constants; 252 tokens are not
# a multiple of 2 x 4. The int8 all-gather: the pick at 128-token shards
# under the port's H100 constants (latency-bound); 200 tokens give shards
# of 50
FALLBACK = {"zigzag": ("bf16", 1 << 20, 252), "allgather": ("int8", 256, 200)}


@pytest.mark.parametrize("pick", sorted(FALLBACK))
def test_auto_falls_back_to_the_ring_on_a_length_its_pick_cannot_shard(pool, pick):
    attention, max_seq, t = FALLBACK[pick]
    shape = (1, 1, 4)
    cfg = TransformerConfig(**{**_cfg(2, attention), "max_seq": max_seq})
    assert resolve_attention_sp(cfg, 1, 4, attention) == pick
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 64, (B, t)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    params = params_from_jax(_jax_params(2), "cpu")
    runs = {sp: pool.run(sharded_jobs.train, cfg, shape, params, torch.from_numpy(tokens),
                         torch.from_numpy(targets), 1, attention, sp, "cpu")
            for sp in ("auto", "ring")}
    assert {(o["attention_sp"], *o["ran"]) for o in runs["auto"]} == {(pick, "ring")}
    assert runs["auto"][0]["losses"] == runs["ring"][0]["losses"]
    for name, g in runs["auto"][0]["grads"].items():
        assert torch.equal(g, runs["ring"][0]["grads"][name]), name
    # named, the same strategy raises from the step, before any collective
    local = shard_params(params_from_jax(_jax_params(2), "cpu"), cfg, _Mesh(shape))
    _, step = make_sharded_train_step(_Mesh(shape), cfg, local, attention=attention,
                                      attention_sp=pick)
    block = torch.zeros((B, t // 4), dtype=torch.long)
    with pytest.raises(ValueError, match="cannot shard|t_local % 128|multiple of the kv block"):
        step(block, block)
