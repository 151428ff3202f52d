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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from quantizedattention_tpu.models import transformer as jtr
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
    with pytest.raises(NotImplementedError, match="scaling_model"):
        make_sharded_train_step(_Mesh((1, 2, 2)), cfg, params)
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
