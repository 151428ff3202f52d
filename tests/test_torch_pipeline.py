"""PyTorch port vs the JAX package: the GPipe pipeline train step.

`make_pipeline_train_step` runs in 4 gloo ranks (parallel/launch.py:RankPool,
spawned once for the module; models/sharded_jobs.py:pipeline_train), one
stage of the ("pipe",) mesh a rank, at tests/test_pipeline.py's config
(vocab 64, d_model 64, 2/2 heads x 32, 4 layers, max_seq 128, batch 8) with
the params initialised in JAX and carried over by params_from_jax. Its
first step's loss and every leaf's gradient are held against JAX's
one-device jax.value_and_grad(lm_loss), with JAX's own bounds for its
pipeline (loss rtol 2e-4, gradients atol 2e-3): tests/test_pipeline.py holds
JAX's shard_map pipeline to the same one-device reference. The int8 case
runs tests/test_torch_int8.py's LM config (head_dim 64) with 4 layers and is
held at that file's tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    make_pipeline_train_step,
    params_from_jax,
)
from quantizedattention_tpu_torch.models import sharded_jobs
from quantizedattention_tpu_torch.parallel.launch import RankPool

torch.set_num_threads(2)

# JAX's bounds for its pipeline against one device (tests/test_pipeline.py)
LOSS_RTOL, GRAD_ATOL = 2e-4, 2e-3
# int8 against one device's int8 LM (tests/test_torch_int8.py:454-455): each
# microbatch row is quantized on the grain one device uses for it
INT8_LOSS_REL, INT8_GRAD_REL_L2 = 1e-4, 1e-2

CFG = dict(vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, n_layers=4,
           max_seq=128, attention="bf16")
INT8_CFG = dict(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, n_layers=4,
                max_seq=128, attention="int8")
B, T = 8, 128


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 64, (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jflat(tree) -> dict:
    out = {k: np.asarray(tree[k]) for k in ("embed", "unembed", "final_norm")}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": np.asarray(v) for k, v in layer.items()})
    return out


@functools.cache
def _jax_params(kind):
    kw = CFG if kind == "bf16" else INT8_CFG
    return jtr.init_transformer(jax.random.key(0), jtr.TransformerConfig(**kw))


@functools.cache
def _one_device(kind, tokens_key):
    tokens, targets = (np.frombuffer(x, np.int32).reshape(B, T) for x in tokens_key)
    jcfg = jtr.TransformerConfig(**(CFG if kind == "bf16" else INT8_CFG))
    loss, grads = jax.value_and_grad(jtr.lm_loss)(_jax_params(kind), jnp.asarray(tokens),
                                                  jnp.asarray(targets), jcfg)
    return float(loss), _jflat(grads)


def _run(pool, kind, batch, n_micro, steps=1):
    tokens, targets = batch
    cfg = TransformerConfig(**(CFG if kind == "bf16" else INT8_CFG))
    outs = pool.run(sharded_jobs.pipeline_train, cfg, params_from_jax(_jax_params(kind), "cpu"),
                    torch.from_numpy(tokens), torch.from_numpy(targets), n_micro, steps, "cpu")
    grads = {}
    for o in reversed(outs):  # the replicated leaves' gradients from rank 0
        grads.update({k: v.numpy() for k, v in o["grads"].items()})
    return outs, grads


def _reference(kind, batch):
    return _one_device(kind, tuple(x.tobytes() for x in batch))


@pytest.fixture(scope="module")
def run4(pool, batch):
    return _run(pool, "bf16", batch, 4)


def test_pipeline_loss_matches_single_device(run4, batch):
    outs, _ = run4
    want, _ = _reference("bf16", batch)
    np.testing.assert_allclose(outs[0]["losses"][0], want, rtol=LOSS_RTOL)


def test_pipeline_every_rank_reports_the_same_loss(run4):
    outs, _ = run4
    assert all(o["losses"] == outs[0]["losses"] for o in outs), [o["losses"] for o in outs]


def test_pipeline_grads_match_single_device(run4, batch):
    """Every leaf, the replicated embed/unembed/final_norm included: their
    gradients, summed over pipe, come out unscaled by the stage count (each
    is touched by one stage's compute)."""
    _, grads = run4
    _, want = _reference("bf16", batch)
    assert grads.keys() == want.keys()
    for name, w in want.items():
        assert grads[name].shape == w.shape, name
        np.testing.assert_allclose(grads[name], w, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_pipeline_microbatch_counts_match_single_device(pool, batch, n_micro):
    outs, grads = _run(pool, "bf16", batch, n_micro)
    want_loss, want = _reference("bf16", batch)
    np.testing.assert_allclose(outs[0]["losses"][0], want_loss, rtol=LOSS_RTOL)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w, atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_pipeline_training_reduces_loss(pool, batch):
    """Four steps; the replicated leaves stay equal on every rank (each
    replica takes the same summed gradient and the same AdamW step)."""
    outs, _ = _run(pool, "bf16", batch, 4, steps=4)
    losses = outs[0]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert all(o["replicated"] == outs[0]["replicated"] for o in outs)


def test_pipeline_int8_matches_single_device(pool, batch):
    outs, grads = _run(pool, "int8", batch, 4)
    want_loss, want = _reference("int8", batch)
    loss = outs[0]["losses"][0]
    assert all(o["losses"][0] == loss for o in outs)
    assert abs(loss - want_loss) <= INT8_LOSS_REL * abs(want_loss)
    for name, w in want.items():
        rel = np.linalg.norm(grads[name].astype(np.float64) - w) / np.linalg.norm(w)
        assert rel <= INT8_GRAD_REL_L2, (name, rel)


class _PipeMesh:
    """Enough of a 4-stage DeviceMesh for the construction-time check."""

    mesh_dim_names = ("pipe",)

    def size(self, dim):
        return 4

    def get_local_rank(self, axis):
        return 0


def test_pipeline_rejects_bad_stage_split():
    bad = TransformerConfig(**{**CFG, "n_layers": 3})
    with pytest.raises(ValueError, match="stages"):
        make_pipeline_train_step(_PipeMesh(), bad, None, n_microbatches=4)
