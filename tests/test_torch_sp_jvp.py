"""PyTorch port vs the JAX package: the JVP ring and the DiT's rCM step
under a mesh.

`ring_attention_jvp` runs on 4 gloo ranks (parallel/launch.py:RankPool,
spawned once for the module; models/sharded_jobs.py's calls), its (O, tO)
and the gradients of sum(O * dO + tO * dtO) in all six inputs held against
JAX's ring_attention_jvp under shard_map on 4 of the 8 emulated devices
(tests/conftest.py), causal and not (tests/test_distributed.py:360). Then
the DiT's new arguments on one device, `dit_forward(attention=)` and
`dit_jvp_step(dx_dt=)`, against JAX's, and `make_dit_rcm_step(mesh=)`:
its first loss and updated params against JAX's make_dit_rcm_step(mesh,
fast=False) on the same (data, model, context) shape, its loss against the
one-device step's, and the port of test_dit_rcm_step_unused_model_axis_grads
(tests/test_models.py:186): the same data gives the same gradients and
updates on (2, 1, 2) and (1, 2, 2). `ada` and `out` are drawn nonzero on
both sides (tests/test_torch_dit.py), so attention reaches the loss. Rank r
sits at (data r // (model * context), model (r // context) % model, context
r % context) in both meshes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from quantizedattention_tpu.models import dit as jdit
from quantizedattention_tpu.parallel import make_attention_mesh as j_mesh
from quantizedattention_tpu.parallel.ring import ring_attention_jvp as j_ring_jvp
from quantizedattention_tpu.reference import reference_attention as j_reference
from quantizedattention_tpu_torch.models import (
    DiTConfig,
    dit_forward,
    dit_jvp_step,
    dit_param_leaves,
    dit_params_from_jax,
    make_dit_rcm_step,
)
from quantizedattention_tpu_torch.models import sharded_jobs
from quantizedattention_tpu_torch.parallel.launch import RankPool
from quantizedattention_tpu_torch.reference import reference_attention

torch.set_num_threads(2)

# exact mode against JAX (tests/test_torch_jvp.py): max|diff| / max|JAX| per
# tensor, outputs and every gradient
EXACT_TOL = 1e-4
# the DiT's forward and jvp step on one device (tests/test_torch_dit.py)
FWD_REL = 1e-4
# AdamW's first update against optax's (tests/test_torch_dit.py)
UPDATE_REL_L2 = 5e-2
# the sharded step's loss against the one-device step: JAX's own bound
# (tests/test_models.py:183), its prepass running the bf16 ring
ONE_DEVICE_REL = 5e-3
# (2, 1, 2) against (1, 2, 2): the JAX test's bounds on the updated params
# (1e-4) and loss (1e-5 relative); the gradients, which Adam's first step
# hides, by relative L2 (a factor of the model axis would read 1)
MESH_PARAM_TOL, MESH_LOSS_REL, MESH_GRAD_REL_L2 = 1e-4, 1e-5, 1e-4

RING_SHAPE = (1, 2, 2)  # heads over model, the sequence over context
CFG = dict(d_model=128, n_heads=2, head_dim=64, n_layers=1, seq_len=256)
BATCH = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _block(a, rank, shape):
    """Rank `rank`'s (batch, head, token) block of the global array `a`."""
    data, model, context = shape
    coords = (rank // (model * context), (rank // context) % model, rank % context)
    index = [slice(c * (a.shape[d] // n), (c + 1) * (a.shape[d] // n))
             for d, (n, c) in enumerate(zip(shape, coords))]
    return np.asarray(a)[tuple(index)]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


# --------------------------------------------------------------------------
# The JVP ring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_ring_jvp_matches_jax(pool, causal):
    rng = np.random.default_rng(360 + int(causal))
    ins = [rng.standard_normal((1, 2, 256, 64), np.float32) for _ in range(8)]
    spec = P(None, "model", "context", None)
    pair = jax.jit(jax.shard_map(
        lambda *a: j_ring_jvp(*a, axis_name="context", causal=causal),
        mesh=j_mesh(*RING_SHAPE), in_specs=(spec,) * 6, out_specs=(spec, spec), check_vma=False))
    jins = [jnp.asarray(x) for x in ins[:6]]
    do, dto = (jnp.asarray(x) for x in ins[6:])

    def loss(*a):
        o, to = pair(*a)
        return jnp.sum(o * do) + jnp.sum(to * dto)

    want = [*pair(*jins), *jax.grad(loss, argnums=tuple(range(6)))(*jins)]
    outs = pool.run(sharded_jobs.ring_jvp, *map(_t, ins), RING_SHAPE, causal, False, "cpu")
    names = ("o", "to", "dq", "dk", "dv", "dtq", "dtk", "dtv")
    for rank, got in enumerate(outs):
        for name, g, w in zip(names, got, want):
            w = _block(w, rank, RING_SHAPE)
            assert g.shape == w.shape, (rank, name)
            assert _max_rel(g.numpy(), w) <= EXACT_TOL, (rank, name)


# --------------------------------------------------------------------------
# The DiT's attention= and dx_dt=, and the rCM step under a mesh
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dit():
    """(JAX config, JAX params with nonzero ada/out, port config, x, t)."""
    jcfg = jdit.DiTConfig(**CFG)
    jparams = jdit.init_dit(jax.random.key(0), jcfg)
    rng = np.random.default_rng(12)
    d = CFG["d_model"]
    jparams["out"] = jnp.asarray(rng.standard_normal((d, d), np.float32) / math.sqrt(d))
    for layer in jparams["layers"]:
        layer["ada"] = jnp.asarray(rng.standard_normal((d, 6 * d), np.float32) / math.sqrt(d))
    x = rng.standard_normal((BATCH, CFG["seq_len"], d), np.float32)
    t = rng.uniform(size=BATCH).astype(np.float32)
    return jcfg, jparams, DiTConfig(**CFG), x, t


def test_dit_forward_attention_matches_jax(dit):
    """dit_forward with a caller's attention: the fp32 reference on both sides."""
    jcfg, jparams, cfg, x, t = dit
    want = np.asarray(jdit.dit_forward(
        jparams, jnp.asarray(x), jnp.asarray(t), jcfg,
        attention=lambda q, k, v: j_reference(q, k, v, causal=False)))
    calls = []

    def attention(q, k, v):
        calls.append(q.shape)
        return reference_attention(q, k, v, causal=False)

    got = dit_forward(dit_params_from_jax(jparams, "cpu"), _t(x), _t(t), cfg,
                      attention=attention)
    assert calls == [(BATCH, CFG["n_heads"], CFG["seq_len"], CFG["head_dim"])] * CFG["n_layers"]
    assert _max_rel(got.numpy(), want) <= FWD_REL


def test_dit_jvp_step_dx_dt_matches_jax(dit):
    """A given direction replaces the prepass: JAX's dit_jvp_step(dx_dt=)."""
    jcfg, jparams, cfg, x, t = dit
    dx_dt = np.random.default_rng(13).standard_normal(x.shape).astype(np.float32)
    u_w, du_w = jdit.dit_jvp_step(jparams, jnp.asarray(x), jnp.asarray(t), jcfg,
                                  dx_dt=jnp.asarray(dx_dt))
    u, du = dit_jvp_step(dit_params_from_jax(jparams, "cpu"), _t(x), _t(t), cfg, fast=False,
                         dx_dt=_t(dx_dt))
    assert _max_rel(u.numpy(), u_w) <= FWD_REL
    assert _max_rel(du.numpy(), du_w) <= FWD_REL
    _, du_own = dit_jvp_step(dit_params_from_jax(jparams, "cpu"), _t(x), _t(t), cfg, fast=False)
    assert _rel_l2(du_own.numpy(), du_w) > 0.1  # the given direction, not the model's own


def _rcm_mesh(pool, dit, shape):
    _, jparams, cfg, x, t = dit
    outs = pool.run(sharded_jobs.rcm, cfg, shape, dit_params_from_jax(jparams, "cpu"), _t(x),
                    _t(t), 1, False, "cpu")
    losses = [o["losses"][0] for o in outs]
    assert all(x == losses[0] for x in losses), losses
    assert all(o["params"] is None for o in outs[1:])
    return losses[0], outs[0]["grads"], outs[0]["params"]


@pytest.fixture(scope="module")
def rcm_runs(pool, dit):
    return {shape: _rcm_mesh(pool, dit, shape) for shape in ((2, 1, 2), (1, 2, 2))}


def _flat_jax(tree):
    keys = ("ada", "wq", "wk", "wv", "wo", "w1", "w2")
    return [np.asarray(x) for x in [tree[k] for k in ("t_mlp1", "t_mlp2", "out")]
            + [layer[k] for layer in tree["layers"] for k in keys]]


def test_rcm_mesh_step_matches_jax(dit, rcm_runs):
    """The first loss and updated params against JAX's step on the same mesh
    shape, and the loss against the one-device step's."""
    jcfg, jparams, cfg, x, t = dit
    shape = (2, 1, 2)
    opt, jstep = jdit.make_dit_rcm_step(j_mesh(*shape), jcfg, fast=False)
    p1, _, jloss = jstep(jparams, opt.init(jparams), jnp.asarray(x), jnp.asarray(t))
    loss, _, params = rcm_runs[shape]
    assert abs(loss - float(jloss)) <= FWD_REL * abs(float(jloss))
    for got, start, want in zip(params, _flat_jax(jparams), _flat_jax(p1)):
        assert _rel_l2(got.numpy() - start, want - start) <= UPDATE_REL_L2
    one = dit_params_from_jax(jparams, "cpu")
    _, step = make_dit_rcm_step(cfg, one, fast=False)
    loss_one = float(step(_t(x), _t(t)))
    assert abs(loss - loss_one) <= ONE_DEVICE_REL * max(1.0, abs(loss_one))


def test_rcm_mesh_step_unused_model_axis(dit, rcm_runs):
    """The same data on (2, 1, 2) and (1, 2, 2): an axis the step does not
    use (model) replicates the computation and adds no factor."""
    (l_a, g_a, p_a), (l_b, g_b, p_b) = rcm_runs[(2, 1, 2)], rcm_runs[(1, 2, 2)]
    assert abs(l_a - l_b) <= MESH_LOSS_REL * max(1.0, abs(l_a))
    assert len(p_a) == len(dit_param_leaves(dit_params_from_jax(dit[1], "cpu")))
    for a, b in zip(g_a, g_b):
        assert _rel_l2(a.numpy(), b.numpy()) <= MESH_GRAD_REL_L2
    for a, b in zip(p_a, p_b):
        assert (a - b).abs().max().item() <= MESH_PARAM_TOL
