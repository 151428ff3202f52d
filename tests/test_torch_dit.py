"""PyTorch port vs the JAX package: the DiT and its rCM distillation step.

The JAX `init_dit` draws `ada` and `out` at scale 0, so at init every gate is
0, attention never reaches the loss and the attention weights get exactly
zero gradient. Every test here therefore replaces `ada` and `out` with the
same N(0, 1/fan_in) numpy arrays on both sides, and the gradient test checks
that the attention weights' gradients are nonzero. The JAX side runs its
Pallas kernels in interpret mode; the port on CPU tensors runs its kernels'
plain versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quantizedattention_tpu.models import dit as jdit
from quantizedattention_tpu_torch.models import (
    DiTConfig,
    dit_forward,
    dit_jvp_step,
    dit_param_leaves,
    dit_params_from_jax,
    init_dit,
    make_dit_rcm_step,
    rcm_loss,
)
from quantizedattention_tpu_torch.ops import api, jvp_bwd

torch.set_num_threads(2)

CFG = dict(d_model=128, n_heads=2, head_dim=64, n_layers=1, seq_len=128)
BATCH = 2
# f32 on both sides; the DiT's forward differs only in summation order
# (measured ~1e-6 relative), the jvp step's du/dt by the same.
FWD_REL = 1e-4
# The JAX test's own gradient criterion (tests/test_models.py:114-151):
# max|diff| < 2e-3 of max|want| per tensor.
GRAD_REL = 2e-3
# AdamW moves each entry by at most lr = 1e-4 per step (plus decay); after 3
# steps the two sides can differ by at most 2 * 3 * lr, and only where a
# near-zero gradient flips Adam's normalised step. The updates (p - p0) must
# agree within relative L2 5e-2, as the LM's test.
LR, STEPS = 1e-4, 3
UPDATE_REL_L2 = 5e-2
NAMES = ["t_mlp1", "t_mlp2", "out"] + [f"layer0.{k}" for k in
                                       ("ada", "wq", "wk", "wv", "wo", "w1", "w2")]


def _flat_jax(tree):
    top = [tree[key] for key in ("t_mlp1", "t_mlp2", "out")]
    keys = ("ada", "wq", "wk", "wv", "wo", "w1", "w2")
    return [np.asarray(x) for x in top + [layer[k] for layer in tree["layers"] for k in keys]]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def dit():
    """(JAX config, JAX params with nonzero ada/out, port config, x, t)."""
    jcfg = jdit.DiTConfig(**CFG)
    jparams = jdit.init_dit(jax.random.key(0), jcfg)
    rng = np.random.default_rng(11)
    d = CFG["d_model"]
    jparams["out"] = jnp.asarray(rng.standard_normal((d, d), np.float32) / math.sqrt(d))
    for layer in jparams["layers"]:
        layer["ada"] = jnp.asarray(rng.standard_normal((d, 6 * d), np.float32) / math.sqrt(d))
    x = rng.standard_normal((BATCH, CFG["seq_len"], d), np.float32)
    t = rng.uniform(size=BATCH).astype(np.float32)
    return jcfg, jparams, DiTConfig(**CFG), x, t


def test_dit_params_from_jax(dit):
    _, jparams, _, _, _ = dit
    params = dit_params_from_jax(jparams, "cpu")
    got = dit_param_leaves(params)
    assert len(got) == len(NAMES)
    for g, w in zip(got, _flat_jax(jparams)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_init_dit_mirrors_jax_shapes_and_scales():
    cfg = DiTConfig(**CFG)
    params = init_dit(cfg, torch.Generator().manual_seed(0), "cpu")
    want = _flat_jax(jdit.init_dit(jax.random.key(0), jdit.DiTConfig(**CFG)))
    for name, g, w in zip(NAMES, dit_param_leaves(params), want):
        assert tuple(g.shape) == w.shape, name
        if name in ("out", "layer0.ada"):  # zero at init in both packages
            assert not g.any() and not w.any(), name
        else:  # N(0, 1/fan_in)
            assert abs(g.std().item() * math.sqrt(g.shape[0]) - 1) < 0.05, name


def test_dit_forward_matches_jax(dit):
    jcfg, jparams, cfg, x, t = dit
    want = np.asarray(jdit.dit_forward(jparams, jnp.asarray(x), jnp.asarray(t), jcfg))
    got = dit_forward(dit_params_from_jax(jparams, "cpu"), torch.from_numpy(x),
                      torch.from_numpy(t), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= FWD_REL * np.abs(want).max()


def test_dit_jvp_step_matches_jax(dit):
    """(u, du/dt) of the explicit-pair path against JAX's jax.jvp with the
    pair rule (which runs fast=True, f32 on the CPU: exact)."""
    jcfg, jparams, cfg, x, t = dit
    u_w, du_w = jdit.dit_jvp_step(jparams, jnp.asarray(x), jnp.asarray(t), jcfg)
    params = dit_params_from_jax(jparams, "cpu")
    u, du = dit_jvp_step(params, torch.from_numpy(x), torch.from_numpy(t), cfg, fast=False)
    for g, w in ((u, u_w), (du, du_w)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= FWD_REL * np.abs(w).max()
    # fast mode rounds every attention product's operands to bf16; measured
    # 9.6e-5 relative L2 from JAX's (f32 on the CPU) du/dt
    u_f, du_f = dit_jvp_step(params, torch.from_numpy(x), torch.from_numpy(t), cfg, fast=True)
    assert 0 < _rel_l2(du_f.numpy(), np.asarray(du_w)) <= 1e-3


def test_dit_jvp_matches_finite_differences_and_runs_b10(dit, monkeypatch):
    """The JAX test's oracle (tests/test_models.py:94-111): finite differences
    along the same tangent. Also: torch.func.jvp of dit_forward with the
    default attention runs the tangent kernel's wrapper (B10) once a layer."""
    _, jparams, cfg, x, t = dit
    params = dit_params_from_jax(jparams, "cpu")
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    u, du = dit_jvp_step(params, xt, tt, cfg, fast=False)
    v = dit_forward(params, xt, tt, cfg)
    eps = 1e-3
    fd = (dit_forward(params, xt + eps * v, tt + eps, cfg) - u) / eps
    assert (fd - du).norm() / du.norm() < 0.05

    calls = {}
    _spy(monkeypatch, calls, api, "attention_tangent_fwd")
    u_j, du_j = torch.func.jvp(lambda x_, t_: dit_forward(params, x_, t_, cfg), (xt, tt),
                               (v, torch.ones_like(tt)))
    assert calls["attention_tangent_fwd"] == cfg.n_layers
    torch.testing.assert_close(du_j, du, rtol=1e-4, atol=1e-4 * du.abs().max().item())


def _jax_loss(jparams, x, t, jcfg):
    u, dudt = jdit.dit_jvp_step(jparams, x, t, jcfg)
    return jnp.mean(dudt ** 2) + 0.1 * jnp.mean(u ** 2)


def test_rcm_loss_and_grads_match_jax(dit):
    jcfg, jparams, cfg, x, t = dit
    loss_w, grads_w = jax.value_and_grad(_jax_loss)(jparams, jnp.asarray(x), jnp.asarray(t), jcfg)
    params = dit_params_from_jax(jparams, "cpu")
    leaves = dit_param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = rcm_loss(params, torch.from_numpy(x), torch.from_numpy(t), cfg, fast=False)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(loss_w)) <= 1e-5 * abs(float(loss_w))
    for name, g, w in zip(NAMES, grads, _flat_jax(grads_w)):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max(), name
        # ada and out nonzero: attention reaches the loss, so every weight
        # (the attention projections included) gets a gradient
        assert g.abs().max() > 0, name


def test_rcm_adamw_steps_match_optax(dit):
    jcfg, jparams, cfg, x, t = dit
    opt = optax.adamw(LR)
    opt_state = opt.init(jparams)

    @jax.jit
    def jstep(p, s):
        loss, grads = jax.value_and_grad(_jax_loss)(p, jnp.asarray(x), jnp.asarray(t), jcfg)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    params = dit_params_from_jax(jparams, "cpu")
    topt, step = make_dit_rcm_step(cfg, params, fast=False)
    jp = jparams
    for _ in range(STEPS):
        jp, opt_state, loss_w = jstep(jp, opt_state)
        loss = step(torch.from_numpy(x), torch.from_numpy(t))
        assert loss.ndim == 0 and not loss.requires_grad
        assert abs(loss.item() - float(loss_w)) <= 1e-5 * abs(float(loss_w))
    for name, got, want, start in zip(NAMES, dit_param_leaves(params), _flat_jax(jp),
                                      _flat_jax(jparams)):
        got = got.detach().numpy()
        assert 0 < np.abs(want - start).max() <= STEPS * LR * 1.01, name
        assert np.abs(got - want).max() <= 2 * STEPS * LR * 1.01, name
        assert _rel_l2(got - start, want - start) <= UPDATE_REL_L2, name
    group = topt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == \
        (1e-4, (0.9, 0.999), 1e-8, 1e-4)


def _spy(monkeypatch, calls, module, name):
    """Count the calls of `module.name` (the wrapper a CUDA run would
    launch through) in calls[name]."""
    calls[name] = 0
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def test_rcm_step_runs_one_b9_b11_b12_per_layer(dit, monkeypatch):
    """Per train step the explicit-pair path calls each of B9, B11 and B12
    once a layer and the fp32 forward (the prepass) once a layer; never B10
    or the flash backward (B2, B3). On the CPU the wrappers run their plain
    versions and count no launch, so their call sites are counted here."""
    _, jparams, cfg, x, t = dit
    cfg = DiTConfig(**{**CFG, "n_layers": 2, "seq_len": 64})
    params = init_dit(cfg, torch.Generator().manual_seed(1), "cpu")
    calls = {}
    for module, name in ((api, "attention_jvp_fwd"), (jvp_bwd, "jvp_bwd_dkv"),
                         (jvp_bwd, "jvp_bwd_dq"), (api, "flash_attention_fwd_fp32"),
                         (api, "attention_tangent_fwd"), (api, "flash_attention_bwd"),
                         (api, "flash_attention_fwd")):  # the last: B1 bf16, never
        _spy(monkeypatch, calls, module, name)
    _, step = make_dit_rcm_step(cfg, params)
    xt = torch.from_numpy(x[:, :64].copy())
    for n in range(1, 3):
        loss = step(xt, torch.from_numpy(t))
        assert torch.isfinite(loss)
        assert calls == {"attention_jvp_fwd": 2 * n, "jvp_bwd_dkv": 2 * n, "jvp_bwd_dq": 2 * n,
                         "flash_attention_fwd_fp32": 2 * n, "attention_tangent_fwd": 0,
                         "flash_attention_bwd": 0, "flash_attention_fwd": 0}
