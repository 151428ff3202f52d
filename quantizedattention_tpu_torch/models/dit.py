"""Flow-matching DiT on the JVP attention kernels, and its rCM distillation step.

Counterpart of quantizedattention_tpu/models/dit.py. The model
is a minimal adaLN DiT: timestep-conditioned shift/scale/gate around
non-causal attention and an MLP, with a residual head. Params are a dict
{t_mlp1, t_mlp2, out, layers: [{ada, wq, wk, wv, wo, w1, w2}]} of [in, out]
weights, as in the JAX package.

rCM distillation trains through du/dt, the forward-mode derivative of the
network along the probability-flow ODE. The JAX package gets it from
jax.jvp with a custom_jvp rule whose (O, tO) come from one kernel. A torch
autograd.Function's jvp rule cannot replace its primal (autograd would run
its forward and backward for O as well), so `dit_jvp_step` carries
(primal, tangent) pairs explicitly: the segments between attentions (the
timestep MLP, the pre-attention projections, the post-attention residual
and MLP, the head) run under torch.func.jvp, and attention in between is
`attention_value_and_jvp` (B9 forward; B11 and B12 under backward). Reverse
mode flows through the segments' outputs. `dit_forward` runs the same
segment functions, so the two paths cannot drift.

`make_dit_rcm_step(mesh=)` is the sequence-parallel step (JAX
models/dit.py:160-241): each rank holds its (data, context) block of the
latents; everything but attention is per token, so only attention crosses
the context axis: the tangent direction's prepass through the bf16 ring
(parallel/ring.py:ring_attention), the differentiated pass through the JVP
ring (ring_attention_jvp), and the loss and gradients summed over data and
context.

Differences from PyTorch's defaults that the JAX model fixes: GELU is the
tanh form (jax.nn.gelu), the layer norm has no affine, uses the population
variance and eps 1e-6, the timestep embedding is [cos, sin] at dim 256, and
t's tangent is ones.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch.models.sharded_train import _psum_grads
from quantizedattention_tpu_torch.ops.api import attention_jvp, attention_value_and_jvp
from quantizedattention_tpu_torch.parallel.mesh import axis_size, psum
from quantizedattention_tpu_torch.parallel.ring import ring_attention, ring_attention_jvp

DIT_LAYER_KEYS = ("ada", "wq", "wk", "wv", "wo", "w1", "w2")


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    d_model: int = 256
    n_heads: int = 4
    head_dim: int = 64
    n_layers: int = 2
    mlp_ratio: int = 4
    seq_len: int = 256


def init_dit(cfg: DiTConfig, generator: torch.Generator, device, dtype=torch.float32):
    """Random params with the JAX package's shapes and scales: linears
    N(0, 1/fan_in), `ada` and `out` zero (so at init every gate is 0 and
    attention does not reach the output). Drawn in f32 on the generator's
    device, then moved to `device` as `dtype`."""

    def linear(n_in, n_out, scale=None):
        scale = 1.0 / math.sqrt(n_in) if scale is None else scale
        x = torch.randn((n_in, n_out), generator=generator, dtype=torch.float32,
                        device=generator.device) * scale
        return x.to(device=device, dtype=dtype)

    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    params = {"t_mlp1": linear(256, d), "t_mlp2": linear(d, d), "out": linear(d, d, 0.0),
              "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ada": linear(d, 6 * d, 0.0), "wq": linear(d, hd), "wk": linear(d, hd),
            "wv": linear(d, hd), "wo": linear(hd, d), "w1": linear(d, d * cfg.mlp_ratio),
            "w2": linear(d * cfg.mlp_ratio, d),
        })
    return params


def dit_param_leaves(params) -> list[torch.Tensor]:
    """The params' tensors in a fixed order: t_mlp1, t_mlp2, out, then each
    layer's ada, wq, wk, wv, wo, w1, w2."""
    return [params["t_mlp1"], params["t_mlp2"], params["out"]] + [
        layer[key] for layer in params["layers"] for key in DIT_LAYER_KEYS]


def _timestep_embed(t, dim=256):
    """Sinusoidal embedding of t [B] -> [B, dim]: [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t[:, None].float() * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _ln(x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


# The segments between attentions: dit_forward and the pair path share them.

def _temb(params, t):
    return F.silu(_timestep_embed(t) @ params["t_mlp1"]) @ params["t_mlp2"]


def _pre_attention(layer, x, temb, cfg: DiTConfig):
    """q, k, v [b, h, n, d] and the gates/modulation the post segment needs."""
    b, n, _ = x.shape
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = (F.silu(temb) @ layer["ada"]).chunk(6, dim=-1)
    h = _modulate(_ln(x), sh_a, sc_a)

    def heads(w):
        return (h @ w).reshape(b, n, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    return heads(layer["wq"]), heads(layer["wk"]), heads(layer["wv"]), g_a, sh_m, sc_m, g_m


def _post_attention(layer, x, o, g_a, sh_m, sc_m, g_m):
    b, n, _ = x.shape
    o = o.transpose(1, 2).reshape(b, n, -1)
    x = x + g_a[:, None, :] * (o @ layer["wo"])
    h = _modulate(_ln(x), sh_m, sc_m)
    return x + g_m[:, None, :] * (F.gelu(h @ layer["w1"], approximate="tanh") @ layer["w2"])


def _head(params, x):
    return x @ params["out"] + x  # residual head


def _jvp_attention(q, k, v):
    return attention_jvp(q, k, v, causal=False)


def dit_forward(params, x, t, cfg: DiTConfig, attention=None):
    """x [B, N, D] (patched latents), t [B] -> the velocity field u [B, N, D].

    attention: (q, k, v) -> O, non-causal on [b, h, n, d]. The default is
    `attention_jvp` (fp32 forward; under forward-mode AD its tangent rule
    runs B10, under reverse mode the exact flash backward).
    """
    attention = _jvp_attention if attention is None else attention
    temb = _temb(params, t)
    for layer in params["layers"]:
        q, k, v, *ada = _pre_attention(layer, x, temb, cfg)
        x = _post_attention(layer, x, attention(q, k, v), *ada)
    return _head(params, x)


def _pair_pass(params, x, t, dx_dt, cfg: DiTConfig, pair):
    """(u, du/dt) along the tangent (dx_dt, 1): the segments under
    torch.func.jvp, each attention by `pair` (q, k, v, tq, tk, tv) -> (O, tO)
    on explicit (primal, tangent) pairs."""
    jvp = torch.func.jvp
    temb, ttemb = jvp(lambda t_: _temb(params, t_), (t,), (torch.ones_like(t),))
    tx = dx_dt
    for layer in params["layers"]:
        (q, k, v, *ada), (tq, tk, tv, *tada) = jvp(
            lambda x_, e_: _pre_attention(layer, x_, e_, cfg), (x, temb), (tx, ttemb))
        o, to = pair(q, k, v, tq, tk, tv)
        x, tx = jvp(lambda x_, o_, *a_: _post_attention(layer, x_, o_, *a_),
                    (x, o, *ada), (tx, to, *tada))
    return jvp(lambda x_: _head(params, x_), (x,), (tx,))


def dit_jvp_step(params, x_t, t, cfg: DiTConfig, fast: bool = True, dx_dt=None):
    """(u, du/dt) along the probability-flow ODE, differentiable in reverse mode.

    The tangent direction is (dx/dt, dt/dt = 1). A given dx_dt [B, N, D] is
    that direction and no prepass runs; with None, dx/dt is the model's own
    velocity from a prepass under no_grad (stop-gradient: rCM treats the
    direction as data), whose attention is `attention_jvp`'s fp32 forward.
    Then each attention runs `attention_value_and_jvp(fast=)` on explicit
    (primal, tangent) pairs; the segments between run under torch.func.jvp.
    """
    if dx_dt is None:
        with torch.no_grad():
            dx_dt = dit_forward(params, x_t, t, cfg)

    def pair(*qkv_and_tangents):
        return attention_value_and_jvp(*qkv_and_tangents, causal=False, fast=fast)

    return _pair_pass(params, x_t, t, dx_dt, cfg, pair)


def rcm_loss(params, x, t, cfg: DiTConfig, fast: bool = True):
    """The rCM self-consistency surrogate: mean(du/dt^2) + 0.1 mean(u^2)."""
    u, dudt = dit_jvp_step(params, x, t, cfg, fast=fast)
    return dudt.square().mean() + 0.1 * u.square().mean()


def _sharded_rcm_loss(params, x, t, cfg: DiTConfig, fast: bool, mesh, data_axis: str,
                      context_axis: str):
    """(this rank's share of the rCM loss, for backward; the global count) on
    its (data, context) block x [B_loc, N_loc, D] and data block t [B_loc]
    (JAX models/dit.py:205-227): the direction from a no-grad prepass
    through the bf16 ring, (u, du/dt) through the JVP ring, and the local
    sum of du/dt^2 + 0.1 u^2 over the global element count."""
    def plain_ring(q, k, v):
        return ring_attention(q, k, v, mesh, context_axis, causal=False, kind="bf16")

    def pair(*qkv_and_tangents):
        return ring_attention_jvp(*qkv_and_tangents, mesh, context_axis, causal=False,
                                  fast=fast)

    with torch.no_grad():
        dx_dt = dit_forward(params, x, t, cfg, attention=plain_ring)
    u, dudt = _pair_pass(params, x, t, dx_dt, cfg, pair)
    count = u.numel() * axis_size(mesh, data_axis) * axis_size(mesh, context_axis)
    return (dudt.square().sum() + 0.1 * u.square().sum()) / count


def make_dit_rcm_step(cfg: DiTConfig, params, optimizer=None, fast: bool = True, mesh=None,
                      data_axis: str = "data", context_axis: str = "context"):
    """(optimizer, step) with step(x, t) -> loss, a 0-d tensor.

    Counterpart of examples/distill_dit.py's loop and of the JAX
    `make_dit_rcm_step`. As the LM's `make_train_step`, every param becomes
    a leaf that requires grad and `step` updates them in place; it returns
    the loss without a sync. The default optimizer matches
    `optax.adamw(1e-4)`: lr 1e-4, betas (0.9, 0.999), eps 1e-8, weight
    decay 1e-4. A caller's optimizer must be built over
    `dit_param_leaves(params)`.

    mesh=None: one device, x [B, N, D] and t [B]. With a mesh (every rank
    runs the step on the whole params): x is this rank's (data_axis,
    context_axis) block [B / data, N / context, D] and t its data block
    [B / data]; attention runs the rings over context_axis, the loss is the
    global mean (the same on every rank) and every gradient is summed over
    data_axis and context_axis (an axis the step does not use, as model,
    replicates the computation and sums nothing).
    """
    leaves = dit_param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
    axes = (data_axis, context_axis)

    def step(x, t):
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss = rcm_loss(params, x, t, cfg, fast)
            loss.backward()
            optimizer.step()
            return loss.detach()
        loss = _sharded_rcm_loss(params, x, t, cfg, fast, mesh, *axes)
        loss.backward()
        _psum_grads(leaves, mesh, axes)
        optimizer.step()
        total = loss.detach().clone().reshape(1)
        for a in axes:
            psum(total, mesh, a)
        return total[0]

    return optimizer, step
