"""Flow-matching DiT on the JVP attention kernels, and its rCM distillation step.

Counterpart of quantizedattention_tpu/models/dit.py on one device. The model
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

from quantizedattention_tpu_torch.ops.api import attention_jvp, attention_value_and_jvp

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


def dit_forward(params, x, t, cfg: DiTConfig):
    """x [B, N, D] (patched latents), t [B] -> the velocity field u [B, N, D].

    Attention is `attention_jvp` (fp32 forward; under forward-mode AD its
    tangent rule runs B10, under reverse mode the exact flash backward).
    """
    temb = _temb(params, t)
    for layer in params["layers"]:
        q, k, v, *ada = _pre_attention(layer, x, temb, cfg)
        x = _post_attention(layer, x, attention_jvp(q, k, v, causal=False), *ada)
    return _head(params, x)


def dit_jvp_step(params, x_t, t, cfg: DiTConfig, fast: bool = True):
    """(u, du/dt) along the probability-flow ODE, differentiable in reverse mode.

    The tangent direction is (dx/dt, dt/dt = 1), dx/dt being the model's own
    velocity from a prepass under no_grad (stop-gradient: rCM treats the
    direction as data), whose attention is `attention_jvp`'s fp32 forward.
    Then each attention runs `attention_value_and_jvp(fast=)` on explicit
    (primal, tangent) pairs; the segments between run under torch.func.jvp.
    """
    with torch.no_grad():
        dx_dt = dit_forward(params, x_t, t, cfg)
    jvp = torch.func.jvp
    temb, ttemb = jvp(lambda t_: _temb(params, t_), (t,), (torch.ones_like(t),))
    x, tx = x_t, dx_dt
    for layer in params["layers"]:
        (q, k, v, *ada), (tq, tk, tv, *tada) = jvp(
            lambda x_, e_: _pre_attention(layer, x_, e_, cfg), (x, temb), (tx, ttemb))
        o, to = attention_value_and_jvp(q, k, v, tq, tk, tv, causal=False, fast=fast)
        x, tx = jvp(lambda x_, o_, *a_: _post_attention(layer, x_, o_, *a_),
                    (x, o, *ada), (tx, to, *tada))
    return jvp(lambda x_: _head(params, x_), (x,), (tx,))


def rcm_loss(params, x, t, cfg: DiTConfig, fast: bool = True):
    """The rCM self-consistency surrogate: mean(du/dt^2) + 0.1 mean(u^2)."""
    u, dudt = dit_jvp_step(params, x, t, cfg, fast=fast)
    return dudt.square().mean() + 0.1 * u.square().mean()


def make_dit_rcm_step(cfg: DiTConfig, params, optimizer=None, fast: bool = True):
    """(optimizer, step) with step(x, t) -> loss, a 0-d tensor, on one device.

    Counterpart of examples/distill_dit.py's loop and of the loss of the JAX
    `make_dit_rcm_step` (its mesh arguments are not ported). As the LM's
    `make_train_step`, every param becomes a leaf that requires grad and
    `step` updates them in place; it returns the loss without a sync. The
    default optimizer matches `optax.adamw(1e-4)`: lr 1e-4, betas
    (0.9, 0.999), eps 1e-8, weight decay 1e-4. A caller's optimizer must be
    built over `dit_param_leaves(params)`.
    """
    leaves = dit_param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)

    def step(x, t):
        optimizer.zero_grad(set_to_none=True)
        loss = rcm_loss(params, x, t, cfg, fast)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return optimizer, step
