"""Decoder-only transformer LM on the ported kernels.

Counterpart of quantizedattention_tpu/models/transformer.py: RMSNorm pre-norm
blocks, interleaved-pair RoPE, GQA projections, tanh-form GELU MLP. Params are
a plain dict of tensors with the JAX package's names and shapes (weights
[in, out], projections `x @ w`), so `models.convert.params_from_jax` carries
them over unchanged. Every forward, training and prefill alike, runs the
configured attention through `_attention`: the corrected-bf16 flash
attention (forward B1, backward B2 + B3) or, with `attention="int8"`, the
int8 SageAttention path (B4 quantizes, B5 attends; backward B7 + B8; under
no_grad, as in prefill, the forward alone). Decode appends to the int8 KV
cache and runs the int8 decode kernel. Matmuls go through
`quantize.weights.mm` and gathers through `embedding_lookup`, so params
with weight-only int8/int4 leaves (`quantize_lm_weights`) run B17/B18.

Speculative verify, chunked prefill and top-k/top-p sampling are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch.ops.api import flash_attention_bf16, sage_attention_int8
from quantizedattention_tpu_torch.parallel.kv_cache import (
    append_kv,
    decode_attention,
    init_kv_cache,
    write_kv_slot,
)
from quantizedattention_tpu_torch.quantize.weights import embedding_lookup, mm


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 512
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    n_layers: int = 2
    mlp_ratio: int = 4
    max_seq: int = 512
    attention: str = "bf16"  # "bf16" | "int8"
    rope_base: float = 10000.0

    @property
    def mlp_dim(self) -> int:
        return self.d_model * self.mlp_ratio


def init_transformer(cfg: TransformerConfig, generator: torch.Generator, device,
                     dtype=torch.float32):
    """Random params with the JAX package's shapes and scales: embed
    N(0, 0.02), linears N(0, 1/fan_in), norms 1. Drawn in f32 on the
    generator's device, then moved to `device` as `dtype`."""

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale
        return x.to(device=device, dtype=dtype)

    def linear(n_in, n_out):
        return normal((n_in, n_out), 1.0 / math.sqrt(n_in))

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=device)

    params = {
        "embed": normal((cfg.vocab_size, cfg.d_model), 0.02),
        "unembed": linear(cfg.d_model, cfg.vocab_size),
        "final_norm": ones(),
        "layers": [],
    }
    q_dim, kv_dim = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": ones(),
            "wq": linear(cfg.d_model, q_dim),
            "wk": linear(cfg.d_model, kv_dim),
            "wv": linear(cfg.d_model, kv_dim),
            "wo": linear(q_dim, cfg.d_model),
            "ln2": ones(),
            "w1": linear(cfg.d_model, cfg.mlp_dim),
            "w2": linear(cfg.mlp_dim, cfg.d_model),
        })
    return params


def rmsnorm(x, scale, eps=1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope(x, positions, base: float):
    """Rotary embedding on [b, h, tokens, head_dim], rotating interleaved
    pairs (x[0::2], x[1::2]).

    positions: [tokens] (shared across the batch) or [b, tokens] (per row,
    the continuous-batching decode case).
    """
    d = x.shape[-1]
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[..., None].float() * freqs  # [..., t, d/2]
    if angles.ndim == 3:  # [b, t, d/2] -> broadcast over the head axis
        angles = angles[:, None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _attention(q, k, v, cfg: TransformerConfig):
    """Causal attention of every forward; GQA-native (k/v keep their kv
    heads), as the JAX model's `_attention` (transformer.py:129-142)."""
    if cfg.attention == "int8":
        return sage_attention_int8(q, k, v, causal=True)
    return flash_attention_bf16(q, k, v, causal=True)


def _project_qkv(layer, x, cfg: TransformerConfig, positions):
    b, t, _ = x.shape
    q = mm(x, layer["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    k = mm(x, layer["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    v = mm(x, layer["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    return rope(q, positions, cfg.rope_base), rope(k, positions, cfg.rope_base), v


def _merge_heads(o, cfg: TransformerConfig, dtype):
    b, _, t, _ = o.shape
    return o.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.head_dim).to(dtype)


def _mlp_residual(layer, x):
    h = rmsnorm(x, layer["ln2"])
    return x + mm(F.gelu(mm(h, layer["w1"]), approximate="tanh"), layer["w2"])


def _block(layer, x, cfg: TransformerConfig, positions):
    h = rmsnorm(x, layer["ln1"])
    q, k, v = _project_qkv(layer, h, cfg, positions)
    o = _attention(q, k, v, cfg)
    return _mlp_residual(layer, x + mm(_merge_heads(o, cfg, x.dtype), layer["wo"]))


def transformer_forward(params, tokens, cfg: TransformerConfig):
    """tokens [B, T] -> logits [B, T, vocab] (the params' dtype).
    Differentiable: gradients flow to every param that requires them."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embedding_lookup(params["embed"], tokens)
    for layer in params["layers"]:
        x = _block(layer, x, cfg, positions)
    x = rmsnorm(x, params["final_norm"])
    return mm(x, params["unembed"])


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def lm_loss(params, tokens, targets, cfg: TransformerConfig):
    """Mean next-token cross entropy of an f32 log-softmax; targets are the
    pre-shifted labels [B, T]."""
    logits = transformer_forward(params, tokens, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def param_leaves(params) -> list[torch.Tensor]:
    """The params dict's tensors in a fixed order (top level, then layers)."""
    top = [params[key] for key in ("embed", "unembed", "final_norm")]
    return top + [t for layer in params["layers"] for t in layer.values()]


def make_train_step(cfg: TransformerConfig, params, optimizer=None):
    """(optimizer, step) with step(tokens, targets) -> loss, a 0-d tensor.

    The JAX step is pure: it returns new params and optimizer state. Here,
    in PyTorch's idiom, `params` are the model's state: every tensor is made
    a leaf that requires grad, and `step` updates them in place through the
    optimizer. It returns the loss without waiting for the device. The
    default optimizer matches `optax.adamw(3e-4)`: AdamW with betas
    (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's default decay is
    1e-2). A caller's optimizer must be built over `param_leaves(params)`.
    """
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)

    def step(tokens, targets):
        optimizer.zero_grad(set_to_none=True)
        loss = lm_loss(params, tokens, targets, cfg)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return optimizer, step


# --------------------------------------------------------------------------
# Sampling and KV-cache decoding
# --------------------------------------------------------------------------

def sample_token(logits, temperature: float = 0.0, generator: torch.Generator | None = None):
    """Greedy (temperature 0 or no generator) or temperature-scaled
    categorical sampling. Accepts [vocab] or [batch, vocab] logits; returns
    int64 token ids (one draw per row)."""
    if temperature < 0.0:
        raise ValueError("temperature must be >= 0")
    if temperature == 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    draws = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return draws.reshape(probs.shape[:-1])


@torch.no_grad()
def _decode_logits(params, caches, last_tok, pos, active, cfg: TransformerConfig):
    """One batched decode step's logits [n_slots, vocab] (caches updated in
    place)."""
    x = embedding_lookup(params["embed"], last_tok)[:, None, :]
    positions = pos[:, None]  # [n_slots, 1]: per-row RoPE
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = append_kv(cache, k, v, active=active)
        o = decode_attention(q[:, :, 0, :], cache)  # GQA-native
        o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
        x = _mlp_residual(layer, x + mm(o, layer["wo"]))
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    return mm(x[:, 0], params["unembed"]), new_caches


def decode_step_batched(params, caches, last_tok, pos, active, cfg: TransformerConfig,
                        temperature: float = 0.0, generator=None):
    """One continuous-batching decode step over all cache slots at once.

    last_tok/pos/active: [n_slots]; every slot sits at its own position;
    inactive slots ride along but never advance their cache. Returns
    (next_tok [n_slots], caches).
    """
    logits, caches = _decode_logits(params, caches, last_tok, pos, active, cfg)
    return sample_token(logits, temperature, generator), caches


def decode_horizon_batched(params, caches, last_tok, pos, active, cfg: TransformerConfig,
                           horizon: int, temperature: float = 0.0, generator=None):
    """`horizon` chained decode steps with every step's token banked:
    returns (tokens [horizon, n_slots], caches, last_tok, pos). Nothing in
    the loop waits for the device; the caller fetches the bank once."""
    bank = []
    step = active.to(pos.dtype)
    for _ in range(horizon):
        last_tok, caches = decode_step_batched(
            params, caches, last_tok, pos, active, cfg, temperature, generator)
        bank.append(last_tok)
        pos = pos + step
    return torch.stack(bank), caches, last_tok, pos


@torch.no_grad()
def prefill_slot(params, caches, tokens, true_len: int, slot: int, cfg: TransformerConfig,
                 temperature: float = 0.0, generator=None):
    """Fused prefill of one request into cache row `slot`.

    tokens: [t_pad] prompt right-padded past `true_len` (causal masking keeps
    the padding out of every real row, and the slot's length is set to
    true_len). Returns (first generated token [scalar], caches).
    """
    x = embedding_lookup(params["embed"], tokens)[None]
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = write_kv_slot(cache, slot, k[0], v[0], true_len)
        o = _attention(q, k, v, cfg)
        x = _mlp_residual(layer, x + mm(_merge_heads(o, cfg, x.dtype), layer["wo"]))
        new_caches.append(cache)
    # final norm on the sampled rows only (it is per row)
    logits = mm(rmsnorm(x[0, true_len - 1], params["final_norm"]), params["unembed"])
    return sample_token(logits, temperature, generator), new_caches


@torch.no_grad()
def prefill_slots(params, caches, tokens, true_lens, slots, cfg: TransformerConfig,
                  temperature: float = 0.0, generator=None):
    """Fused prefill of several requests in one pass: tokens [B, t_pad]
    (right-padded to a shared length), true_lens [B] and slots [B] integer
    tensors on the params' device. Returns (first tokens [B], caches)."""
    B, t_pad = tokens.shape
    x = embedding_lookup(params["embed"], tokens)
    positions = torch.arange(t_pad, device=tokens.device)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        for i in range(B):
            cache = write_kv_slot(cache, slots[i:i + 1], k[i], v[i], true_lens[i:i + 1])
        o = _attention(q, k, v, cfg)
        x = _mlp_residual(layer, x + mm(_merge_heads(o, cfg, x.dtype), layer["wo"]))
        new_caches.append(cache)
    last = x[torch.arange(B, device=tokens.device), true_lens.long() - 1]
    logits = mm(rmsnorm(last, params["final_norm"]), params["unembed"])
    return sample_token(logits, temperature, generator), new_caches


@torch.no_grad()
def prefill_batched(params, caches, prompt, cfg: TransformerConfig,
                    temperature: float = 0.0, generator=None):
    """Fused prefill of a same-length batch prompt [B, T0], K/V appended to
    every cache row (all rows at length 0). Returns (next_tok [B], caches)."""
    positions = torch.arange(prompt.shape[1], device=prompt.device)
    x = embedding_lookup(params["embed"], prompt)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = append_kv(cache, k, v)
        o = _attention(q, k, v, cfg)
        x = _mlp_residual(layer, x + mm(_merge_heads(o, cfg, x.dtype), layer["wo"]))
        new_caches.append(cache)
    logits = mm(rmsnorm(x[:, -1], params["final_norm"]), params["unembed"])
    return sample_token(logits, temperature, generator), new_caches


def generate(params, prompt, cfg: TransformerConfig, max_new_tokens: int = 16,
             temperature: float = 0.0, generator=None):
    """Decoding with the int8 KV cache: one fused prefill over the prompt,
    then batched single-token decode steps (the serving engine's numerics).
    Greedy by default; temperature > 0 samples with `generator`.

    prompt: [B, T0] integer tensor on the params' device; returns
    [B, T0 + max_new_tokens] int64.
    """
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    b, t0 = prompt.shape
    dev = prompt.device
    prompt = prompt.long()
    caches = [init_kv_cache(b, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim, dev)
              for _ in params["layers"]]
    next_tok, caches = prefill_batched(params, caches, prompt, cfg, temperature, generator)
    tokens = [prompt]
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        tokens.append(next_tok[:, None])
        if i < max_new_tokens - 1:
            pos = torch.full((b,), t0 + i, dtype=torch.long, device=dev)
            next_tok, caches = decode_step_batched(
                params, caches, next_tok, pos, active, cfg, temperature, generator)
    return torch.cat(tokens, dim=1)
