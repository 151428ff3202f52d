"""Decoder-only transformer LM on the ported kernels.

Counterpart of quantizedattention_tpu/models/transformer.py: RMSNorm pre-norm
blocks, interleaved-pair RoPE, GQA projections, tanh-form GELU MLP. Params are
a plain dict of tensors with the JAX package's names and shapes (weights
[in, out], projections `x @ w`), so `models.convert.params_from_jax` carries
them over unchanged. Every forward, training and prefill alike, runs the
configured attention through `_attention`: the corrected-bf16 flash
attention (forward B1, backward B2 + B3) or, with `attention="int8"`, the
int8 SageAttention path (B4 quantizes, B5 attends; backward B7 + B8; under
no_grad, as in prefill, the forward alone). Decode appends to the KV cache
and attends through its kind's kernel: the slotted int8 cache (B13), the
slotted int4 cache (B15), the paged int8 pool (B14) or the paged int4 pool
(B16), dispatched by the cache's type as the JAX model does
(`_cache_append`, `_cache_decode`, `_cache_write_slot`). Speculative
verification (`verify_step_batched`) appends s tokens per row, attends
through the same kernel's staircase (`_cache_verify`) and rolls rejected
tokens back (`_cache_rollback`). Matmuls go through `quantize.weights.mm`
and gathers through `embedding_lookup`, so params with weight-only
int8/int4 leaves (`quantize_lm_weights`) run B17/B18.

Chunked prefill (`prefill_chunk`) runs a long prompt through in chunks: a
chunk attends causally to itself and non-causally to the cache's
dequantized prefix, both through B1 bf16, and the two partials merge by
their lse (parallel/ring.py). Sampling takes a float temperature or a
`Sampling` spec (temperature, top-k, top-p) wherever it takes a
temperature.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch.ops.api import flash_attention_bf16, sage_attention_int8
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu_torch.parallel.kv4_cache import (
    Int4KVCache,
    append_kv4,
    decode_attention_int4,
    install_kv4_batched,
    read_prefix_kv4,
    verify_decode_attention_int4,
    write_kv4_chunk,
    write_kv4_slot,
)
from quantizedattention_tpu_torch.parallel.kv_cache import (
    append_kv,
    decode_attention,
    init_kv_cache,
    read_prefix_kv,
    verify_decode_attention,
    write_kv_chunk,
    write_kv_slot,
)
from quantizedattention_tpu_torch.parallel.paged4_cache import (
    Paged4KVCache,
    append_tokens_paged4,
    paged4_decode_attention,
    paged4_verify_attention,
    read_prefix_paged4,
    write_chunk_paged4,
    write_prompt_paged4,
)
from quantizedattention_tpu_torch.parallel.paged_cache import (
    PagedKVCache,
    append_tokens_paged,
    paged_decode_attention,
    paged_verify_attention,
    read_prefix_paged,
    write_chunk_paged,
    write_prompt_paged,
)
from quantizedattention_tpu_torch.parallel.ring import _merge_partials
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


def _no_psum(x):
    return x


def _mlp_residual(layer, x, psum=_no_psum, to_model=_no_psum):
    """x + MLP(x). `psum` sums the down projection's partial products over
    the mesh's model axis where w1/w2 are sharded on it (serve/engine.py's
    mesh steps, models/sharded_train.py); `to_model` marks the normed input
    of the column-parallel w1 (the sharded train step sums its gradient over
    model). On one device both are the identity."""
    h = to_model(rmsnorm(x, layer["ln2"]))
    return x + psum(mm(F.gelu(mm(h, layer["w1"]), approximate="tanh"), layer["w2"]))


def _mlp_residual_per_position(layer, x, psum=_no_psum):
    """`_mlp_residual` with the down projection run one token position at a
    time on contiguous rows, so that each is the [n, d_ff] product of a
    decode step. On an H100 the [n * s, d_ff] product, or one on strided
    rows, takes another algorithm for its long contraction and rounds some
    outputs one bf16 ulp apart, and a verify pass would then not be its
    decode steps bit for bit (its int4 K/V rounding to other nibbles, its
    greedy tokens to other tokens at close logits). One copy puts each
    position's rows together: s products and a stack where the whole
    product is one launch."""
    h = F.gelu(mm(rmsnorm(x, layer["ln2"]), layer["w1"]), approximate="tanh")
    by_position = h.transpose(0, 1).contiguous()  # [s, n, d_ff]
    return x + psum(torch.stack([mm(rows, layer["w2"]) for rows in by_position], dim=1))


def _block(layer, x, cfg: TransformerConfig, positions, attention_fn=None, psum=_no_psum,
           to_model=_no_psum):
    h = to_model(rmsnorm(x, layer["ln1"]))
    q, k, v = _project_qkv(layer, h, cfg, positions)
    o = attention_fn(q, k, v) if attention_fn is not None else _attention(q, k, v, cfg)
    x = x + psum(mm(_merge_heads(o, cfg, x.dtype), layer["wo"]))
    return _mlp_residual(layer, x, psum, to_model)


def transformer_forward(params, tokens, cfg: TransformerConfig, attention_fn=None,
                        positions=None, psum=_no_psum, to_model=_no_psum):
    """tokens [B, T] -> logits [B, T, vocab] (the params' dtype).
    Differentiable: gradients flow to every param that requires them.

    The hooks, for models/sharded_train.py's ranks (identities, and
    `_attention` on positions 0..T-1, on one device): `attention_fn(q, k, v)`
    in place of `_attention`, the tokens' global RoPE `positions`, `psum`
    after the row-parallel wo and w2, `to_model` on the normed inputs of the
    column-parallel wq/wk/wv and w1."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embedding_lookup(params["embed"], tokens)
    for layer in params["layers"]:
        x = _block(layer, x, cfg, positions, attention_fn, psum, to_model)
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

# Cache-kind dispatch (the JAX model's, transformer.py:218-254): slotted
# int8 (QuantizedKVCache), slotted int4 (Int4KVCache), paged int8
# (PagedKVCache), paged int4 (Paged4KVCache). A paged cache's sequence id is
# the engine's slot.

def _cache_append(cache, k, v, active=None):
    if isinstance(cache, PagedKVCache):
        return append_tokens_paged(cache, k, v, active)
    if isinstance(cache, Paged4KVCache):
        return append_tokens_paged4(cache, k, v, active)
    if isinstance(cache, Int4KVCache):
        return append_kv4(cache, k, v, active=active)
    return append_kv(cache, k, v, active=active)


def _cache_install_batch(cache, k, v):
    """Whole-batch prompt install into all-fresh rows (prefill_batched's
    contract: every row at length 0); int4 packs whole blocks at once."""
    if isinstance(cache, Int4KVCache):
        return install_kv4_batched(cache, k, v)
    return _cache_append(cache, k, v)


def _cache_decode(q, cache):
    if isinstance(cache, PagedKVCache):
        return paged_decode_attention(q, cache)
    if isinstance(cache, Paged4KVCache):
        return paged4_decode_attention(q, cache)
    if isinstance(cache, Int4KVCache):
        return decode_attention_int4(q, cache)
    return decode_attention(q, cache)


def _cache_write_slot(cache, slot, k, v, true_len):
    if isinstance(cache, PagedKVCache):
        return write_prompt_paged(cache, slot, k, v, true_len)
    if isinstance(cache, Paged4KVCache):
        return write_prompt_paged4(cache, slot, k, v, true_len)
    if isinstance(cache, Int4KVCache):
        return write_kv4_slot(cache, slot, k, v, true_len)
    return write_kv_slot(cache, slot, k, v, true_len)


def _cache_verify(q, cache):
    if isinstance(cache, PagedKVCache):
        return paged_verify_attention(q, cache)
    if isinstance(cache, Paged4KVCache):
        return paged4_verify_attention(q, cache)
    if isinstance(cache, Int4KVCache):
        return verify_decode_attention_int4(q, cache)
    return verify_decode_attention(q, cache)


def _cache_write_chunk(cache, slot: int, k, v, chunk_start: int, new_len: int):
    """A chunked prefill's write of [h_kv, c, d] K/V at chunk_start, cut at
    the capacity first (JAX transformer.py:573-590): the last chunk is
    padded to the full chunk, and its overhang past max_len (slotted) or
    past the table (paged) is padding only."""
    if isinstance(cache, (PagedKVCache, Paged4KVCache)):
        ps = cache.page_size
        c_write = min(k.shape[1], cache.page_table.shape[1] * ps - chunk_start)
        write = write_chunk_paged4 if isinstance(cache, Paged4KVCache) else write_chunk_paged
        return write(cache, slot, k[:, :c_write], v[:, :c_write], chunk_start // ps, new_len)
    c_write = min(k.shape[1], cache.max_len - chunk_start)
    write = write_kv4_chunk if isinstance(cache, Int4KVCache) else write_kv_chunk
    return write(cache, slot, k[:, :c_write], v[:, :c_write], chunk_start, new_len)


def _cache_read_prefix(cache, slot: int, n_tokens: int):
    """The dequantized f32 K/V [h_kv, n_tokens, d] of the row's first
    n_tokens: what every later decode step reads."""
    if isinstance(cache, PagedKVCache):
        return read_prefix_paged(cache, slot, n_tokens)
    if isinstance(cache, Paged4KVCache):
        return read_prefix_paged4(cache, slot, n_tokens)
    if isinstance(cache, Int4KVCache):
        return read_prefix_kv4(cache, slot, n_tokens)
    return read_prefix_kv(cache, slot, n_tokens)


def _cache_rollback(cache, drop):
    """Shrink the live token counts by `drop` [b] IN PLACE (speculative
    rejection: later appends overwrite the stale entries)."""
    lengths = cache.lengths if isinstance(cache, (PagedKVCache, Paged4KVCache)) else cache.length
    lengths.sub_(drop.to(lengths.dtype))
    return cache


@dataclasses.dataclass(frozen=True)
class Sampling:
    """Sampling spec: temperature scaling, then top-k and nucleus (top-p)
    filtering, in that order (the JAX package's `Sampling`,
    transformer.py:277-303). Every function that takes a temperature takes
    one; a plain float means temperature only. top_k=0 and top_p=1.0 turn
    their filter off; the nucleus keeps at least one token."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")


def sampling_temperature(temperature) -> float:
    """The float temperature of a float-or-Sampling `temperature` value."""
    return temperature.temperature if isinstance(temperature, Sampling) else float(temperature)


def _spec(temperature) -> Sampling:
    return temperature if isinstance(temperature, Sampling) else Sampling(float(temperature))


def _filter_logits(scaled, spec: Sampling):
    """Temperature-scaled logits [..., vocab] with the entries outside the
    top-k / top-p set set to -inf (JAX transformer.py:314-332). Top-k keeps
    the k highest (every tie of the k-th included); top-p keeps the sorted
    prefix whose preceding probability mass is below top_p (the first token
    always), ties at the cut included."""
    if 0 < spec.top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, spec.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if spec.top_p < 1.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        top_p = torch.tensor(spec.top_p, dtype=probs.dtype)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        cut = torch.gather(srt, -1, keep.sum(-1, keepdim=True) - 1)
        scaled = torch.where(scaled < cut, -torch.inf, scaled)
    return scaled


def sample_token(logits, temperature=0.0, generator: torch.Generator | None = None):
    """Greedy (temperature 0 or no generator), temperature-scaled
    categorical, or, with a `Sampling` spec, top-k / top-p filtered
    sampling. Accepts [vocab] or [batch, vocab] logits; returns int64 token
    ids (one draw per row)."""
    spec = _spec(temperature)
    if spec.temperature == 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter_logits(logits.float() / spec.temperature, spec), dim=-1)
    draws = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return draws.reshape(probs.shape[:-1])


@torch.no_grad()
def _decode_logits(params, caches, last_tok, pos, active, cfg: TransformerConfig,
                   psum=_no_psum):
    """One batched decode step's logits [n_slots, vocab] (caches updated in
    place). Under a mesh (serve/engine.py) the rows are a data shard's
    slots, `cfg` counts this rank's heads and `psum` sums the out and down
    projections over the model axis."""
    x = embedding_lookup(params["embed"], last_tok)[:, None, :]
    positions = pos[:, None]  # [n_slots, 1]: per-row RoPE
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = _cache_append(cache, k, v, active=active)
        o = _cache_decode(q[:, :, 0, :], cache)  # GQA-native
        o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
        x = _mlp_residual(layer, x + psum(mm(o, layer["wo"])), psum)
        new_caches.append(cache)
    x = rmsnorm(x, params["final_norm"])
    return mm(x[:, 0], params["unembed"]), new_caches


def decode_step_batched(params, caches, last_tok, pos, active, cfg: TransformerConfig,
                        temperature=0.0, generator=None):
    """One continuous-batching decode step over all cache slots at once.

    last_tok/pos/active: [n_slots]; every slot sits at its own position;
    inactive slots ride along but never advance their cache. Returns
    (next_tok [n_slots], caches).
    """
    logits, caches = _decode_logits(params, caches, last_tok, pos, active, cfg)
    return sample_token(logits, temperature, generator), caches


_MASK32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (the lowbias32 finalizer's shifts, multipliers
    below 2^31 so every product fits int64): values in [0, 2^32) -> [0, 2^32).
    Works on Python ints and on int64 tensors alike."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _MASK32
    return x ^ (x >> 16)


def gumbel_draws(logits, temperature, seed: int, rows, positions):
    """One categorical draw per (row, position) from softmax(logits / T),
    by Gumbel-max: argmax(logits / T - log(-log u)). The uniform u of vocab
    id v is a counter-based hash of (seed, row, position, v), computed on the
    logits' device with int64 tensor ops: no generator state and no host
    sync, and a draw depends only on where it lands, so the same seed
    replays the same token at the same (row, position) however many drafts
    were in flight. `temperature` is a float or a `Sampling` spec, whose
    top-k / top-p filter (`_filter_logits` on the f32 logits / T) takes the
    ids outside its set out of the argmax: the draw then follows the
    filtered softmax. logits [n, s, V]; rows [n] and positions [n, s]
    integer tensors. Returns int64 [n, s]."""
    spec = _spec(temperature)
    key = _mix32(_mix32(seed & _MASK32) ^ ((seed >> 32) & _MASK32))
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    h = _mix32(key ^ rows.long()[:, None])
    h = _mix32(h ^ (positions.long() & _MASK32))  # [n, s]
    h = _mix32(_mix32(h[..., None] ^ vocab) ^ (h[..., None] >> 5))  # [n, s, V]
    u = (h.double() + 0.5) * 2.0 ** -32  # in (0, 1)
    z = logits.double() / spec.temperature - torch.log(-torch.log(u))
    if spec.top_k > 0 or spec.top_p < 1.0:
        kept = torch.isfinite(_filter_logits(logits.float() / spec.temperature, spec))
        z = torch.where(kept, z, -torch.inf)
    return torch.argmax(z, dim=-1)


@torch.no_grad()
def _verify_logits(params, caches, last_tok, draft, pos, active, cfg: TransformerConfig,
                   psum=_no_psum):
    """One verify pass's logits [n_slots, s, vocab] over last_tok and the
    s - 1 drafts of each slot (caches appended in place, not rolled back);
    `psum` as in `_decode_logits`."""
    s = draft.shape[1] + 1
    tokens = torch.cat([last_tok[:, None].long(), draft.long()], dim=1)  # [n, s]
    x = embedding_lookup(params["embed"], tokens)
    positions = pos.long()[:, None] + torch.arange(s, device=pos.device)  # per-row RoPE
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = _cache_append(cache, k, v, active=active)
        o = _cache_verify(q, cache)  # [n, H, s, d], the causal staircase
        x = _mlp_residual_per_position(
            layer, x + psum(mm(_merge_heads(o, cfg, x.dtype), layer["wo"])), psum)
        new_caches.append(cache)
    return mm(rmsnorm(x, params["final_norm"]), params["unembed"]), new_caches


def verify_step_batched(params, caches, last_tok, draft, pos, active, cfg: TransformerConfig,
                        temperature=0.0, seed: int | None = None, psum=_no_psum, row0: int = 0):
    """Speculative-verification decode step: one pass scores the last
    accepted token and s - 1 draft tokens per slot and emits between 1 and s
    tokens per slot, token-exact with s plain decode steps, because every
    draft token is checked against the model's own target before it counts
    (the JAX package's verify_step_batched).

    Greedy (temperature 0 or seed None): the target is the argmax. Sampled:
    the target at each position is a draw from softmax(logits / T), top-k /
    top-p filtered first when `temperature` is a `Sampling` spec, keyed by
    (seed, slot row, the absolute position it predicts) (`gumbel_draws`);
    drafts are accepted while they equal the draws, and the first draw that
    differs is the emitted token. For a deterministic drafter (the engine's
    n-gram lookup) that is rejection sampling, exact in law, and the stream
    equals a draft-free verify loop's under the same seed, draw for draw.

    last_tok/pos/active: [n_slots] as in decode_step_batched (pos is
    last_tok's position, the row's cache length). draft: [n_slots, s - 1]
    integer tensor (s = 1: no drafts). All s tokens' K/V are appended; the
    rejected ones are rolled back by shrinking the lengths in place.
    Returns (emitted [n_slots, s] int64, n_emit [n_slots] int64, caches):
    per row, emitted[:n_emit] are the accepted drafts followed by the
    model's own next token, so n_emit >= 1. Under a mesh the rows are a data
    shard's slots, the first of them global row `row0`, and `psum` is as in
    `_decode_logits`.
    """
    n_slots, s = draft.shape[0], draft.shape[1] + 1
    logits, new_caches = _verify_logits(params, caches, last_tok, draft, pos, active, cfg, psum)
    if sampling_temperature(temperature) == 0.0 or seed is None:
        targets = torch.argmax(logits, dim=-1)
    else:
        # target t predicts the token at position pos + t + 1
        rows = torch.arange(row0, row0 + n_slots, device=logits.device)
        out_pos = pos.long()[:, None] + torch.arange(1, s + 1, device=pos.device)
        targets = gumbel_draws(logits.float(), temperature, seed, rows, out_pos)
    # accept the longest prefix of drafts that matches the targets
    match = (draft.long() == targets[:, :-1]).long()
    n_acc = torch.cumprod(match, dim=1).sum(1)  # [n] in [0, s - 1]
    drafted = F.pad(draft.long(), (0, 1))
    emitted = torch.where(torch.arange(s, device=targets.device)[None] < n_acc[:, None],
                          drafted, targets)
    drop = s - 1 - n_acc  # keep last_tok and the accepted drafts
    if active is not None:
        drop = drop * active.long()
    new_caches = [_cache_rollback(c, drop) for c in new_caches]
    return emitted, n_acc + 1, new_caches


def decode_bank(step, caches, last_tok, pos, active, horizon: int):
    """`horizon` chained calls of step(caches, last_tok, pos) -> (next_tok,
    caches) with every step's token banked, pos advancing on the active
    rows: returns (tokens [horizon, n_slots], caches, last_tok, pos).
    Nothing in the loop waits for the device; the caller fetches the bank
    once."""
    bank = []
    inc = active.to(pos.dtype)
    for _ in range(horizon):
        last_tok, caches = step(caches, last_tok, pos)
        bank.append(last_tok)
        pos = pos + inc
    return torch.stack(bank), caches, last_tok, pos


def decode_horizon_batched(params, caches, last_tok, pos, active, cfg: TransformerConfig,
                           horizon: int, temperature=0.0, generator=None):
    """`horizon` chained decode steps with every step's token banked
    (`decode_bank` of decode_step_batched)."""
    return decode_bank(
        lambda caches, last_tok, pos: decode_step_batched(
            params, caches, last_tok, pos, active, cfg, temperature, generator),
        caches, last_tok, pos, active, horizon)


def prefill_slot(params, caches, tokens, true_len: int, slot: int, cfg: TransformerConfig,
                 temperature=0.0, generator=None):
    """Fused prefill of one request into cache row `slot`.

    tokens: [t_pad] prompt right-padded past `true_len` (causal masking keeps
    the padding out of every real row, and the slot's length is set to
    true_len). Returns (first generated token [scalar], caches).
    """
    logits, caches = prefill_slot_logits(params, caches, tokens, true_len, slot, cfg)
    return sample_token(logits, temperature, generator), caches


@torch.no_grad()
def prefill_slot_logits(params, caches, tokens, true_len: int, slot: int, cfg: TransformerConfig,
                        psum=_no_psum, own: bool = True):
    """`prefill_slot` up to its last true token's logits: (logits [vocab],
    caches). Under a mesh (serve/engine.py) `cfg` counts this rank's heads,
    `psum` is as in `_decode_logits`, and only the data shard that owns the
    slot writes its row (`own`; `slot` is then the shard's local row)."""
    x = embedding_lookup(params["embed"], tokens)[None]
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        if own:  # a paged prompt is padded to a page multiple by the engine
            cache = _cache_write_slot(cache, slot, k[0], v[0], true_len)
        o = _attention(q, k, v, cfg)
        x = _mlp_residual(layer, x + psum(mm(_merge_heads(o, cfg, x.dtype), layer["wo"])), psum)
        new_caches.append(cache)
    # final norm on the sampled rows only (it is per row)
    return mm(rmsnorm(x[0, true_len - 1], params["final_norm"]), params["unembed"]), new_caches


def prefill_chunk(params, caches, tokens, chunk_start: int, true_end: int, slot: int,
                  cfg: TransformerConfig, last: bool, temperature=0.0, generator=None):
    """One chunk of a chunked prefill into cache row `slot` (the JAX
    package's prefill_chunk, transformer.py:531-620).

    tokens: [c] the prompt's slice [chunk_start, chunk_start + c), the last
    chunk right-padded; true_end: the prompt's length. The chunk attends
    causally to itself and, past the first chunk, non-causally to the
    row's dequantized prefix [0, chunk_start), both through B1 bf16
    whatever `cfg.attention` is (as in JAX), and the two partials merge by
    lse. The row's length grows to min(chunk_start + c, true_end), so decode
    steps of other slots between chunks see only written positions of this
    row. chunk_start, true_end and slot are Python ints.

    Returns (the sampled first token on the last chunk, else None; caches).
    """
    logits, caches = prefill_chunk_logits(params, caches, tokens, chunk_start, true_end, slot,
                                          cfg, last)
    return (None if logits is None else sample_token(logits, temperature, generator)), caches


@torch.no_grad()
def prefill_chunk_logits(params, caches, tokens, chunk_start: int, true_end: int, slot: int,
                         cfg: TransformerConfig, last: bool, psum=_no_psum, own: bool = True,
                         data_psum=_no_psum):
    """`prefill_chunk` up to its last token's logits: (logits [vocab] on the
    last chunk, else None; caches). Under a mesh (serve/engine.py) `cfg`
    and `psum` are as in `prefill_slot_logits`, and the chunk's activations
    are the same on every data shard while only the owning one (`own`)
    holds the row: it alone writes the chunk and merges the prefix in, the
    others contribute zeros, and `data_psum` (a sum over the data axis)
    hands the owner's merged output to every shard."""
    c = tokens.shape[0]
    x = embedding_lookup(params["embed"], tokens)[None]
    positions = chunk_start + torch.arange(c, device=tokens.device)
    new_len = min(chunk_start + c, true_end)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        if own:
            cache = _cache_write_chunk(cache, slot, k[0], v[0], chunk_start, new_len)
        o, lse = flash_attention_fwd(q, k, v, causal=True)  # GQA-native
        if chunk_start > 0:
            if own:
                k_pre, v_pre = _cache_read_prefix(cache, slot, chunk_start)
                o2, lse2 = flash_attention_fwd(q, k_pre[None], v_pre[None], causal=False)
                o, _ = _merge_partials(o, lse, o2, lse2)
            else:
                o = torch.zeros_like(o)
            o = data_psum(o)
        x = _mlp_residual(layer, x + psum(mm(_merge_heads(o, cfg, x.dtype), layer["wo"])), psum)
        new_caches.append(cache)
    if not last:
        return None, new_caches
    return mm(rmsnorm(x[0, true_end - 1 - chunk_start], params["final_norm"]),
              params["unembed"]), new_caches


@torch.no_grad()
def prefill_slots(params, caches, tokens, true_lens, slots, cfg: TransformerConfig,
                  temperature=0.0, generator=None):
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
            cache = _cache_write_slot(cache, slots[i:i + 1], k[i], v[i], true_lens[i:i + 1])
        o = _attention(q, k, v, cfg)
        x = _mlp_residual(layer, x + mm(_merge_heads(o, cfg, x.dtype), layer["wo"]))
        new_caches.append(cache)
    last = x[torch.arange(B, device=tokens.device), true_lens.long() - 1]
    logits = mm(rmsnorm(last, params["final_norm"]), params["unembed"])
    return sample_token(logits, temperature, generator), new_caches


@torch.no_grad()
def prefill_batched(params, caches, prompt, cfg: TransformerConfig,
                    temperature=0.0, generator=None):
    """Fused prefill of a same-length batch prompt [B, T0], K/V installed in
    every cache row (all rows at length 0; a paged cache's rows must own
    their pages). Returns (next_tok [B], caches)."""
    positions = torch.arange(prompt.shape[1], device=prompt.device)
    x = embedding_lookup(params["embed"], prompt)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rmsnorm(x, layer["ln1"])
        q, k, v = _project_qkv(layer, h, cfg, positions)
        cache = _cache_install_batch(cache, k, v)
        o = _attention(q, k, v, cfg)
        x = _mlp_residual(layer, x + mm(_merge_heads(o, cfg, x.dtype), layer["wo"]))
        new_caches.append(cache)
    logits = mm(rmsnorm(x[:, -1], params["final_norm"]), params["unembed"])
    return sample_token(logits, temperature, generator), new_caches


def generate(params, prompt, cfg: TransformerConfig, max_new_tokens: int = 16,
             temperature=0.0, generator=None, top_k: int = 0, top_p: float = 1.0):
    """Decoding with the int8 KV cache: one fused prefill over the prompt,
    then batched single-token decode steps (the serving engine's numerics).
    Greedy by default; temperature > 0 samples with `generator`, top-k /
    top-p filtered when top_k > 0 or top_p < 1.

    prompt: [B, T0] integer tensor on the params' device; returns
    [B, T0 + max_new_tokens] int64.
    """
    if top_k or top_p < 1.0:
        temperature = Sampling(sampling_temperature(temperature), top_k, top_p)
    if sampling_temperature(temperature) > 0.0 and generator is None:
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
