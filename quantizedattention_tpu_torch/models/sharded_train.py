"""Multi-rank training step: data x model x sequence parallelism over a
(data, model, context) mesh, and the Megatron parameter layout it runs on.

Counterpart of quantizedattention_tpu/models/sharded_train.py. A spec is a
tuple naming, for each leading dim, the mesh axis it splits over (None:
replicated), as a JAX PartitionSpec does:

  wq, wk, wv, w1  [D, out]   columns on model (heads, MLP hidden)
  wo, w2          [in, D]    contraction on model: a psum follows them
  everything else            replicated

`shard_params` cuts a full parameter tree to this rank's shard, the
counterpart of `jax.device_put` with NamedShardings.

The train step (`make_sharded_train_step`) is the JAX step in the
multi-controller idiom: every rank runs it on its own parameter shards and
its own (data, context) block of tokens, and meets the others in
collectives. The batch splits over data, heads and the MLP hidden over
model, the sequence over context: attention crosses the context axis by the
chosen strategy (parallel/ring.py, collective.py, ulysses.py, zigzag.py),
RoPE takes each token's global position, and the loss is the global mean.
What JAX's transposes give its gradients, explicit here:
- the psum over model after wo and w2 is the identity going back
  (`_ReduceFromModel`), and the gradient reaching the column-parallel input
  (the normed h before wq/wk/wv and w1) is summed over model
  (`_CopyToModel`), so every model rank holds the whole gradient of the
  replicated activations and parameters;
- the loss is each rank's token sum over the global token count, and every
  parameter's gradient is summed over data and context (one flat buffer,
  one all_reduce an axis);
- the attention strategies carry their own transposes (all_gather ->
  psum_scatter, all_to_all -> the reverse all_to_all, the ring's dK/dV
  home by rotation).
"""

from __future__ import annotations

import dataclasses

import torch

from quantizedattention_tpu_torch.models.transformer import (
    TransformerConfig,
    param_leaves,
    transformer_forward,
)
from quantizedattention_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    axis_size,
    psum,
    shard_tensor,
)
from quantizedattention_tpu_torch.parallel.scaling_model import best_sp_variant
from quantizedattention_tpu_torch.quantize.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    quantize_lm_specs,
    quantize_lm_weights,
)
from quantizedattention_tpu_torch.tune.config import int8_shard_grain


def param_specs(cfg: TransformerConfig) -> dict:
    """Spec tree matching init_transformer's params (JAX
    sharded_train.py:28-49)."""
    layer = {
        "ln1": (),
        "wq": (None, "model"),
        "wk": (None, "model"),
        "wv": (None, "model"),
        "wo": ("model", None),
        "ln2": (),
        "w1": (None, "model"),
        "w2": ("model", None),
    }
    return {"embed": (), "unembed": (), "final_norm": (),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def shard_tree(tree, specs, mesh):
    """This rank's shard of every tensor of `tree` (dicts, lists, NamedTuple
    caches, QuantizedWeight leaves) under the matching spec tree."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(shard_tensor(tree.w_i8, specs.w_i8, mesh),
                               shard_tensor(tree.scale, specs.scale, mesh), tree.axis)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a cache NamedTuple
        return type(tree)(*(shard_tensor(x, s, mesh) for x, s in zip(tree, specs)))
    return shard_tensor(tree, specs, mesh)


def local_config(cfg: TransformerConfig, mesh) -> TransformerConfig:
    """`cfg` with this rank's head counts (heads split over model)."""
    n_model = axis_size(mesh, "model")
    if cfg.n_kv_heads % n_model or cfg.n_heads % n_model:
        raise ValueError(f"n_heads {cfg.n_heads} and n_kv_heads {cfg.n_kv_heads} must divide "
                         f"the model axis ({n_model})")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // n_model,
                               n_kv_heads=cfg.n_kv_heads // n_model)


def shard_params(params: dict, cfg: TransformerConfig, mesh, weight_quant: str | None = None):
    """This rank's shard of a full params tree under `param_specs(cfg)`.

    weight_quant="int8" quantizes the full weights first
    (`quantize_lm_weights`) and then slices them under
    `quantize_lm_specs`, so each shard carries exactly the full weight's
    column scales for its columns, and wo/w2 the replicated scale. A tree
    that already holds int8 QuantizedWeight leaves is sliced the same way;
    int4 leaves raise (their packing does not split along the
    contraction)."""
    if weight_quant not in (None, "int8"):
        raise ValueError(f"mesh sharding takes weight_quant None or 'int8', got {weight_quant!r}")
    if isinstance(params["unembed"], QuantizedWeight4):
        raise ValueError("int4 weights do not shard: split-half packing does not split along "
                         "the contraction axis; use 'int8'")
    if weight_quant == "int8" and not isinstance(params["unembed"], QuantizedWeight):
        params = quantize_lm_weights(params, bits=8)
    specs = param_specs(cfg)
    if isinstance(params["unembed"], QuantizedWeight):
        specs = quantize_lm_specs(specs)
    local_config(cfg, mesh)  # the heads must split
    return shard_tree(params, specs, mesh)


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------

STRATEGIES = ("ring", "allgather", "ulysses", "zigzag")


def auto_sp_arguments(cfg: TransformerConfig, n_model: int, n_ctx: int, attention: str) -> dict:
    """The arguments attention_sp="auto" hands `best_sp_variant` for `cfg` on
    a mesh with `n_model` model and `n_ctx` context ranks (JAX
    sharded_train.py:166-181): one shard's heads, t_local from cfg.max_seq
    (at least 128), Ulysses where both head counts divide the context axis,
    zigzag where max_seq splits into 2 n_ctx chunks of a multiple of 128."""
    h_loc, kv_loc = cfg.n_heads // n_model, cfg.n_kv_heads // n_model
    return dict(h=h_loc, h_kv=kv_loc, t_local=max(128, cfg.max_seq // max(1, n_ctx)),
                d=cfg.head_dim, n=n_ctx, kind=attention,
                allow_ulysses=(h_loc % n_ctx == 0 and kv_loc % n_ctx == 0),
                allow_zigzag=(cfg.max_seq % (2 * n_ctx) == 0
                              and (cfg.max_seq // (2 * n_ctx)) % 128 == 0))


def resolve_attention_sp(cfg: TransformerConfig, n_model: int, n_ctx: int,
                         attention: str) -> str:
    """attention_sp="auto"'s pick: parallel/scaling_model.py's predicted-best
    strategy under its H100 constants, "ring" where there is no context
    axis."""
    if n_ctx == 1:
        return "ring"
    return best_sp_variant(**auto_sp_arguments(cfg, n_model, n_ctx, attention))


def check_shardable(attention_sp: str, attention: str, t_local: int, n_ctx: int,
                    rep: int) -> None:
    """Raise ValueError if `attention_sp` cannot run a step of t_local tokens
    a context rank: zigzag needs the sequence in 2 n_ctx equal chunks, the
    int8 all-gather 128-token shards on the shard's int8 kv block
    (tune/config.py:int8_shard_grain, stricter than JAX's rule)."""
    t = t_local * n_ctx
    if attention_sp == "zigzag" and t % (2 * n_ctx):
        raise ValueError(
            f"attention_sp='zigzag' cannot shard sequence length {t} over "
            f"context={n_ctx} (zigzag needs t % {2 * n_ctx} == 0) — pick a "
            f"compatible length or another strategy")
    if attention_sp == "allgather" and attention == "int8":
        int8_shard_grain(t_local, rep)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over model (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous().clone(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """psum over model forward; the identity going back (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return psum(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _attend(q, k, v, mesh, attention: str, attention_sp: str):
    """Causal attention of this rank's shards across the context axis."""
    from quantizedattention_tpu_torch.parallel.collective import (
        allgather_kv_attention,
        allgather_kv_attention_int8,
    )
    from quantizedattention_tpu_torch.parallel.ring import ring_attention
    from quantizedattention_tpu_torch.parallel.ulysses import ulysses_attention
    from quantizedattention_tpu_torch.parallel.zigzag import (
        zigzag_ring_attention,
        zigzag_ring_attention_int8,
    )

    if attention_sp == "ring":
        return ring_attention(q, k, v, mesh, "context", causal=True, kind=attention)
    if attention_sp == "ulysses":
        return ulysses_attention(q, k, v, mesh, "context", causal=True, kind=attention)
    if attention_sp == "zigzag":
        zz = zigzag_ring_attention_int8 if attention == "int8" else zigzag_ring_attention
        return zz(q, k, v, mesh, "context")
    if attention == "int8":
        return allgather_kv_attention_int8(q, k, v, mesh, "context", causal=True)
    return allgather_kv_attention(q, k, v, mesh, "context", causal=True)


def _sharded_forward(params, tokens, cfg: TransformerConfig, mesh, attention: str = "bf16",
                     attention_sp: str = "ring"):
    """This rank's forward on its shards (JAX sharded_train.py:52-113):
    params from `shard_params`, tokens [B_loc, T_loc] (under zigzag the
    rank's block of the permuted sequence). Returns logits [B_loc, T_loc,
    vocab]."""
    from quantizedattention_tpu_torch.parallel.zigzag import zigzag_local_positions

    n_model = axis_size(mesh, "model")
    n_ctx, ctx_idx = axis_size(mesh, "context"), axis_index(mesh, "context")
    lcfg = local_config(cfg, mesh)
    t_loc = tokens.shape[1]
    if attention_sp == "zigzag":
        positions = zigzag_local_positions(ctx_idx, n_ctx, t_loc, device=tokens.device)
    else:
        positions = ctx_idx * t_loc + torch.arange(t_loc, device=tokens.device)

    def to_model(h):
        return _CopyToModel.apply(h, mesh) if n_model > 1 else h

    def from_model(y):
        return _ReduceFromModel.apply(y, mesh) if n_model > 1 else y

    def attend(q, k, v):
        return _attend(q, k, v, mesh, attention, attention_sp)

    return transformer_forward(params, tokens, lcfg, attend, positions, from_model, to_model)


def _psum_grads(leaves, mesh, axes=("data", "context")) -> None:
    """Every leaf's gradient summed over `axes`, in place: one flat buffer,
    one all_reduce an axis of size > 1."""
    axes = [a for a in axes if axis_size(mesh, a) > 1]
    if not axes:
        return
    grads = [t.grad for t in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    for a in axes:
        psum(flat, mesh, a)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def make_sharded_train_step(mesh, cfg: TransformerConfig, params, optimizer=None,
                            attention: str = "bf16", attention_sp: str = "auto"):
    """(optimizer, step) with step(tokens, targets) -> loss, the global mean
    next-token cross entropy (a 0-d tensor, the same on every rank), in the
    idiom of models/transformer.py:make_train_step.

    params: this rank's shards (`shard_params(full, cfg, mesh)`); every
    tensor is made a leaf that requires grad, and `step` updates them in
    place. tokens/targets: this rank's ("data", "context") block [B / data,
    T / context] of the global batch. The default optimizer is AdamW(3e-4,
    betas (0.9, 0.999), eps 1e-8, weight decay 1e-4), as optax.adamw(3e-4);
    a caller's must be built over `param_leaves(params)`.

    attention: "bf16" or "int8". attention_sp: "auto" (the default, as in
    JAX: `resolve_attention_sp` picks, once, the strategy that
    parallel/scaling_model.py predicts fastest for this cfg and mesh, from
    `auto_sp_arguments`; "ring" without a context axis), "ring" (contiguous
    shards, ring hops posted before each step's kernel), "allgather" (K/V
    all-gathered, dK/dV reduce-scattered home; int8 gathers the payloads and
    scale tables and needs T / context a multiple of 128 and of the shard's
    int8 kv block), "ulysses" (all-to-all head <-> sequence; heads and kv
    heads per model shard divisible by the context axis) or "zigzag" (the
    load-balanced causal ring, T a multiple of 2 x context; the step gathers
    the sequence's tokens over context, permutes them by `zigzag_perm` and
    takes this rank's block; the mean loss is permutation-invariant). The
    pick is made from cfg.max_seq, but a step's own length may not shard
    under it (`check_shardable`): under "auto" that step runs the ring; a
    strategy named explicitly raises ValueError from the step.
    `step.attention_sp` is the pick, `step.last_attention_sp` what the last
    call ran.
    """
    n_model, n_ctx = axis_size(mesh, "model"), axis_size(mesh, "context")
    if cfg.n_heads % n_model != 0:
        raise ValueError("n_heads must divide the model axis")
    if cfg.n_kv_heads % n_model != 0:
        raise ValueError("n_kv_heads must divide the model axis")
    if cfg.n_heads % cfg.n_kv_heads != 0:
        raise ValueError("n_heads must be a multiple of n_kv_heads")
    if attention not in ("bf16", "int8"):
        raise ValueError(f"unknown attention kind {attention!r}")
    if attention_sp not in ("auto",) + STRATEGIES:
        raise ValueError(f"unknown attention_sp {attention_sp!r}")
    h_loc, kv_loc = cfg.n_heads // n_model, cfg.n_kv_heads // n_model
    if attention_sp == "ulysses" and (h_loc % n_ctx or kv_loc % n_ctx):
        raise ValueError(
            f"attention_sp='ulysses' needs per-shard head counts divisible "
            f"by the context axis ({h_loc}/{kv_loc} heads, context={n_ctx})")
    was_auto = attention_sp == "auto"
    if was_auto:
        attention_sp = resolve_attention_sp(cfg, n_model, n_ctx, attention)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)

    def step(tokens, targets):
        b_loc, t_loc = tokens.shape
        t = t_loc * n_ctx
        sp = attention_sp
        try:
            check_shardable(sp, attention, t_loc, n_ctx, h_loc // kv_loc)
        except ValueError:
            if not was_auto:
                raise
            sp = "ring"  # the always-shardable ring, for this call only
        step.last_attention_sp = sp
        if sp == "zigzag":
            from quantizedattention_tpu_torch.parallel.zigzag import zigzag_perm

            # the global sequence re-ordered so that contiguous context
            # blocks hold zigzag (lo, hi) chunk pairs; targets move with
            # their tokens
            mine = zigzag_perm(n_ctx, t)[axis_index(mesh, "context") * t_loc:][:t_loc]
            mine = mine.to(tokens.device)
            tokens = all_gather(tokens.contiguous(), mesh, "context", 1)[:, mine]
            targets = all_gather(targets.contiguous(), mesh, "context", 1)[:, mine]
        optimizer.zero_grad(set_to_none=True)
        logits = _sharded_forward(params, tokens, cfg, mesh, attention, sp)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None]).sum()
        count = b_loc * t_loc * axis_size(mesh, "data") * n_ctx
        loss = nll / count
        loss.backward()
        _psum_grads(leaves, mesh)
        optimizer.step()
        total = loss.detach().clone().reshape(1)
        for a in ("data", "context"):
            psum(total, mesh, a)
        return total[0]

    step.attention_sp, step.last_attention_sp = attention_sp, None
    return optimizer, step
