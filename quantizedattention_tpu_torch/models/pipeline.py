"""Pipeline-parallel training step (GPipe over a `pipe` axis).

Counterpart of quantizedattention_tpu/models/pipeline.py, in the
multi-controller idiom of models/sharded_train.py: every rank is one stage,
holds its own blocks and meets its neighbours in point-to-point hops.

  * Stage s of S owns the contiguous blocks [s L/S, (s + 1) L/S)
    (`pipeline_stage_params`), as JAX shards its stacked layers P("pipe").
    embed, unembed and final_norm are replicated on every stage, but only
    stage 0 embeds and only the last stage unembeds.
  * The GPipe schedule: the batch splits into M microbatches; over T = M + S
    - 1 ticks, stage s runs microbatch tick - s. Stage 0 embeds the
    microbatch it injects, a dead tick (a fill or drain bubble) runs
    nothing, and the last stage sums the nll of its finished microbatch in
    f32 log-softmax, as JAX's `bank_loss`. The activation hops to stage + 1
    only where both ends are live: sender s is live at tick tau exactly
    when receiver s + 1 is live at tick tau + 1 (`parallel/mesh.py:
    ppermute_start` with send/recv).
  * Each block is recomputed in the backward (`torch.utils.checkpoint`,
    non-reentrant), as JAX remats each block, so the forward keeps one
    activation a block for each microbatch in flight.
  * The backward is explicit, not one `loss.backward()` a rank: autograd
    would be free to run the hops of one rank's graph in any order, and
    stage 0's received carry is in no graph at all, so the ranks' reverse
    hops would not pair up. Instead the ticks are walked in reverse: a stage
    receives dY of its microbatch from stage + 1, runs
    `torch.autograd.backward(y, dY)` (the last stage: backward of its
    nll / (B T)) and sends dX to stage - 1, the reverse hop.
  * What JAX's shard_map transpose gives the replicated leaves, explicit
    here: their gradients are summed over pipe before the optimizer step (one
    flat all_reduce), so every stage holds the one-device gradient, unscaled,
    and every replica steps identically. The loss is the nll summed over
    the last stage's microbatches, psum over pipe, over B T.

Blocks run through models/transformer.py:_block, so cfg.attention picks the
corrected-bf16 flash kernels (B1, B2 + B3) or the int8 path (B4, B5, B7 +
B8). Per step B1 (or B4 and B5) runs 2 M L times over the stages (forward
and recompute) and B2, B3 and fast mode's prep (or B7, B8) M L times. As in
JAX there is no pipe x (data, model, context) composition and no 1F1B
schedule.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from quantizedattention_tpu_torch.models.sharded_train import _psum_grads
from quantizedattention_tpu_torch.models.transformer import (
    TransformerConfig,
    _block,
    param_leaves,
    rmsnorm,
)
from quantizedattention_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    ppermute_start,
    psum,
)
from quantizedattention_tpu_torch.quantize.weights import embedding_lookup, mm

REPLICATED = ("embed", "unembed", "final_norm")


def _stages(cfg: TransformerConfig, mesh) -> int:
    if "pipe" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError("the pipeline step needs a mesh with a 'pipe' axis "
                         "(parallel.mesh.make_pipeline_mesh)")
    n_stages = axis_size(mesh, "pipe")
    if cfg.n_layers % n_stages != 0:
        raise ValueError(f"n_layers={cfg.n_layers} must divide into {n_stages} stages")
    return n_stages


def stage_layers(cfg: TransformerConfig, mesh) -> range:
    """The global indices of this rank's blocks: [s L/S, (s + 1) L/S)."""
    per = cfg.n_layers // _stages(cfg, mesh)
    first = axis_index(mesh, "pipe") * per
    return range(first, first + per)


def pipeline_stage_params(full: dict, cfg: TransformerConfig, mesh) -> dict:
    """This stage's params from a full tree (init_transformer's): the
    replicated embed, unembed and final_norm and the stage's blocks
    (`stage_layers`), each a contiguous copy (the counterpart of JAX's
    `prepare`: stack_layers, then device_put under pipeline_param_specs)."""
    copy = {key: full[key].clone() for key in REPLICATED}
    copy["layers"] = [{k: t.clone() for k, t in full["layers"][i].items()}
                      for i in stage_layers(cfg, mesh)]
    return copy


def pipeline_named_params(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """This stage's params by name, in `param_leaves` order (the optimizer's),
    each block under its global index ("layers.{i}.wq"): keys that differ
    from stage to stage, so one checkpoint holds every stage's blocks
    (utils/checkpoint.py:train_state)."""
    named = {key: params[key] for key in REPLICATED}
    for i, layer in zip(stage_layers(cfg, mesh), params["layers"]):
        named.update({f"layers.{i}.{k}": t for k, t in layer.items()})
    return named


def _stage_forward(layers, x, cfg: TransformerConfig, positions):
    """This stage's blocks over x, each recomputed in the backward."""
    for layer in layers:
        x = checkpoint(_block, layer, x, cfg, positions, use_reentrant=False)
    return x


def _nll_sum(params, y, targets):
    """The summed next-token nll of the last stage's output y [b, t, d], in
    an f32 log-softmax (models/transformer.py:lm_loss)."""
    logits = mm(rmsnorm(y, params["final_norm"]), params["unembed"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).sum()


def make_pipeline_train_step(mesh, cfg: TransformerConfig, params, n_microbatches: int,
                             optimizer=None):
    """(optimizer, step) for GPipe training over the mesh's "pipe" axis
    (parallel.mesh.make_pipeline_mesh), in the idiom of
    models/sharded_train.py:make_sharded_train_step.

    params: this stage's (`pipeline_stage_params(full, cfg, mesh)`); every
    tensor is made a leaf that requires grad, and `step` updates them in
    place. step(tokens, targets) takes the whole batch [B, T] on every rank
    (B a multiple of n_microbatches) and returns the global mean next-token
    cross entropy, a 0-d tensor, the same on every rank. The default
    optimizer is AdamW(3e-4, betas (0.9, 0.999), eps 1e-8, weight decay
    1e-4), as optax.adamw(3e-4); a caller's must be built over
    `param_leaves(params)`. n_layers not a multiple of the stage count raises
    ValueError."""
    n_stages = _stages(cfg, mesh)
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be positive, got {n_microbatches}")
    if len(params["layers"]) != cfg.n_layers // n_stages:
        raise ValueError(f"a stage holds {cfg.n_layers // n_stages} blocks, params hold "
                         f"{len(params['layers'])}: pass pipeline_stage_params(full, cfg, mesh)")
    stage = axis_index(mesh, "pipe")
    last = n_stages - 1
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
    replicated = [params[key] for key in REPLICATED]
    # a collective over every stage before the first hop: NCCL wants the
    # group's first call to involve all its ranks, and a hop pairs two
    psum(torch.zeros(1, device=params["embed"].device), mesh, "pipe")

    def hop(x, shift, send, recv):
        """One hop toward stage + shift, or None where this stage neither
        sends nor receives; x is what it sends, else the template of what
        arrives."""
        return ppermute_start([x], mesh, "pipe", shift, send, recv) if send or recv else None

    def step(tokens, targets):
        b, t = tokens.shape
        if b % n_microbatches:
            raise ValueError(f"batch {b} does not split into {n_microbatches} microbatches")
        mb = b // n_microbatches
        n_ticks = n_microbatches + n_stages - 1
        toks = tokens.reshape(n_microbatches, mb, t)
        tgts = targets.reshape(n_microbatches, mb, t)
        positions = torch.arange(t, device=tokens.device)
        carry = torch.empty((mb, t, cfg.d_model), dtype=params["embed"].dtype,
                            device=tokens.device)

        def live(tick):
            return 0 <= tick - stage < n_microbatches

        optimizer.zero_grad(set_to_none=True)
        nll = torch.zeros((), dtype=torch.float32, device=tokens.device)
        saved = {}  # microbatch -> (the stage's input leaf or None, its output)
        pending = None
        for tick in range(n_ticks):
            incoming = pending.wait() if pending is not None else []
            y = carry
            if live(tick):
                micro = tick - stage
                if stage == 0:
                    x_in, x = None, embedding_lookup(params["embed"], toks[micro])
                else:
                    x_in = x = incoming[0].requires_grad_(True)
                y = _stage_forward(params["layers"], x, cfg, positions)
                if stage == last:
                    term = _nll_sum(params, y, tgts[micro])
                    nll = nll + term.detach()
                    saved[micro] = (x_in, term / (b * t))
                else:
                    saved[micro] = (x_in, y)
            pending = hop(y.detach(), 1, live(tick) and stage < last,
                          stage > 0 and live(tick + 1))
        if pending is not None:
            pending.wait()
        pending = None
        for tick in reversed(range(n_ticks)):
            incoming = pending.wait() if pending is not None else []
            dx = carry
            if live(tick):
                x_in, out = saved.pop(tick - stage)
                if stage == last:
                    torch.autograd.backward(out)
                else:
                    torch.autograd.backward(out, incoming[0])
                if x_in is not None:
                    dx = x_in.grad
            pending = hop(dx, -1, live(tick) and stage > 0, stage < last and live(tick - 1))
        if pending is not None:
            pending.wait()
        for p in replicated:  # a stage that never used a leaf contributes zeros
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _psum_grads(replicated, mesh, ("pipe",))
        optimizer.step()
        total = psum(nll.reshape(1), mesh, "pipe")
        return total[0] / (b * t)

    return optimizer, step
