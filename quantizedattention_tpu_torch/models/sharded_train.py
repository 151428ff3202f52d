"""The Megatron parameter layout over the (data, model, context) mesh.

Counterpart of the layout half of quantizedattention_tpu/models/
sharded_train.py (`param_specs`); its sharded train step comes with the
training slice. A spec is a tuple naming, for each leading dim, the mesh
axis it splits over (None: replicated), as a JAX PartitionSpec does:

  wq, wk, wv, w1  [D, out]   columns on model (heads, MLP hidden)
  wo, w2          [in, D]    contraction on model: a psum follows them
  everything else            replicated

`shard_params` cuts a full parameter tree to this rank's shard, the
counterpart of `jax.device_put` with NamedShardings.
"""

from __future__ import annotations

import dataclasses

from quantizedattention_tpu_torch.models.transformer import TransformerConfig
from quantizedattention_tpu_torch.parallel.mesh import axis_size, shard_tensor
from quantizedattention_tpu_torch.quantize.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    quantize_lm_specs,
    quantize_lm_weights,
)


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
