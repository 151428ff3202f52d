"""Checkpoint/resume for model params and optimizer state.

Counterpart of quantizedattention_tpu/utils/checkpoint.py: two backends
behind one (path, tree) API, and `load_checkpoint` detects the on-disk
format, so either backend reads its own writes.

  * "dcp" (the default): torch.distributed.checkpoint, in Orbax's place.
    Every rank of the process group calls save and load with its own tree;
    a leaf that is a DTensor is written and read shard by shard, so a
    (data, model, context)-sharded train state checkpoints and resumes
    without gathering to one rank (`like`'s layouts are the restore
    layout). DCP takes a plain tensor that several ranks write under one key
    as replicated and keeps one rank's copy: give every sharded leaf its
    layout (`train_state(..., mesh, specs)`), or a key of its own on each
    rank (the pipeline's blocks under their global index). Without a
    process group it runs in this process alone.
  * "numpy": the JAX package's layout, `leaves.npz` with `leaf_{i}` and
    `treedef.json`, single-process. Leaves are numbered in jax.tree_util's
    order (dict keys sorted, lists and tuples in order, None no leaf), so a
    numpy checkpoint that the JAX package wrote of its params loads into the
    port's params tree.

A tree is dicts, lists and tuples of tensors and Python numbers (None: no
leaf). `train_state` / `restore_train_state` turn a train step's live
params and torch optimizer into such a tree ({"params", "opt"}, as the JAX
package saves {"params": ..., "opt": opt_state}) and back.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

_NUMBERS = (bool, int, float)


def _is_numpy_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, "leaves.npz"))


def _is_dcp_dir(path: str) -> bool:
    """Positive detection of DCP's layout (its `.metadata` file), so a foreign
    or partly written directory raises 'not a checkpoint' instead of a
    confusing DCP error."""
    return os.path.isfile(os.path.join(path, ".metadata"))


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(dotted path, leaf) pairs in jax.tree_util's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in _flatten(v, f"{prefix}{i}.")]
    if isinstance(tree, torch.Tensor) or isinstance(tree, _NUMBERS):
        return [(prefix[:-1], tree)]
    raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a {type(tree).__name__}: tensors and "
                    "Python numbers only")


def _unflatten(like, leaves):
    """`like`'s structure with its leaves replaced, in _flatten's order, by
    the iterator `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _describe(tree) -> str:
    """The tree's structure with each leaf as '*' (treedef.json)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "None" if tree is None else "*"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if _is_dtensor(x):
            raise ValueError("the numpy backend is single-process: save DTensor leaves with 'dcp'")
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _like_leaf(value: np.ndarray, want):
    """A loaded array as `want`'s kind: a tensor on its device and dtype, or
    a Python number of its type."""
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(value)).to(device=want.device,
                                                                dtype=want.dtype)
    return type(want)(value.item())


def _number(x) -> torch.Tensor:
    """A Python number as a 0-d tensor for DCP (a float in float64: exact)."""
    return torch.tensor(x, dtype=torch.float64 if isinstance(x, float) else None)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def save_checkpoint(path: str, tree, backend: str = "auto") -> None:
    """Save a tree of (possibly DTensor) tensors and numbers to the
    directory `path`. backend: "auto" (= "dcp"), "dcp" or "numpy". Under a
    process group every rank calls it ("dcp") with the same path."""
    if backend not in ("auto", "dcp", "numpy"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    if backend == "numpy":
        np.savez(os.path.join(path, "leaves.npz"),
                 **{f"leaf_{i}": _to_numpy(x) for i, (_, x) in enumerate(flat)})
        with open(os.path.join(path, "treedef.json"), "w") as f:
            json.dump({"treedef": _describe(tree), "n": len(flat)}, f)
        return
    import torch.distributed.checkpoint as dcp

    state = {key: x.detach() if isinstance(x, torch.Tensor) else _number(x) for key, x in flat}
    dcp.save(state, checkpoint_id=path, no_dist=not dist.is_initialized())


def _load_dcp(path: str, like):
    import torch.distributed.checkpoint as dcp

    flat = _flatten(like)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state = {}
    for key, want in flat:
        if key not in meta:
            raise ValueError(f"checkpoint {path} has no leaf {key!r}")
        got = tuple(getattr(meta[key], "size", ()))
        if got != _shape(want):
            raise ValueError(f"checkpoint leaf {key!r} shape {got} != expected {_shape(want)}")
        state[key] = want.detach().clone() if isinstance(want, torch.Tensor) else _number(want)
    dcp.load(state, checkpoint_id=path, no_dist=not dist.is_initialized())
    values = (state[key] if isinstance(want, torch.Tensor) else type(want)(state[key].item())
              for key, want in flat)
    return _unflatten(like, values)


def load_checkpoint(path: str, like):
    """Load a tree saved by save_checkpoint, shaped like `like`: every
    restored leaf lands on `like`'s device and dtype (a DTensor leaf on its
    mesh and placements, shard by shard), a number as `like`'s type. A leaf
    whose shape differs from `like`'s raises ValueError. `like` is not
    written to."""
    path = os.path.abspath(path)
    # leaves.npz wins: a numpy checkpoint stays loadable even if the
    # directory also holds DCP's files
    if _is_numpy_dir(path):
        data = np.load(os.path.join(path, "leaves.npz"))
        flat = _flatten(like)
        loaded = [data[f"leaf_{i}"] for i in range(len(flat))]
        for got, (_, want) in zip(loaded, flat):
            if got.shape != _shape(want):
                raise ValueError(f"checkpoint leaf shape {got.shape} != expected {_shape(want)}")
        return _unflatten(like, (_like_leaf(g, w) for g, (_, w) in zip(loaded, flat)))
    if _is_dcp_dir(path):
        return _load_dcp(path, like)
    raise ValueError(f"{path} is not a checkpoint directory (neither DCP metadata nor "
                     "leaves.npz found)")


# --------------------------------------------------------------------------
# A train step's state as a tree
# --------------------------------------------------------------------------

def _layout(x: torch.Tensor, mesh, spec):
    """x, this rank's block of a tensor split under `spec` (a tuple naming
    the mesh axis each leading dim splits over, as
    models/sharded_train.py:param_specs gives), as a DTensor on `mesh`."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(spec.index(name)) if name in spec else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(x.detach(), mesh, placements, run_check=False)


def _init_state(optimizer) -> None:
    """Give a fresh optimizer its state (a step at lr 0 on zero gradients,
    which moves no parameter), so that its tree has every leaf to load
    into."""
    if optimizer.state:
        return
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        p.grad = torch.zeros_like(p)
    lrs = [g["lr"] for g in optimizer.param_groups]
    for g in optimizer.param_groups:
        g["lr"] = 0.0
    optimizer.step()
    for g, lr in zip(optimizer.param_groups, lrs):
        g["lr"] = lr
    optimizer.zero_grad(set_to_none=True)


def _checked_names(named: dict, optimizer) -> list[str]:
    params = [p for g in optimizer.param_groups for p in g["params"]]
    names = list(named)
    if len(params) != len(names) or any(p is not named[n] for p, n in zip(params, names)):
        raise ValueError("named params must be the optimizer's parameters, in its order")
    return names


def train_state(named: dict, optimizer, mesh=None, specs: dict | None = None) -> dict:
    """{"params": {name: tensor}, "opt": {"state": {name: {...}},
    "param_groups": [...]}} of a train step's live params (`named`: name ->
    tensor, in the optimizer's order) and its torch optimizer, for
    save_checkpoint or as load_checkpoint's `like`. The optimizer's per-param
    state is keyed by name in place of position. With `mesh` and `specs`
    (name -> spec), each param split over a mesh axis, and its moments, is
    a DTensor of this rank's shard. A fresh optimizer first gets its state
    (a step at lr 0). The tensors share storage with the live ones."""
    names = _checked_names(named, optimizer)
    _init_state(optimizer)

    def lay(name, x):
        if mesh is None or specs is None or not any(specs[name]):
            return x.detach() if isinstance(x, torch.Tensor) else x
        return _layout(x, mesh, specs[name])

    sd = optimizer.state_dict()
    state = {name: {k: lay(name, v) if isinstance(v, torch.Tensor) and v.ndim else v
                    for k, v in sd["state"][i].items()} for i, name in enumerate(names)}
    groups = [{k: v for k, v in g.items() if k != "params"} for g in sd["param_groups"]]
    return {"params": {name: lay(name, named[name]) for name in names},
            "opt": {"state": state, "param_groups": groups}}


def restore_train_state(state: dict, named: dict, optimizer) -> None:
    """Copy a loaded `train_state` tree into the live params (in place) and
    the optimizer (its state and hyperparameters)."""
    names = _checked_names(named, optimizer)

    def local(x):
        return x.to_local() if _is_dtensor(x) else x

    with torch.no_grad():
        for name in names:
            named[name].copy_(local(state["params"][name]))
    sd = optimizer.state_dict()
    sd["state"] = {i: {k: local(v) for k, v in state["opt"]["state"][name].items()}
                   for i, name in enumerate(names)}
    for group, loaded in zip(sd["param_groups"], state["opt"]["param_groups"]):
        group.update({k: v for k, v in loaded.items() if v is not None})
    optimizer.load_state_dict(sd)
