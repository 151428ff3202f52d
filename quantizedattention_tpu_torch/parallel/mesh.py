"""The (data, model, context) mesh over a process group, and its collectives.

Counterpart of quantizedattention_tpu/parallel/mesh.py. Axis convention:

  data     - batch (serving slots); no communication inside attention
  model    - heads (tensor parallelism); attention needs none, the out and
             down projections sum their partial products
  context  - sequence; each rank holds a slice of the tokens

The mesh is a torch DeviceMesh (`init_device_mesh`) with those dim names;
`axis_index`, `axis_size`, `psum` and `pmax` are the small counterparts of
JAX's `jax.lax` functions of the same names. Each collective is one
`dist.all_reduce` over the axis's sub-group, issued by every rank of it in
the same order; an axis of size 1 issues none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

AXES = ("data", "model", "context")


def make_attention_mesh(data: int = 1, model: int = 1, context: int = 1,
                        device_type: str = "cuda"):
    """A (data, model, context) DeviceMesh over every rank of the process
    group (parallel/multihost.py:initialize_multihost starts it), ranks in
    row-major order. device_type "cuda" (the default) or "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize_multihost first")
    want = data * model * context
    if want != dist.get_world_size():
        raise ValueError(f"mesh {data}x{model}x{context} needs {want} ranks, the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, (data, model, context), mesh_dim_names=AXES)


def is_mesh(mesh) -> bool:
    """True for a DeviceMesh that names the data and model axes."""
    from torch.distributed.device_mesh import DeviceMesh

    names = getattr(mesh, "mesh_dim_names", None) or ()
    return isinstance(mesh, DeviceMesh) and "data" in names and "model" in names


def axis_size(mesh, axis: str) -> int:
    """Ranks along `axis` (1 for an axis the mesh does not name)."""
    if axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def _reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    if axis_size(mesh, axis) > 1:
        dist.all_reduce(x, op=op, group=mesh.get_group(axis))
    return x


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of x over the ranks of `axis`, reduced IN PLACE into x (a
    contiguous tensor this call may overwrite) and returned."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise max of x over the ranks of `axis`, in place, returned."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def shard_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a full tensor under `spec`, a tuple naming the
    mesh axis each leading dim is split over (None, or a missing entry:
    replicated), as a JAX PartitionSpec does. The block is a contiguous copy,
    so the full tensor can be freed."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axis}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axis) * size, size)
    return x.clone(memory_format=torch.contiguous_format)
