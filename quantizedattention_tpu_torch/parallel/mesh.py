"""The (data, model, context) mesh over a process group, and its collectives.

Counterpart of quantizedattention_tpu/parallel/mesh.py. Axis convention:

  data     - batch (serving slots); no communication inside attention
  model    - heads (tensor parallelism); attention needs none, the out and
             down projections sum their partial products
  context  - sequence; each rank holds a slice of the tokens

The mesh is a torch DeviceMesh (`init_device_mesh`) with those dim names;
`axis_index`, `axis_size`, `psum`, `pmax`, `pmean`, `ppermute`,
`all_gather`, `psum_scatter` and `all_to_all` are the small counterparts of
JAX's `jax.lax` functions of the same names (the last three tiled, as JAX's
`tiled=True`). Each collective runs over the axis's sub-group, issued by
every rank of it in the same order; an axis of size 1 issues none.

Backends: NCCL (a card a rank) runs every collective on the tensors as they
are. Gloo (the CPU tests, and ranks that share one card) reduces CUDA
tensors itself (`psum`, `pmax`, `pmean`), but its point-to-point, gather and
all-to-all calls read host memory: on gloo, `ppermute`, `all_gather` and
`all_to_all` of a CUDA tensor copy it to the host, run there and copy the
result back (the same collective, host-staged). `psum_scatter` is NCCL's
`reduce_scatter`; gloo lacks that for CUDA tensors (and, in some PyTorch
releases, at all), so on gloo it is one `all_reduce` followed by this rank's
slice: the same sum, n times the bytes.
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


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean of x over the ranks of `axis` (a psum then a division by the
    axis size), in a fresh tensor."""
    n = axis_size(mesh, axis)
    return x.clone() if n == 1 else psum(x.contiguous().clone(), mesh, axis) / n


def _staged(x: torch.Tensor, mesh, axis: str) -> bool:
    """Whether the axis's gloo group must see x on the host (see above)."""
    return x.device.type == "cuda" and dist.get_backend(mesh.get_group(axis)) == "gloo"


class Pending:
    """A ring shift in flight (`ppermute_start`): `wait()` returns the
    received tensors, in the order they were sent."""

    def __init__(self, outs, reqs, device=None):
        self._outs, self._reqs, self._device = outs, reqs, device

    def wait(self) -> list:
        for r in self._reqs:
            r.wait()
        self._reqs = []
        if self._device is not None:
            self._outs = [x.to(self._device) for x in self._outs]
            self._device = None
        return self._outs


def ppermute_start(xs, mesh, axis: str) -> Pending:
    """Start the one-hop ring shift of each tensor of `xs` along `axis`: the
    rank at coordinate i sends to (i + 1) % n and receives, into fresh
    buffers, what (i - 1) % n sent (jax.lax.ppermute with perm [(i, (i + 1)
    % n)]). One `dist.batch_isend_irecv` for all of them, the peers' global
    ranks from `dist.get_global_rank`. On NCCL the transfers run on the
    communicator's stream while this rank goes on; on gloo (host-staged for
    CUDA tensors) they are complete when this returns. An axis of size 1
    hands the tensors back as they are."""
    xs = list(xs)
    n = axis_size(mesh, axis)
    if n == 1:
        return Pending(xs, [])
    group = mesh.get_group(axis)
    i = axis_index(mesh, axis)
    dst = dist.get_global_rank(group, (i + 1) % n)
    src = dist.get_global_rank(group, (i - 1) % n)
    device = xs[0].device if _staged(xs[0], mesh, axis) else None
    send = [(x.cpu() if device is not None else x).contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in send]
    ops = [dist.P2POp(dist.isend, x, dst, group) for x in send] \
        + [dist.P2POp(dist.irecv, x, src, group) for x in outs]
    pending = Pending(outs, dist.batch_isend_irecv(ops), device)
    if device is not None:
        pending.wait()
    return pending


def ppermute(xs, mesh, axis: str) -> list:
    """`ppermute_start(...).wait()`: the received tensors."""
    return ppermute_start(xs, mesh, axis).wait()


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in coordinate order
    (jax.lax.all_gather tiled): one `dist.all_gather` (host-staged on gloo
    for CUDA tensors)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    staged = _staged(x, mesh, axis)
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.get_group(axis))
    out = torch.cat(parts, dim)
    return out.to(x.device) if staged else out


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's 1/n slice along `dim` of the sum of x over `axis`
    (jax.lax.psum_scatter tiled): NCCL's `dist.reduce_scatter`; on gloo one
    `all_reduce` of x, then the slice (see the module docstring)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axis}={n}")
    group = mesh.get_group(axis)
    size = x.shape[dim] // n
    if dist.get_backend(group) == "gloo":
        total = psum(x.contiguous().clone(), mesh, axis)
        return total.narrow(dim, axis_index(mesh, axis) * size, size).contiguous()
    parts = [c.contiguous() for c in x.split(size, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """jax.lax.all_to_all tiled: x split into n chunks along `split_dim`,
    chunk j sent to coordinate j, the received chunks concatenated along
    `concat_dim` in coordinate order. One `dist.all_to_all_single` on the
    chunks stacked (host-staged on gloo for CUDA tensors)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over {axis}={n}")
    staged = _staged(x, mesh, axis)
    send = torch.stack((x.cpu() if staged else x).chunk(n, split_dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis))
    out = torch.cat(recv.unbind(0), concat_dim)
    return out.to(x.device) if staged else out


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
