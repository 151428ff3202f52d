"""Process-group start-up for a multi-process run, and the pod mesh.

Counterpart of quantizedattention_tpu/parallel/multihost.py. JAX runs one
controller per host; PyTorch runs one process per rank (multi-controller
SPMD): every rank runs the same program, holds its own shard of the
parameters and caches, and meets the others in collectives. This module
joins a rank to its process group (`initialize_multihost`) and lays the
(data, model, context) mesh over the ranks (`make_pod_mesh`).

Nothing here reaches a network: the default rendezvous is a `file://`
store in a fresh temporary directory (one process), and a caller that
spawns ranks passes them a shared `file://` path or `tcp://127.0.0.1:<port>`.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from quantizedattention_tpu_torch.parallel.mesh import make_attention_mesh


def choose_backend(world_size: int, device_type: str = "cuda") -> str:
    """The process group's backend: NCCL when every rank has a card of its
    own, else gloo. NCCL refuses two ranks on one card; gloo reduces CUDA
    tensors too (all_reduce and broadcast, the only collectives the mesh
    paths issue), so ranks sharing a card run the same code over gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: card rank % visible cards, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_multihost(backend: str | None = None, init_method: str | None = None,
                         world_size: int | None = None, rank: int | None = None,
                         device_type: str = "cuda", timeout_s: float | None = None) -> str:
    """Join this process to its process group; returns the backend.

    With no arguments: a launcher's environment (torchrun's RANK and
    WORLD_SIZE) if it is set, else a one-rank group on a private `file://`
    store. An explicit init_method, world_size or rank that fails raises:
    a run that was asked for N ranks never goes on as N one-rank runs. On a
    card the rank binds card rank % visible cards before the group starts.
    `backend` defaults to `choose_backend(world_size, device_type)`. A no-op
    (returning the group's backend) when the group already exists."""
    if dist.is_initialized():
        return dist.get_backend()
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if not explicit:
        if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
            init_method = "env://"
            world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        else:
            store = os.path.join(tempfile.mkdtemp(prefix="qattn_pg_"), "store")
            init_method, world_size, rank = f"file://{store}", 1, 0
    if world_size is None or rank is None or init_method is None:
        raise ValueError("initialize_multihost needs init_method, world_size and rank together")
    backend = backend or choose_backend(world_size, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    return backend


def make_pod_mesh(data_dcn: int = 1, data: int = 1, model: int = 1, context: int = 1,
                  device_type: str = "cuda"):
    """Mesh("data", "model", "context") with the hosts' replicas outermost on
    data: data_dcn groups of data x model x context ranks. A launcher numbers
    a host's ranks contiguously, so the outermost axis is the one that
    crosses hosts and the model and context axes stay within one. Requires
    data_dcn * data * model * context == the world size."""
    n = data_dcn * data * model * context
    if n != dist.get_world_size():
        raise ValueError(f"mesh {data_dcn}x{data}x{model}x{context}={n} != "
                         f"{dist.get_world_size()} ranks")
    return make_attention_mesh(data_dcn * data, model, context, device_type)
