"""A pool of rank processes for multi-controller runs from one script.

`RankPool(world_size, device_type="cuda")` spawns `world_size` processes
(device_type "cpu": gloo on the CPU, as the tests run them), each of
which joins one process group (parallel/multihost.py:initialize_multihost
on a `file://` store in a fresh temporary directory, so nothing touches a
network) and then waits for work. `pool.run(fn, *args)` hands every rank
the same call, SPMD, and returns the ranks' results in rank order; `fn`
must be importable by name (a function of this package), since the ranks
are spawned, not forked, and import nothing of the caller's own module.
A rank's exception fails the call: the pool is torn down (a rank stuck in
a collective with it would otherwise wait for the group's timeout) and
the call raises with that rank's traceback.

On the card, rank r takes card r % visible cards, and the backend is
`choose_backend`'s: NCCL with a card a rank, gloo (CUDA tensors) where ranks
share cards. Kernels load from build/ as they are: build them in the parent
first (`_build.build_all()`), so that N ranks do not each run nvcc.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import shutil
import tempfile
import time
import traceback

import torch

_READY = "ready"


def _to_host(obj):
    """Tensors moved to the CPU, through dicts, lists, tuples and
    NamedTuples (the results a rank sends back)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, world_size, device_type, init_method, timeout_s, tasks, results):
    try:
        torch.set_num_threads(1)  # N ranks share the host's cores
        from quantizedattention_tpu_torch.parallel.multihost import initialize_multihost

        backend = initialize_multihost(init_method=init_method, world_size=world_size,
                                       rank=rank, device_type=device_type, timeout_s=timeout_s)
        results.put((rank, _READY, backend))
    except Exception:  # reported to the parent, which tears the pool down
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, "ok", _to_host(fn(*args, **kwargs))))
        except Exception:  # reported to the parent, which tears the pool down
            results.put((rank, "error", traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class RankPool:
    """`world_size` spawned ranks in one process group (see the module
    docstring). Use as a context manager, or call `close()`."""

    def __init__(self, world_size: int, device_type: str = "cuda", timeout_s: float = 600.0):
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self.timeout_s = timeout_s
        self._closed = False
        self._dir = tempfile.mkdtemp(prefix="qattn_ranks_")
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, world_size, device_type, f"file://{self._dir}/store",
                              timeout_s, self._tasks[r], self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        self.backend = self._collect()[0]

    def _collect(self) -> list:
        out = [None] * self.world_size
        deadline = time.monotonic() + self.timeout_s
        for _ in range(self.world_size):
            while True:
                try:
                    rank, status, value = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close(force=True)
                        raise RuntimeError(f"ranks {dead} exited" if dead else
                                           f"no result within {self.timeout_s} s") from None
            if status == "error":
                self.close(force=True)
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return out

    def run(self, fn, *args, **kwargs) -> list:
        """Every rank calls fn(*args, **kwargs); their results (tensors on
        the CPU), in rank order."""
        if self._closed:
            raise RuntimeError("the rank pool is closed (a rank failed, or close() was called)")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect()

    def close(self, force: bool = False) -> None:
        """Stop every rank (terminating those that do not stop within 30 s,
        or at once with `force`, as after a rank's failure, when the others
        may wait in a collective) and remove the store's directory."""
        self._closed = True
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive() and not force:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
