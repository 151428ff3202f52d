"""Failure detection for long-running training and serving jobs.

Counterpart of quantizedattention_tpu/utils/failure.py. A sick card or a
dead rank presents as a collective that never completes or a device
round trip that never returns, not as an error code, so detection is
deadline-based:

  * `Watchdog`: runs `probe()` on a worker thread every `interval_s`; a
    probe that exceeds `timeout_s` or raises fires the failure callback
    (once) with a diagnostic. Used for device heartbeats.
  * `device_heartbeat`: one tiny op on the device read back to the host;
    its latency.
  * `hosts_alive`: an all_reduce of ones over the world group under a
    deadline: every live rank adds 1, so a missing or hung rank makes the
    collective hang, and the deadline turns the hang into a TimeoutError.
  * `StepGuard`: wraps a step callable, records durations (each ended by a
    CUDA event the guard waits for) and flags a STALL when a step exceeds
    `stall_factor` x the running median, calling `on_stall` (checkpoint and
    abort, so the launcher restarts from utils/checkpoint.py).

Recovery is restart-based: detect fast, checkpoint often, let the launcher
respawn the ranks.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


class _ProbeTimeout(Exception):
    pass


def _run_with_deadline(fn, timeout_s: float):
    """Run fn() on a DAEMON thread; raise _ProbeTimeout after timeout_s.

    Not a ThreadPoolExecutor: its workers are joined at interpreter exit
    (and at `with` exit), so a probe wedged in a hung collective would keep
    the timeout from propagating and the process from ever exiting. A
    daemon thread is abandoned: it leaks until the process exits, the
    accepted cost of detecting an unrecoverable hang.
    """
    q: queue.Queue = queue.Queue(maxsize=1)

    def _runner():
        try:
            q.put(("ok", fn()))
        except Exception as e:  # noqa: BLE001 - relayed to the caller
            q.put(("err", e))

    t = threading.Thread(target=_runner, daemon=True)
    t.start()
    try:
        status, payload = q.get(timeout=timeout_s)
    except queue.Empty:
        raise _ProbeTimeout(f"probe exceeded {timeout_s}s deadline") from None
    if status == "err":
        raise payload
    return payload


def _device(device) -> torch.device:
    """`device`, or the current CUDA device; no card raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to probe the host")
    return torch.device("cuda", torch.cuda.current_device())


def device_heartbeat(device=None) -> float:
    """Seconds for one tiny device round trip: an 8 x 8 op on `device` (the
    current CUDA device by default; "cpu" probes the host) read back with
    `.item()`. A healthy card answers in well under a millisecond after the
    first call; a wedged one never returns: pair with `Watchdog`."""
    dev = _device(device)
    t0 = time.perf_counter()
    x = torch.ones((8, 8), device=dev)
    (x * 2.0).sum().item()
    return time.perf_counter() - t0


def hosts_alive(timeout_s: float = 60.0, device=None) -> int:
    """Count of live ranks via a deadline-guarded all_reduce of ones.

    With no process group, or one rank, it takes a heartbeat of `device`
    and returns 1. Otherwise every rank of the world group must call it: the
    all_reduce runs on the backend's device (this rank's card on NCCL, the
    host on gloo), and its wait (`.item()`: NCCL's all_reduce returns when
    it is queued) runs inside the deadline too. A rank that never joins makes
    it raise TimeoutError after timeout_s; the wedged probe thread is a
    daemon and blocks nothing."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        device_heartbeat(device)  # still verify the local device answers
        return 1
    n = dist.get_world_size()
    dev = _device(None) if dist.get_backend() == "nccl" else torch.device("cpu")

    def _probe():
        ones = torch.ones(1, device=dev)
        dist.all_reduce(ones)
        return int(ones.item())

    try:
        return _run_with_deadline(_probe, timeout_s)
    except _ProbeTimeout as e:
        raise TimeoutError(
            f"hosts_alive: collective did not complete within {timeout_s}s "
            f"— at least one of {n} hosts is unreachable"
        ) from e


@dataclass
class FailureEvent:
    kind: str          # "probe_timeout" | "probe_error" | "stall"
    detail: str
    elapsed_s: float
    at: float = field(default_factory=time.time)


class Watchdog:
    """Deadline monitor: `probe()` every `interval_s`; `on_failure(event)`
    fires (once) if a probe exceeds `timeout_s` or raises."""

    def __init__(self, probe=device_heartbeat, interval_s: float = 30.0,
                 timeout_s: float = 120.0, on_failure=None):
        self._probe = probe
        self._interval = interval_s
        self._timeout = timeout_s
        self._on_failure = on_failure
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.failures: list[FailureEvent] = []
        self.probes_ok = 0
        self.last_latency_s: float | None = None

    def _fail(self, event: FailureEvent):
        self.failures.append(event)
        if self._on_failure is not None:
            self._on_failure(event)

    def _loop(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                out = _run_with_deadline(self._probe, self._timeout)
                self.last_latency_s = out if isinstance(out, float) else (
                    time.perf_counter() - t0)
                self.probes_ok += 1
            except _ProbeTimeout:
                self._fail(FailureEvent(
                    "probe_timeout",
                    f"probe exceeded {self._timeout}s deadline",
                    time.perf_counter() - t0,
                ))
                return  # a hung probe thread cannot be reclaimed; stop
            except Exception as e:  # noqa: BLE001 - surface any probe error
                self._fail(FailureEvent(
                    "probe_error", f"{type(e).__name__}: {e}",
                    time.perf_counter() - t0,
                ))
                return
            self._stop.wait(self._interval)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._timeout + 1.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class StepGuard:
    """Wraps a training step: duration stats + stall detection.

    A step slower than `stall_factor` x the running median (after
    `warmup_steps`) flags a stall, the signature of a wedged collective or
    a straggler rank, and calls `on_stall(event)` (checkpoint and abort is
    the intended reaction; utils/checkpoint.py restores on restart).

    The port's train steps return the loss while their backward and
    optimizer step are still queued on the card, and the loss is ready
    before them, so waiting for the output would time too little: the guard
    records a CUDA event on the current stream after the call and waits for
    it. Where CUDA was never initialised there is nothing queued to wait
    for.
    """

    def __init__(self, step_fn, stall_factor: float = 10.0,
                 warmup_steps: int = 3, on_stall=None):
        self._fn = step_fn
        self._factor = stall_factor
        self._warmup = warmup_steps
        self._on_stall = on_stall
        self.durations: list[float] = []
        self.stalls: list[FailureEvent] = []

    def _median(self) -> float:
        ds = sorted(self.durations)
        return ds[len(ds) // 2]

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        dt = time.perf_counter() - t0
        if len(self.durations) >= self._warmup and dt > self._factor * self._median():
            ev = FailureEvent(
                "stall", f"step took {dt:.3f}s vs median {self._median():.3f}s", dt
            )
            self.stalls.append(ev)
            if self._on_stall is not None:
                self._on_stall(ev)
        self.durations.append(dt)
        return out
