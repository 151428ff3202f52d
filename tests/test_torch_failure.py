"""utils/failure.py of the port: the failure-detection tests of
tests/test_utils.py (heartbeat, single-process hosts_alive, the three
Watchdog cases, the two StepGuard cases) and tests/test_multiprocess_failure.py
(hosts_alive over two real processes: alive gives 2; a peer that stops
joining collectives gives TimeoutError within the deadline).

The two processes join a gloo process group on a file:// store in the
test's temporary directory (no network) and import torch and the port
only. The probes run on the host: a CPU tensor, `device="cpu"`.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from quantizedattention_tpu_torch.utils import (
    StepGuard,
    Watchdog,
    device_heartbeat,
    hosts_alive,
)

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_heartbeat_fast():
    t = device_heartbeat("cpu")
    assert 0 < t < 60.0


def test_hosts_alive_single_process():
    assert hosts_alive(timeout_s=120.0, device="cpu") == 1


def test_watchdog_healthy_probe():
    wd = Watchdog(probe=lambda: 0.001, interval_s=0.01, timeout_s=5.0)
    with wd:
        time.sleep(0.2)
    assert wd.probes_ok >= 2 and not wd.failures


def test_watchdog_detects_hung_probe():
    events = []
    wd = Watchdog(probe=lambda: time.sleep(30), interval_s=0.01,
                  timeout_s=0.3, on_failure=events.append)
    wd.start()
    deadline = time.time() + 10
    while not wd.failures and time.time() < deadline:
        time.sleep(0.05)
    wd._stop.set()  # don't join the wedged probe
    assert wd.failures and wd.failures[0].kind == "probe_timeout"
    assert events and events[0] is wd.failures[0]


def test_watchdog_detects_probe_error():
    def bad():
        raise RuntimeError("chip on fire")

    wd = Watchdog(probe=bad, interval_s=0.01, timeout_s=1.0)
    wd.start()
    deadline = time.time() + 10
    while not wd.failures and time.time() < deadline:
        time.sleep(0.05)
    wd.stop()
    assert wd.failures and wd.failures[0].kind == "probe_error"
    assert "chip on fire" in wd.failures[0].detail


def test_step_guard_flags_stall_and_calls_back():
    sleep_for = [0.01]
    stalls = []

    def step(x):
        time.sleep(sleep_for[0])
        return x + 1

    guarded = StepGuard(step, stall_factor=10.0, warmup_steps=3, on_stall=stalls.append)
    x = torch.zeros(())
    for _ in range(4):
        x = guarded(x)
    median = sorted(guarded.durations)[len(guarded.durations) // 2]
    sleep_for[0] = max(0.5, 15.0 * median)  # unambiguous straggler
    x = guarded(x)
    assert float(x) == 5.0
    assert len(guarded.stalls) == 1 and stalls[0].kind == "stall"
    assert len(guarded.durations) == 5


def test_step_guard_catches_slow_computation():
    """A step whose work grows must trip the guard once it crosses the
    factor; on the host the work is done when the call returns (on the card
    the guard waits for a CUDA event, chip_smoke.py phase 29)."""

    def step(x, n):
        for _ in range(n):
            y = x @ x
            x = y / torch.clamp(y.abs().max(), min=1.0)
        return x

    stalls = []
    guarded = StepGuard(step, stall_factor=30.0, warmup_steps=3, on_stall=stalls.append)
    x = torch.eye(128) + 0.01
    for _ in range(4):
        x = guarded(x, 1)
    n = 200
    while not guarded.stalls and n <= 200_000:
        x = guarded(x, n)
        n *= 8
    assert len(guarded.stalls) >= 1 and stalls[0].kind == "stall"


_WORKER = r"""
import os, sys, time
sys.path.insert(0, %r)
import torch
torch.set_num_threads(1)
from quantizedattention_tpu_torch.parallel.multihost import initialize_multihost
from quantizedattention_tpu_torch.utils.failure import hosts_alive

store, rank, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
initialize_multihost(init_method=f"file://{store}", world_size=2, rank=rank, device_type="cpu")
if mode == "alive":
    print("RESULT alive", hosts_alive(timeout_s=60), flush=True)
elif mode == "straggle":
    # join once, then go silent: a live process that stops joining
    # collectives, the realistic presentation of a hung peer
    print("RESULT joined", hosts_alive(timeout_s=60), flush=True)
    time.sleep(60)
    os._exit(0)
elif mode == "detect":
    assert hosts_alive(timeout_s=60) == 2
    time.sleep(1.0)  # let the peer leave its first all_reduce
    t0 = time.perf_counter()
    try:
        print("RESULT undetected", hosts_alive(timeout_s=3), flush=True)
    except TimeoutError:
        print(f"RESULT detected TimeoutError {time.perf_counter() - t0:.1f}", flush=True)
    # the probe thread is wedged in the hung collective; the documented
    # reaction is checkpoint, then exit
    os._exit(0)
"""


def _spawn(store, rank, mode):
    return subprocess.Popen([sys.executable, "-c", _WORKER % _REPO, store, str(rank), mode],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_hosts_alive_two_processes(tmp_path):
    store = str(tmp_path / "store")
    procs = [_spawn(store, r, "alive") for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for out in outs:
        assert "RESULT alive 2" in out, out


def test_hosts_alive_detects_hung_peer(tmp_path):
    store = str(tmp_path / "store")
    p0, p1 = _spawn(store, 0, "detect"), _spawn(store, 1, "straggle")
    try:
        out0, _ = p0.communicate(timeout=120)
    finally:
        p1.kill()
        p1.communicate(timeout=30)
    assert "RESULT detected TimeoutError" in out0, out0
