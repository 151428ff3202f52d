"""Build and load the package's native code with ctypes.

CUDA kernels: each `csrc/<name>.cu` has a plain C interface (no PyTorch
headers, so nvcc takes seconds, not minutes) and is compiled for Hopper into
`build/kernels/lib<name>.so` beside the package on first use. The
continuous-batching scheduler core (`native/scheduler.cpp`, shared with the
JAX package) is compiled with g++ into `build/libscheduler.so`; the tracked
`native/` directory is never written.

A library is rebuilt when its source is newer than it. Builds write to a
temporary file and rename it into place, so concurrent processes never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG_DIR)
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_ROOT, "build")
KERNEL_DIR = os.path.join(BUILD_DIR, "kernels")
_SCHED_SRC = os.path.join(_ROOT, "native", "scheduler.cpp")
_SCHED_LIB = os.path.join(BUILD_DIR, "libscheduler.so")

KERNELS = ("flash_fwd", "flash_bwd", "decode", "quant_int8", "int8_fwd", "int8_bwd",
           "int8_linear", "int4_linear", "jvp", "cache_decode")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _stale(lib: str, src: str) -> bool:
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def _kernel_paths(name: str) -> tuple[str, str]:
    return os.path.join(CSRC_DIR, f"{name}.cu"), os.path.join(KERNEL_DIR, f"lib{name}.so")


def _kernel_job(src: str, lib: str) -> tuple[list[str], str]:
    return [_nvcc(), *NVCC_FLAGS, src], lib


def _scheduler_job() -> tuple[list[str], str]:
    return ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SCHED_SRC], _SCHED_LIB


def _compile(cmd: list[str], out: str) -> None:
    """Run a compiler command that writes `out`, atomically; keep its log."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    with open(out + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"build of {out} failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def load_kernel(name: str) -> ctypes.CDLL:
    """Build (if stale) and load `csrc/<name>.cu`; raises on failure."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src, lib = _kernel_paths(name)
        if _stale(lib, src):
            _compile(*_kernel_job(src, lib))
        _libs[name] = ctypes.CDLL(lib)
        return _libs[name]


def load_scheduler() -> ctypes.CDLL:
    """Build (if stale) and load the native scheduler core; raises on failure."""
    with _lock:
        if "scheduler" in _libs:
            return _libs["scheduler"]
        if _stale(_SCHED_LIB, _SCHED_SRC):
            _compile(*_scheduler_job())
        _libs["scheduler"] = ctypes.CDLL(_SCHED_LIB)
        return _libs["scheduler"]


def build_all() -> float:
    """Build every kernel and the scheduler, one compiler process per stale
    source, all started together; load them. Returns the seconds it took."""
    t0 = time.perf_counter()
    jobs = [_kernel_job(src, lib) for src, lib in map(_kernel_paths, KERNELS) if _stale(lib, src)]
    if _stale(_SCHED_LIB, _SCHED_SRC):
        jobs.append(_scheduler_job())
    with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        list(pool.map(lambda job: _compile(*job), jobs))
    for name in KERNELS:
        load_kernel(name)
    load_scheduler()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler output of the last build of kernel `name` (ptxas -v)."""
    with open(_kernel_paths(name)[1] + ".log") as f:
        return f.read()
