"""Build and load the package's native code with ctypes.

CUDA kernels: each `csrc/<name>.cu` has a plain C interface (no PyTorch
headers, so nvcc takes seconds, not minutes) and is compiled for Hopper into
`build/kernels/lib<name>.so` beside the package on first use. The host's
native helpers, shared with the JAX package, are compiled with g++ into
`build/`: the continuous-batching scheduler core (`native/scheduler.cpp` ->
`build/libscheduler.so`), the n-gram draft proposer of speculative
decoding (`native/ngram.cpp` -> `build/libngram.so`) and the prefix cache's
page store (`native/prefix_store.cpp` -> `build/libprefix_store.so`); the
tracked `native/` directory is never written, and no library there is
loaded.

A library is rebuilt when its source, or a header beside it, is newer than
it. Builds write to a temporary file and rename it into place, so concurrent
processes never load a half-written library.
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
NATIVE = ("scheduler", "ngram", "prefix_store")  # native/<name>.cpp -> build/lib<name>.so

KERNELS = ("flash_fwd", "flash_bwd", "quant_int8", "int8_fwd", "int8_bwd",
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
    """True when `lib` is missing or older than its source or any header
    beside the source (`*.cuh`, `*.h`): a header such as csrc/hopper.cuh may
    be included by several sources."""
    if not os.path.exists(lib):
        return True
    folder = os.path.dirname(src)
    deps = [src] + [os.path.join(folder, f) for f in os.listdir(folder)
                    if f.endswith((".cuh", ".h"))]
    return os.path.getmtime(lib) < max(map(os.path.getmtime, deps))


def _kernel_paths(name: str) -> tuple[str, str]:
    return os.path.join(CSRC_DIR, f"{name}.cu"), os.path.join(KERNEL_DIR, f"lib{name}.so")


def _kernel_job(src: str, lib: str) -> tuple[list[str], str]:
    return [_nvcc(), *NVCC_FLAGS, src], lib


def _native_paths(name: str) -> tuple[str, str]:
    return os.path.join(_ROOT, "native", f"{name}.cpp"), os.path.join(BUILD_DIR, f"lib{name}.so")


def _native_job(src: str, lib: str) -> tuple[list[str], str]:
    return ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src], lib


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


def load_native(name: str) -> ctypes.CDLL:
    """Build (if stale) and load `native/<name>.cpp` (one of NATIVE) with
    g++; raises on failure."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src, lib = _native_paths(name)
        if _stale(lib, src):
            _compile(*_native_job(src, lib))
        _libs[name] = ctypes.CDLL(lib)
        return _libs[name]


def build_all() -> float:
    """Build every kernel and native helper, one compiler process per stale
    source, all started together; load them. Returns the seconds it took."""
    t0 = time.perf_counter()
    jobs = [_kernel_job(src, lib) for src, lib in map(_kernel_paths, KERNELS) if _stale(lib, src)]
    jobs += [_native_job(src, lib) for src, lib in map(_native_paths, NATIVE) if _stale(lib, src)]
    with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        list(pool.map(lambda job: _compile(*job), jobs))
    for name in KERNELS:
        load_kernel(name)
    for name in NATIVE:
        load_native(name)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler output of the last build of kernel `name` (ptxas -v)."""
    with open(_kernel_paths(name)[1] + ".log") as f:
        return f.read()
