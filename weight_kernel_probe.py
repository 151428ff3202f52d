"""Where the time of the weight matmuls (B17 csrc/int8_linear.cu, B18
csrc/int4_linear.cu) goes, on one GPU.

    python3 weight_kernel_probe.py

Builds altered copies of the kernel source into build/probe/ (the checkout's
csrc/ is not touched) and times each beside the unaltered build, as
chip_smoke.py:device_ms does, on the same seeded inputs. The altered copies
compute wrong results on purpose; they are timed, never used:

- stream_no_widen: the streaming regime feeds the raw weight bytes to the
  mma (no widening);
- stream_no_mma: the streaming regime widens but runs no mma.sync;
- stream_no_sum: the streaming regime skips the cluster's k-split sum and
  the output stores;
- tc_no_widen: the tensor-core regime feeds the raw weight bytes to the
  products as their A operand;
- tc_no_refill: the tensor-core regime loads its first 4 stages only;
- tc_products_only: both of the last two: the products and barriers alone.

and of B18 at prefill, tc_no_fold: the products of a group's half are never
folded into the accumulator (so they never wait to be done).

Then a copy of B17's streaming kernel that stamps %globaltimer at 6 points
of every block: start, all copies issued, first chunk landed, mainloop
done, partial written, cluster sum and stores done. It prints each phase's
median over the blocks. Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch import _build
from quantizedattention_tpu_torch.ops.linear_tiling import plan_int4, plan_int8
from quantizedattention_tpu_torch.quantize.weights import quantize_weight, quantize_weight_int4

SRC = os.path.join(_build.CSRC_DIR, "int8_linear.cu")
SRC4 = os.path.join(_build.CSRC_DIR, "int4_linear.cu")
OUT_DIR = os.path.join(_build.BUILD_DIR, "probe")
DECODE = [(8, 1024, 1024), (8, 1024, 4096), (8, 4096, 1024), (8, 1024, 8192)]
PREFILL = [(2048, 1024, 4096), (2048, 4096, 1024)]

_WIDEN_A = ("const uint32_t a[4] = {widen_pair(wv[0], wv[1], 0), widen_pair(wv[0], wv[1], 1),\n"
            "                             "
            "widen_pair(wv[2], wv[3], 0), widen_pair(wv[2], wv[3], 1)};")
_MMA = "for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, b[nt][0], b[nt][1]);"
_SUM = "  cluster_reduce<T>(red, recv, m * BN, split, rank, [&](int e, float sum) {"
_TC_WIDEN = """      a[ks][0] = widen_pair(v[0], v[1], 0);
      a[ks][1] = widen_pair(v[0], v[1], 1);
      a[ks][2] = widen_pair(v[2], v[3], 0);
      a[ks][3] = widen_pair(v[2], v[3], 1);"""
_TC_REFILL = "    if (j >= 1) load(j - 1 + TC_STAGES);"
_TC_WAIT = "    mbar_wait(full(st), (j / TC_STAGES) & 1);"
_TC_FIRST_WAITS = "    if (j < TC_STAGES) mbar_wait(full(st), 0);"
_TC_RAW = "".join(f"      a[ks][{i}] = v[{i}];\n" for i in range(4))[:-1]
VARIANTS = {
    "as_is": [],
    "stream_no_widen": [(_WIDEN_A, "const uint32_t a[4] = {wv[0], wv[1], wv[2], wv[3]};")],
    "stream_no_mma": [(_MMA, "for (int nt = 0; nt < NT; ++nt) acc[nt][0] += "
                             "__uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[nt][0] ^ b[nt][1]);")],
    "stream_no_sum": [(_SUM, "  if (m < 0) cluster_reduce<T>(red, recv, m * BN, split, rank, "
                             "[&](int e, float sum) {")],
    "tc_no_widen": [(_TC_WIDEN, _TC_RAW)],
    "tc_no_refill": [(_TC_REFILL, ""), (_TC_WAIT, _TC_FIRST_WAITS)],
    "tc_products_only": [(_TC_WIDEN, _TC_RAW), (_TC_REFILL, ""), (_TC_WAIT, _TC_FIRST_WAITS)],
}
_FOLD = """    if (run_end) {
      wgmma_wait<0>();
      reg_fence(sub);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(sub[i], s[(i % 4) / 2]));
    }"""
VARIANTS4 = {"b18_as_is": [], "b18_tc_no_fold": [(_FOLD, "")]}
STAMPS = ["start", "issued", "first chunk", "mainloop", "partial", "sum + stores"]


def _altered(edits, path=SRC) -> str:
    src = open(path).read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"weight_kernel_probe: the kernel source changed; no anchor "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def _stamped() -> str:
    """The kernel with a %globaltimer stamp per phase of the streaming regime."""
    src = open(SRC).read().replace(
        '#include "hopper.cuh"',
        '#include "hopper.cuh"\n__device__ unsigned long long g_t[4096][8];\n'
        '#define STAMP(i) if (threadIdx.x == 0) { unsigned long long t_; '
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
        'g_t[blockIdx.y * gridDim.x + blockIdx.x][i] = t_; }')
    k0 = src.index("int8_stream_kernel(")
    for anchor, stamp in (("  if (tid == 0) {\n#pragma unroll\n    for (int i = 0; i < S_STAGES;",
                           "STAMP(0)\n"),
                          ("    const uint8_t* xs = smem + st * STAGE;\n    const uint8_t* ws",
                           "if (i == 0) STAMP(2)\n"),
                          ("  // This block's partial [8 NT, BN] f32", "STAMP(3)\n"),
                          (_SUM, "STAMP(4)\n"),
                          ("}\n\n// --- tensor-core regime ---", "STAMP(5)\n")):
        i = src.index(anchor, k0)
        src = src[:i] + stamp + src[i:]
    issue = "  for (int i = 0; i < S_STAGES; ++i) load(i);\n"
    i = src.index(issue, k0) + len(issue)
    src = src[:i] + "STAMP(1)\n" + src[i:]
    return src + ('\nextern "C" int qa_probe_stamps(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_t, sizeof(g_t));\n}\n')


def _build_lib(name: str, src: str) -> ctypes.CDLL:
    """Compile one altered source into build/probe/lib<name>.so and load it."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, path, "-o",
           os.path.join(OUT_DIR, f"lib{name}.so")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"weight_kernel_probe: build of {name} failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so"))
    if name.startswith("b18"):
        lib.qa_int4_linear.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.qa_int4_linear.restype = ctypes.c_int
    else:
        lib.qa_int8_linear.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.qa_int8_linear.restype = ctypes.c_int
    return lib


def _device_us(fn, calls=20, replays=10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays) * 1e3


def _inputs(gen, m, k, n):
    dev = torch.device("cuda", 0)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    q8 = quantize_weight(w)
    return x, q8, w.to(torch.bfloat16), torch.empty((m, n), dtype=torch.bfloat16, device=dev)


def _call(lib, x, q8, out):
    (m, k), n = x.shape, q8.w_i8.shape[1]
    plan = plan_int8(m, k, n)
    status = lib.qa_int8_linear(x.data_ptr(), q8.w_i8.data_ptr(), q8.scale.data_ptr(),
                                out.data_ptr(), m, n, k, 1, plan.bn, plan.split,
                                torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"weight_kernel_probe: launch failed with status {status}")


def _call4(lib, x4, q4, out):
    (m, kp), (half, n) = x4.shape, q4.packed.shape
    plan = plan_int4(m, half, n, q4.group)
    status = lib.qa_int4_linear(x4.data_ptr(), q4.packed.data_ptr(), q4.scale.data_ptr(),
                                out.data_ptr(), m, n, half, q4.group, 1, plan.bn, plan.split,
                                torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"weight_kernel_probe: launch failed with status {status}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("weight_kernel_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    jobs = {name: _altered(edits) for name, edits in VARIANTS.items()}
    jobs.update({name: _altered(edits, SRC4) for name, edits in VARIANTS4.items()})
    jobs["stamped"] = _stamped()
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in DECODE + PREFILL:
        x, q8, wb, out = _inputs(gen, m, k, n)
        names = [v for v in VARIANTS if v == "as_is" or v.startswith("stream" if m <= 64 else "tc")]
        times = {v: _device_us(lambda v=v: _call(libs[v], x, q8, out)) for v in names}
        times["bf16 torch.matmul"] = _device_us(lambda: torch.matmul(x, wb))
        print(f"[probe] m={m} k={k} n={n}: " + ", ".join(f"{v} {t:.2f}" for v, t in times.items())
              + f" us ({smi})", flush=True)
    for m, k, n in PREFILL:
        x, q8, _, out = _inputs(gen, m, k, n)
        q4 = quantize_weight_int4(torch.randn((k, n), generator=gen, device=x.device) * k ** -0.5)
        x4 = F.pad(x, (0, 2 * q4.packed.shape[0] - k))
        times = {v: _device_us(lambda v=v: _call4(libs[v], x4, q4, out)) for v in VARIANTS4}
        print(f"[probe] m={m} k={k} n={n}: " + ", ".join(f"{v} {t:.2f}" for v, t in times.items())
              + f" us ({smi})", flush=True)
    lib = libs["stamped"]
    for m, k, n in DECODE:
        x, q8, _, out = _inputs(gen, m, k, n)
        plan = plan_int8(m, k, n)
        _call(lib, x, q8, out)  # warm: code and weights as a graph replay finds them
        torch.cuda.synchronize()
        _call(lib, x, q8, out)
        torch.cuda.synchronize()
        stamps = np.zeros((4096, 8), dtype=np.uint64)
        lib.qa_probe_stamps(ctypes.c_void_p(stamps.ctypes.data))
        t = stamps[:plan.ctas, :len(STAMPS)].astype(np.int64)
        phases = np.diff(t, axis=1)  # per block, ns
        span = (t[:, -1].max() - t[:, 0].min()) / 1e3
        print(f"[split] m={m} k={k} n={n} (bn {plan.bn}, split {plan.split}, {plan.ctas} blocks): "
              + ", ".join(f"{a} -> {b} {np.median(phases[:, i]) / 1e3:.2f}"
                          for i, (a, b) in enumerate(zip(STAMPS, STAMPS[1:])))
              + f" us (medians over blocks); first start to last end {span:.2f} us", flush=True)


if __name__ == "__main__":
    main()
