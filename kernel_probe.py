"""Where the time of a kernel goes, on one GPU: the weight matmuls (B17
csrc/int8_linear.cu, B18 csrc/int4_linear.cu), the int8 backward (B7 and
B8, csrc/int8_bwd.cu), the bf16 flash forward (B1, csrc/flash_fwd.cu) and
its backward's fast mode (B2 and B3, csrc/flash_bwd.cu), B1's fp32 mode,
the JVP family's fast kernels (B9, B11, B12, csrc/jvp.cu) and the decode
kernels (B13-B16, one body in csrc/cache_decode.cu, its int4 instance in
decode4 and its int8 one in decode8), the Q/K/V quantizer (B4, quant) and
the tangent's exact mode (B10, jvp_tangent, also a numerics witness); and
two numerics witnesses, bwd_exact and fwd_fp32.

    python3 kernel_probe.py [weights] [int8_bwd] [flash_fwd] [flash_bwd] [bwd_exact]
                            [fwd_fp32] [jvp_bwd] [jvp_fwd] [jvp_dq] [decode4] [decode8]
                            [quant] [jvp_tangent] [PARENT_CHECKOUT]  (all parts without
                            arguments)

Builds altered copies of a kernel source into build/probe/ (the checkout's
csrc/ is not touched) and times each beside the unaltered build, as
chip_smoke.py:device_ms does, on the same seeded inputs. The altered copies
compute wrong results on purpose; they are timed, never used.

weights:
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
median over the blocks.

int8_bwd, at chip_smoke.py's timing shapes (4,16,2048,64) and GQA rep 4
(2,16 q / 4 kv,2048,64), causal:
- no_exp: P takes its exponent's argument (no MUFU.EX2);
- no_elementwise: P and dS are never computed (the products run on stale
  fragments);
- no_late_products: B7 skips dV and dK_seg, B8 skips dQ_seg;
- no_widen: the int8 tiles (B7's Q, B8's K and V) are not widened;
- late_a_from_smem: dV, dK_seg (B7) and dQ_seg (B8) read their A operand
  from a tile of the stage in shared memory instead of the P^T / dS
  fragments in registers;
and a copy that sums clock64 cycles by phase of the mainloop in each
warpgroup (thread 0 of each, into shared memory), printed as cycles per
mainloop tile over all blocks.

flash_fwd, at (4,16,2048,64), (8,16,256,64) and (4,16,8192,64), causal, bf16
inputs (the kernel alone, no prep launch); each build's ptxas registers,
spills and C75xx notes are printed:
- stages_5: a ring of 5 K/V stages instead of 3;
- no_exp: P takes its exponent's argument (no MUFU.EX2);
- no_softmax: no softmax at all (the products run on stale P);
- no_mask: no tile takes the mask (wrong on the diagonal and ragged tiles);
- no_pv: the mainloop issues no PV;
and a copy that sums clock64 cycles by phase of the mainloop's step in each
warpgroup, printed as cycles per key tile.

flash_bwd, B2 and B3 in fast mode on prepared operands at (4,16,2048,64)
and GQA rep 4 (2,16 q / 4 kv,2048,64), causal; each build's ptxas
registers, spills and C75xx notes are printed:
- stages_6: rings of 6 stages instead of 4;
- no_exp: P takes its exponent's argument (no MUFU.EX2);
- no_elementwise: P and dS are never computed (the products run on stale
  fragments);
- no_late_products: B2 skips dV and dK, B3 skips dQ;
and a copy that sums clock64 cycles by phase of the mainloop's tile in each
warpgroup, printed as cycles per tile. The stamps sit between products and
their waits, so ptxas serializes that copy's wgmma (C7515): its phases say
where a warpgroup waits, not how the unstamped kernel overlaps.

bwd_exact times nothing: it holds B2/B3 (csrc/flash_bwd.cu) on chip_smoke.py
phase 6's one-token case (1, 3 q / 1 kv heads, t = s = 1, causal) against a
float64 evaluation of the same operands (the bf16-rounded ones in fast
mode), beside the plain version, in exact mode and then in fast mode. There
dS = P (dP - D) with O = V rounded to bf16, so dP - D is a rounding error
and the f32 sums that form dP and D cancel. It prints each tensor's
max|diff| / max|reference| for kernel vs plain (phase 6's gate: 1e-4 exact,
1e-2 fast), kernel vs float64 and plain vs float64: in exact mode first on
the inputs phase 6 drew when phase 3's edge cases took their inputs from the
shared generator (its draws replayed), then, in each mode, the worst over
256 seeds of the case and the seeds over the gate and over half of it.

fwd_fp32 times nothing: it holds B1's fp32 mode (3xTF32, csrc/flash_fwd.cu)
against float64 on the same inputs (q scaled by qk_scale in f32, as the
kernels scale it) over 256 seeds at (1,3,300,64), causal and not, and prints
the worst max|dO| / max|O| and max|dlse|. Given a parent checkout (a
directory among the arguments) whose csrc/flash_fwd.cu holds the FFMA
design's fp32 kernel, it builds that too (build/probe/) and holds it on the
same inputs, with the ratio of the two designs' worst errors. Then B1
fp32's kernel alone (on the K/V prep's outputs) at the DiT's (4,4,4096,64)
and bench_jvp's (4,16,4096,64) shapes, non-causal, beside its knock-outs
(each build's ptxas registers and C75xx notes printed):
- 1xtf32: only the big.big products (16 of the 48 a tile);
- no_exp: P takes its exponent's argument (no MUFU.EX2);
- no_softmax: no softmax at all (P V runs on stale P);
- no_pv: no P V products;
- turns: warpgroup turns, each warpgroup issuing its products only after
  the other issued its last (bar.sync / bar.arrive), so that one's softmax
  could run under the other's products.

jvp_bwd: B11 fast's kernel alone (on its prep's outputs) at the same two
shapes beside its knock-outs:
- no_exp: p takes its exponent's argument;
- no_elementwise: p^T, tP^T, dS^T, tSb^T never computed (the second
  products run on stale fragments);
- no_second: no dV, dtV, dK, dtK products;
- turns: warpgroup turns around each issue of products, as B1 fp32's.

jvp_fwd: B9 fast's kernel alone (on its K-side prep's outputs, q and tq the
DiT's [b, h, t, d] views of [b, t, h, d] tensors) at the same two shapes
beside its knock-outs, with each build's ptxas registers and spills:
- no_exp: p takes its exponent's argument;
- no_elementwise: the softmax, P and H never computed (the products run on
  stale fragments);
- no_second: no O, A, B products;
- keys32: 32-key tiles (8 stages) instead of 64.

jvp_dq: B12 fast's kernel alone (on the shared prep's outputs) at the same
two shapes beside its knock-outs, as jvp_fwd's:
- no_exp, no_elementwise (dS and tSb never computed), no_second (no dQ,
  dtQ products);
- keys64: 64-key tiles (4 stages) instead of 32.

decode4: B15 (`qa_decode4`) called on its entry with bf16 q (no cast
launch) at 8 sequences x 16 q heads: length 304 of 1280 at spec 1 (the
serving decode) and 5 (its verify pass), 1280 of 1280 at 16/16 and 16/4
heads; each build's ptxas registers and spills are printed, and timed:
- as_is, and on f32 q (rounded in the kernel); the merge by a second launch
  instead of the last block (merge_launch: no_merge's kernel, then a merge
  kernel appended to the copy); B16 on pages of 128 shuffled;
  the wrapper's q cast alone and the whole wrapper call on f32 and bf16 q;
- no_merge: the partials only (no arrival, no merge);
- no_unpack: the packed words fed to the products as they are;
- loads_only: the chunks' copies and nothing after them;
- one_chunk: chunk 0 alone (the other blocks exit), no merge;
- ex2_approx: p by ex2.approx.ftz instead of exp2f;
- empty: every block returns at once (the launch alone);
and a copy that stamps %globaltimer at each phase of a block (length read,
copies landed, S, the maxima exchanged, PV, the warps' sums shared,
partials written, arrival, end), printed as medians over the blocks that
run.

decode8: B13 (`qa_decode`, the int8 instance) on bf16 q at decode4's
shapes, each build's ptxas registers and spills printed, and timed:
- as_is, on f32 q (rounded in the kernel), B14 (`qa_paged_decode`) on
  pages of 128 shuffled, and the whole wrapper call on f32 q;
- no_merge, loads_only, one_chunk: as decode4's;
- no_widen: the int8 words fed to the products as they are (no byte
  permutes and adds);
- chunk128: chunks of 128 tokens (one tile a chunk, 16 tokens a warp), z
  from the grid's rule over 128-token chunks;
decode4's stamped copy, on the int8 instance; and B13's and B14's max|dO|
against their plain versions on chip_smoke.py's phase-21 and phase-23
inputs (stale scales, junk pages), with a digest of B15's and B16's
outputs there, in this checkout and in PARENT_CHECKOUT when one is given
(its own package, in a process of its own).
quant, B4 (csrc/quant_int8.cu) at the training shape (4,16,2048,64) on
contiguous f32, the model's strided f32 views and bf16 (B6's launch), each
build's ptxas registers and spills printed:
- as_is; loads_only: the payload stores skipped (loads, absmax, exchange);
- no_div: a product instead of the IEEE division (the division's cost);
- no_exchange: each block's own max (the cluster barriers stay);
- early_arrive: the second cluster arrival before the stores, not after;
- threads256: blocks of 256 threads;
and, given a PARENT_CHECKOUT, its B4 (the first design: a block a grain,
the grain read twice) as built there and without its second read.

jvp_tangent, B10 exact (csrc/jvp.cu, 3xTF32): the worst max|dtO| / max|tO|
against float64 over 256 seeds at the DiT's shape (4,4,4096,64) on its
strided views (O and lse from B1 fp32), of this design, of its in_place
variant (every tile's h V + p tV summed into the accumulator on the tensor
cores) and, given a PARENT_CHECKOUT, of the FFMA design built from it, with
the ratio to FFMA's (the design's gate: 4x); then the kernel alone (one
key range, on its prep's outputs) at the DiT, bench_jvp and dit_jvp
(2,4,512,64) shapes beside in_place and no_exp (p takes its exponent's
argument), with each build's ptxas registers and spills.
Exits non-zero without a GPU.
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
from quantizedattention_tpu_torch.ops import flash_fwd as tfwd
from quantizedattention_tpu_torch.ops import flash_tiling
from quantizedattention_tpu_torch.ops import int8_bwd as tbwd
from quantizedattention_tpu_torch.ops import (int8_attention_fwd_from_quantized, int8_bwd_operands,
                                              quantize_qkv)
from quantizedattention_tpu_torch.ops.common import LOG2_E, MASK_VALUE, tile_mask
from quantizedattention_tpu_torch.ops.linear_tiling import plan_int4, plan_int8
from quantizedattention_tpu_torch.quantize.bf16_correction import EPS_BIAS
from quantizedattention_tpu_torch.quantize.weights import quantize_weight, quantize_weight_int4

SRC = os.path.join(_build.CSRC_DIR, "int8_linear.cu")
SRC4 = os.path.join(_build.CSRC_DIR, "int4_linear.cu")
SRC_BWD = os.path.join(_build.CSRC_DIR, "int8_bwd.cu")
SRC_FWD = os.path.join(_build.CSRC_DIR, "flash_fwd.cu")
SRC_JVP = os.path.join(_build.CSRC_DIR, "jvp.cu")
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
            raise SystemExit(f"kernel_probe: the kernel source changed; no anchor "
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


def _build_lib(name: str, src: str, include: str = _build.CSRC_DIR) -> ctypes.CDLL:
    """Compile one altered source into build/probe/lib<name>.so (its headers
    from `include`) and load it."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, path, "-o",
           os.path.join(OUT_DIR, f"lib{name}.so")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"kernel_probe: build of {name} failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so"))
    lib.ptxas = [f"[ptxas] {name}: {line.split(' in function')[0].strip()}"
                 for line in proc.stderr.splitlines()
                 if "C75" in line or "spill" in line or "registers" in line]
    lib.ptxas_log = proc.stderr
    if name.startswith("fbwd"):
        from quantizedattention_tpu_torch.ops import flash_bwd as fbwd
        ref = fbwd._kernels()
        for fn in ("qa_flash_bwd_dkv", "qa_flash_bwd_dq"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
    elif name.startswith("fwd"):
        lib.qa_flash_fwd.argtypes = tfwd.ARGTYPES["qa_flash_fwd"]
        lib.qa_flash_fwd.restype = ctypes.c_int
    elif name.startswith("f32v"):
        lib.qa_flash_fwd_f32.argtypes = tfwd.ARGTYPES["qa_flash_fwd_f32"]
        lib.qa_flash_fwd_f32.restype = ctypes.c_int
    elif name.startswith("dkvv"):
        from quantizedattention_tpu_torch.ops import jvp_bwd as tjvp
        lib.qa_jvp_bwd_dkv_bf16.argtypes = tjvp._kernels().qa_jvp_bwd_dkv_bf16.argtypes
        lib.qa_jvp_bwd_dkv_bf16.restype = ctypes.c_int
    elif name.startswith("b9v"):
        from quantizedattention_tpu_torch.ops import jvp_fwd as tjf
        lib.qa_jvp_fwd_bf16.argtypes = tjf._ARGTYPES["qa_jvp_fwd_bf16"]
        lib.qa_jvp_fwd_bf16.restype = ctypes.c_int
    elif name.startswith("b12v"):
        from quantizedattention_tpu_torch.ops import jvp_bwd as tjvp
        lib.qa_jvp_bwd_dq_bf16.argtypes = tjvp._kernels().qa_jvp_bwd_dq_bf16.argtypes
        lib.qa_jvp_bwd_dq_bf16.restype = ctypes.c_int
    elif name.startswith(("d4", "d8")):
        from quantizedattention_tpu_torch.parallel import decode_launch
        for fn in ("qa_decode", "qa_paged_decode", "qa_decode4", "qa_paged4_decode"):
            getattr(lib, fn).argtypes = decode_launch._entry(fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        if name == "d4_merge_launch":
            lib.qa_probe_merge.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                           + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
            lib.qa_probe_merge.restype = ctypes.c_int
    elif name.startswith("quantv"):
        from quantizedattention_tpu_torch.quantize import int8 as tq
        lib.qa_quant_int8.argtypes = tq._kernel().argtypes
        lib.qa_quant_int8.restype = ctypes.c_int
    elif name.startswith("quantp"):  # the first design's entry: contiguous rows, no strides
        ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        lib.qa_quant_int8.argtypes = [ptrs] * 4 + [ints] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.qa_quant_int8.restype = ctypes.c_int
    elif name.startswith("tgv"):
        from quantizedattention_tpu_torch.ops import jvp_tangent as tjt
        lib.qa_jvp_tangent_tf32.argtypes = tjt._ARGTYPES["qa_jvp_tangent_tf32"]
        lib.qa_jvp_tangent_tf32.restype = ctypes.c_int
    elif name.startswith("tgffma"):  # the FFMA design's B10 entry (all contiguous f32)
        from quantizedattention_tpu_torch.ops import jvp_tangent as tjt
        lib.qa_jvp_tangent.argtypes = tjt._ARGTYPES["qa_jvp_tangent"]
        lib.qa_jvp_tangent.restype = ctypes.c_int
    elif name.startswith("ffma"):  # the FFMA design's fp32 entry (q pre-scaled, all contiguous)
        lib.qa_flash_fwd_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.qa_flash_fwd_f32.restype = ctypes.c_int
    elif name.startswith("bwd"):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.qa_int8_bwd_dkv.argtypes = [ptr] * 11 + [i32] * 9 + [f32, f32, ptr]
        lib.qa_int8_bwd_dq.argtypes = [ptr] * 11 + [i32] * 10 + [f32, f32, ptr]
        lib.qa_int8_bwd_dkv.restype = lib.qa_int8_bwd_dq.restype = ctypes.c_int
    elif name.startswith("b18"):
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
        raise SystemExit(f"kernel_probe: launch failed with status {status}")


def _call4(lib, x4, q4, out):
    (m, kp), (half, n) = x4.shape, q4.packed.shape
    plan = plan_int4(m, half, n, q4.group)
    status = lib.qa_int4_linear(x4.data_ptr(), q4.packed.data_ptr(), q4.scale.data_ptr(),
                                out.data_ptr(), m, n, half, q4.group, 1, plan.bn, plan.split,
                                torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: launch failed with status {status}")


def probe_weights(smi) -> None:
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


# --- the int8 backward (B7, B8) ---

BWD_SHAPES = [(4, 16, 16, 2048), (2, 16, 4, 2048)]  # (b, h, h_kv, t = s), causal
_B7_EXP = ("      p[e] = exp2_ftz(__fmul_rn(small_int_to_float(st[4 * n + e]), c) - "
           "((e & 1) ? l2.y : l2.x));")
_B8_EXP = "      float p = exp2_ftz(__fmul_rn(small_int_to_float(s_acc[4 * n + e]), c[h]) - lse_r[h]);"
_B7_COMPUTE = "    if (q0 + TILE > t || kw0 + 64 > s"
_B8_COMPUTE = "    if (k0 + TILE > s || (causal && k0 + TILE - 1 > q0))"
_B7_LATE = "    {  // dV += P^T dO"
_B8_LATE = "    {  // dQ_seg += dS K"
_B7_WIDEN = "    widen_tile_64x64(smem + DKV_OFF_Q + st * I8_TILE"
_B8_WIDEN = ("      widen_tile_64x64(smem + DQ_OFF_K + sn * I8_TILE,",
             "      widen_tile_64x64(smem + DQ_OFF_V + sn * I8_TILE,")
_SKIP = "    if (n_tiles < 0)\n"  # a condition that never holds, before the anchor
# the late products with A from a shared tile of the stage (K-major) instead
# of the P^T / dS fragments in registers
_SS_HELPER = """#include "hopper.cuh"
__device__ __forceinline__ void wgmma_ss_probe(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
"""
BWD_VARIANTS = {
    "bwd_as_is": [],
    "bwd_no_exp": [(_B7_EXP, _B7_EXP.replace("exp2_ftz(", "(")),
                   (_B8_EXP, _B8_EXP.replace("exp2_ftz(", "("))],
    "bwd_no_elementwise": [(_B7_COMPUTE, _SKIP + _B7_COMPUTE), (_B8_COMPUTE, _SKIP + _B8_COMPUTE)],
    "bwd_no_late_products": [(_B7_LATE, _SKIP + _B7_LATE), (_B8_LATE, _SKIP + _B8_LATE)],
    "bwd_no_widen": [(_B7_WIDEN, _SKIP + _B7_WIDEN),
                     *((a, "  " + _SKIP + a) for a in _B8_WIDEN)],
    "bwd_late_a_from_smem": [
        ('#include "hopper.cuh"\n', _SS_HELPER),
        ("wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dv_acc, pa[kk], desc_dot + 128 * kk, 1)",
         "wgmma_ss_probe(dv_acc, desc_kmajor_sw128(base + DKV_OFF_DO + st * BF_TILE) + 2 * kk, "
         "desc_dot + 128 * kk)"),
        ("wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dk_seg, da[kk], desc_qw + 128 * kk, 1)",
         "wgmma_ss_probe(dk_seg, desc_kmajor_sw128(base + DKV_OFF_DO + st * BF_TILE) + 2 * kk, "
         "desc_qw + 128 * kk)"),
        ("wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dq_seg, dsa[kk], desc_kw + 128 * kk, 1)",
         "wgmma_ss_probe(dq_seg, desc_kmajor_sw128(base + DQ_OFF_VW + (j % 2) * BF_TILE) + 2 * kk, "
         "desc_kw + 128 * kk)")],
}
# (anchor, phase ended there, insert before the anchor?) of each kernel's mainloop
B7_PHASES = [("    const float next_rows = fetch_rows(i + 1);\n", "refill + rows", False),
             ("    mbar_wait(full(st), (i / DKV_STAGES) & 1);\n", "TMA wait", False),
             (_B7_WIDEN, "issue S, dP", True),
             ("    wgmma_wait<0>();  // this tile's S^T", "widen Q + rows", True),
             ("    if (fold) {\n      fold_dk();", "wait products", True),
             ("    fence_proxy_async();  // the widened Q tile", "fold + P, dS", True),
             (_B7_LATE, "barrier", True),
             ("    // the (q head, q grain) segment ends", "issue dV, dK", True)]
B8_PHASES = [("    const int k0 = j * TILE;\n", "refill + loop top", False),
             ("    if (j + 1 < n_tiles) {  // the next tile's K and V", "issue S, dP", True),
             ("      mbar_wait(full(sn), ((j + 1) / DQ_STAGES) & 1);\n", "TMA wait", False),
             ("    wgmma_wait<0>();  // this tile's S, dP", "widen K, V", True),
             ("    if (fold) {\n      fold_dq();", "wait products", True),
             ("    fence_proxy_async();  // the next tile's widened K and V", "fold + P, dS", True),
             (_B8_LATE, "barrier", True),
             ("    if (++seg == kv_tiles_per_grain || j + 1 == n_tiles) {", "issue dQ", True)]
_SPLIT_HEAD = (
    '#include "hopper.cuh"\n'
    "__device__ long long g_cyc[2][8192][2][9];\n"
    "__shared__ long long probe_cyc[2][9];\n"
    "#define SPLIT(k) if ((threadIdx.x & 127) == 0) { const long long t_ = clock64(); "
    "probe_cyc[threadIdx.x / 128][k] += t_ - probe_t0; probe_t0 = t_; }\n")


def _split_kernel(src: str, start: str, loop: str, end: str, phases, which: int) -> str:
    """Stamps one kernel's mainloop (between `start` and `end`)."""
    k0 = src.index(start)
    out = src[:k0]
    body = src[k0:src.index(end, k0)]
    rest = src[src.index(end, k0):]
    for k, (anchor, _, before) in enumerate(phases):
        i = body.index(anchor)
        at = i if before else i + len(anchor)
        body = body[:at] + f"SPLIT({k})\n" + body[at:]
    i = body.index(loop)
    body = (body[:i] + "  if (threadIdx.x < 18) probe_cyc[threadIdx.x / 9][threadIdx.x % 9] = 0;\n"
            "  __syncthreads();\n  long long probe_t0 = clock64();\n" + body[i:])
    done = (f"  if ((threadIdx.x & 127) == 0) {{\n    const int w_ = threadIdx.x / 128;\n"
            f"    const int b_ = blockIdx.y * gridDim.x + blockIdx.x;\n"
            f"    for (int k_ = 0; k_ < 8; ++k_) g_cyc[{which}][b_][w_][k_] = probe_cyc[w_][k_];\n"
            f"    g_cyc[{which}][b_][w_][8] = n_tiles;\n  }}\n")
    return out + body + done + rest


def _bwd_split_source() -> str:
    src = open(SRC_BWD).read().replace('#include "hopper.cuh"\n', _SPLIT_HEAD)
    src = _split_kernel(src, "int8_dkv_kernel(", "  int j = j0;  // tile i's q tile",
                        "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    if (key[h] >= s)",
                        B7_PHASES, 0)
    src = _split_kernel(src, "int8_dq_kernel(", "  for (int j = 0; j < n_tiles; ++j) {",
                        "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    if (!live[h])",
                        B8_PHASES, 1)
    return src + ('\nextern "C" int qa_probe_cycles(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_cyc, sizeof(g_cyc));\n}\n'
                  'extern "C" int qa_probe_reset() {\n  void* p = nullptr;\n'
                  '  cudaGetSymbolAddress(&p, g_cyc);\n'
                  '  return (int)cudaMemset(p, 0, sizeof(g_cyc));\n}\n')


def _bwd_ops(gen, b, h, h_kv, t):
    dev = torch.device("cuda", 0)
    q, k, v, do = (torch.randn((b, n, t, 64), generator=gen, device=dev)
                   for n in (h, h_kv, h_kv, h))
    k_mean = k.mean(dim=-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    dims = (b, h, t, t, 64)
    o, lse = int8_attention_fwd_from_quantized(res, dims, causal=True)
    return int8_bwd_operands(res, k_mean, o, lse, do, dims, causal=True)


def _bwd_call(lib, ops, kernel):
    """One launch of B7 (kernel "dkv") or B8 ("dq") from an altered build, as
    ops/int8_bwd.py's wrappers launch it."""
    dev, ints, bq = tbwd._launch_args(ops)
    _, _, t, s, d = ops.dims
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "dkv":
        dk = torch.empty((ops.k_i8.shape[0], s, d), dtype=torch.float32, device=dev)
        dv = torch.empty_like(dk)
        status = lib.qa_int8_bwd_dkv(*tbwd._inputs(ops), dk.data_ptr(), dv.data_ptr(), *ints,
                                     int(ops.causal), ops.qk_scale, ops.sm_scale, stream)
    else:
        dq = torch.empty((ops.k_i8.shape[0], ops.rep, t, d), dtype=torch.float32, device=dev)
        status = lib.qa_int8_bwd_dq(*tbwd._inputs(ops), ops.k_mean.data_ptr(), dq.data_ptr(),
                                    *ints, bq, int(ops.causal), ops.qk_scale, ops.sm_scale, stream)
    if status:
        raise SystemExit(f"kernel_probe: launch failed with status {status}")


def probe_int8_bwd(smi) -> None:
    jobs = {name: _altered(edits, SRC_BWD) for name, edits in BWD_VARIANTS.items()}
    jobs["bwd_split"] = _bwd_split_source()
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, h_kv, t in BWD_SHAPES:
        ops = _bwd_ops(gen, b, h, h_kv, t)
        for kernel, name in (("dkv", "B7"), ("dq", "B8")):
            times = {v: _device_us(lambda v=v: _bwd_call(libs[v], ops, kernel)) for v in BWD_VARIANTS}
            print(f"[probe] {name} ({b},{h},{h_kv},{t},64) causal: "
                  + ", ".join(f"{v[4:]} {us:.2f}" for v, us in times.items()) + f" us ({smi})",
                  flush=True)
        lib = libs["bwd_split"]
        lib.qa_probe_reset()
        _bwd_call(lib, ops, "dkv")
        _bwd_call(lib, ops, "dq")
        torch.cuda.synchronize()
        cyc = np.zeros((2, 8192, 2, 9), dtype=np.int64)
        lib.qa_probe_cycles(ctypes.c_void_p(cyc.ctypes.data))
        for which, (name, phases) in enumerate((("B7", B7_PHASES), ("B8", B8_PHASES))):
            for wg in (0, 1):  # thread 0 (which issues the TMA) and thread 128
                c = cyc[which, :, wg]
                tiles = c[:, 8].sum()
                per = c[:, :8].sum(axis=0) / max(tiles, 1)
                print(f"[split] {name} ({b},{h},{h_kv},{t},64) causal, warpgroup {wg}, cycles "
                      f"per mainloop tile ({tiles} tiles): " + ", ".join(
                          f"{label} {x:.0f}" for (_, label, _), x in zip(phases, per))
                      + f"; all {per.sum():.0f}", flush=True)


# --- the bf16 flash forward (B1) ---

FWD_SHAPES = [(4, 16, 2048), (8, 16, 256), (4, 16, 8192)]  # (b, h = h_kv, t = s), causal
_FWD_EXP = ("      const __nv_bfloat162 pr = __floats2bfloat162_rn(exp2_ftz(s[4 * n + 2 * h] - next_m[h]),\n"
            "                                                      exp2_ftz(s[4 * n + 2 * h + 1] - next_m[h]));")
_FWD_PV = "    mma_pv(dv, p_prev);\n    wgmma_commit();\n    wgmma_wait<1>();"
FWD_VARIANTS = {
    "fwd_as_is": [],
    "fwd_stages_5": [("constexpr int KV_STAGES = 3;", "constexpr int KV_STAGES = 5;")],
    "fwd_no_exp": [(_FWD_EXP, _FWD_EXP.replace("exp2_ftz(", "("))],
    "fwd_no_softmax": [("    if (!live) {\n#pragma unroll", "    if (n_tiles < 0)\n    if (!live) {\n#pragma unroll")],
    "fwd_no_mask": [("    } else if (edge(j)) {", "    } else if (false) {")],
    "fwd_no_pv": [(_FWD_PV, "    wgmma_commit();\n    wgmma_wait<1>();")],
}
# (anchor, phase ended there, insert before the anchor?) in the mainloop's step
FWD_PHASES = [("    uint64_t dk = desc_k(jc);\n", "TMA wait", True),
              ("    wgmma_wait<1>();  // S of tile j is done\n", "issue S, PV", True),
              ("    float alpha[2] = {1.f, 1.f};\n", "wait S", True),
              ("    wgmma_wait<0>();\n    reg_fence(acc);\n    reg_fence(ls);\n    reg_fence(p_prev);",
               "softmax", True),
              ("    if (j > 0) release(j - 1);", "wait PV", True),
              ("  };\n\n  uint32_t p_a[8][4], p_b[8][4] = {};", "release, rescale", True)]


def _fwd_split_source() -> str:
    """B1 with clock64 sums by phase of the mainloop's step, per warpgroup."""
    src = open(SRC_FWD).read().replace('#include "hopper.cuh"\n', _SPLIT_HEAD)
    k0 = src.index("flash_fwd_kernel(const __grid_constant__")
    end = src.index("  // Epilogue: O = acc / l", k0)
    body = src[k0:end]
    for k, (anchor, _, before) in enumerate(FWD_PHASES):
        i = body.index(anchor)
        at = i if before else i + len(anchor)
        body = body[:at] + f"SPLIT({k})\n" + body[at:]
    i = body.index("  auto step = [&]")
    body = (body[:i] + "  if (threadIdx.x < 18) probe_cyc[threadIdx.x / 9][threadIdx.x % 9] = 0;\n"
            "  __syncthreads();\n  long long probe_t0 = clock64();\n" + body[i:])
    done = ("  if ((threadIdx.x & 127) == 0) {\n    const int w_ = threadIdx.x / 128;\n"
            "    const int b_ = blockIdx.y * gridDim.x + blockIdx.x;\n"
            "    for (int k_ = 0; k_ < 8; ++k_) g_cyc[0][b_][w_][k_] = probe_cyc[w_][k_];\n"
            "    g_cyc[0][b_][w_][8] = n_tiles;\n  }\n")
    src = src[:k0] + body + done + src[end:]
    return src + ('\nextern "C" int qa_probe_cycles(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_cyc, sizeof(g_cyc));\n}\n')


def _fwd_call(lib, q, k, v, o, lse):
    """One launch of B1 from an altered build, as ops/flash_fwd.py launches it
    on bf16 inputs."""
    b, h, t, _ = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    bq, _ = flash_tiling.grid(b * h_kv, h // h_kv, t)
    status = lib.qa_flash_fwd(q.data_ptr(), *tfwd._strides(q), 0, k.data_ptr(), *tfwd._strides(k),
                              v.data_ptr(), *tfwd._strides(v), o.data_ptr(), lse.data_ptr(), b,
                              h_kv, h // h_kv, t, s, bq, 1, 0.125 * 1.44269504,
                              torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: launch failed with status {status}")


def probe_flash_fwd(smi) -> None:
    jobs = {name: _altered(edits, SRC_FWD) for name, edits in FWD_VARIANTS.items()}
    jobs["fwd_split"] = _fwd_split_source()
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))
    print("\n".join(line for lib in libs.values() for line in lib.ptxas), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, t in FWD_SHAPES:
        q, k, v = (torch.randn((b, h, t, 64), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        o = torch.empty((b, h, t, 64), dtype=torch.float32, device="cuda")
        lse = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
        times = {v_: _device_us(lambda v_=v_: _fwd_call(libs[v_], q, k, v, o, lse))
                 for v_ in FWD_VARIANTS}
        print(f"[probe] B1 ({b},{h},{t},64) causal bf16: "
              + ", ".join(f"{v_[4:]} {us:.2f}" for v_, us in times.items()) + f" us ({smi})",
              flush=True)
        lib = libs["fwd_split"]
        _fwd_call(lib, q, k, v, o, lse)
        torch.cuda.synchronize()
        cyc = np.zeros((2, 8192, 2, 9), dtype=np.int64)
        lib.qa_probe_cycles(ctypes.c_void_p(cyc.ctypes.data))
        n_blocks = b * h * -(-t // flash_tiling.BLOCK_ROWS)
        for wg in (0, 1):  # thread 0 (which issues the TMA) and thread 128
            c = cyc[0, :n_blocks, wg]
            tiles = c[:, 8].sum()
            per = c[:, :8].sum(axis=0) / max(tiles, 1)
            print(f"[split] B1 ({b},{h},{t},64) causal, warpgroup {wg}, cycles per key tile "
                  f"({tiles} tiles): " + ", ".join(
                      f"{label} {x:.0f}" for (_, label, _), x in zip(FWD_PHASES, per))
                  + f"; all {per.sum():.0f}", flush=True)


# --- the bf16 flash backward's fast mode (B2, B3) ---

SRC_FBWD = os.path.join(_build.CSRC_DIR, "flash_bwd.cu")
FBWD_SHAPES = [(4, 16, 16, 2048), (2, 16, 4, 2048)]  # (b, h, h_kv, t = s), causal
_B2_EXP = "      p[e] = exp2_ftz(st[4 * n + e] - ((e & 1) ? l2.y : l2.x));"
_B3_EXP = "      float p = exp2_ftz(sc[4 * n + e] - lse_r[h]);"
_B2_COMPUTE = "    if (q0 + TILE > t || kw0 + 64 > s"
_B3_COMPUTE = "    if (k0 + TILE > s || (causal && k0 + TILE - 1 > q0))"
_B2_LATE = "    {  // dV += P^T dO"
_B3_LATE = "    {  // dQ += dS K"
FBWD_VARIANTS = {
    "fbwd_as_is": [],
    "fbwd_stages_6": [("constexpr int DKV_STAGES = 4;", "constexpr int DKV_STAGES = 6;"),
                      ("constexpr int DQ_STAGES = 4;", "constexpr int DQ_STAGES = 6;")],
    "fbwd_no_exp": [(_B2_EXP, _B2_EXP.replace("exp2_ftz(", "(")),
                    (_B3_EXP, _B3_EXP.replace("exp2_ftz(", "("))],
    "fbwd_no_elementwise": [(_B2_COMPUTE, _SKIP + _B2_COMPUTE), (_B3_COMPUTE, _SKIP + _B3_COMPUTE)],
    "fbwd_no_late_products": [(_B2_LATE, _SKIP + _B2_LATE), (_B3_LATE, _SKIP + _B3_LATE)],
}
# (anchor, phase ended there, insert before the anchor?) of each kernel's mainloop
_LOOP_END = "  }}\n  wgmma_wait<0>();\n  reg_fence({acc});"
B2_PHASES = [("    mbar_wait(full(st), (i / DKV_STAGES) & 1);\n", "TMA wait", False),
             ("    wgmma_wait<1>();\n", "issue S, dP", True),
             ("    if (i > 0) release_stage(", "wait last dV, dK", True),
             ("    wgmma_wait<0>();  // this tile's S^T", "release", True),
             ("    const float* rw = ", "wait S, dP", True),
             (_B2_LATE, "P, dS", True),
             (_LOOP_END.format(acc="dv_acc"), "issue dV, dK", True)]
B3_PHASES = [("    wgmma_wait<1>();\n", "issue S, dP", True),
             ("    if (j > 0) release(j - 1);", "wait last dQ", True),
             ("    wgmma_wait<0>();  // this tile's S and dP", "release", True),
             ("    // masking only where the tile reaches past s", "wait S, dP", True),
             ("    if (j + 1 < n_tiles) mbar_wait(", "dS", True),
             (_B3_LATE, "TMA wait (next tile)", True),
             (_LOOP_END.format(acc="dq_acc"), "issue dQ", True)]


def _fbwd_split_source() -> str:
    src = open(SRC_FBWD).read().replace('#include "hopper.cuh"\n', _SPLIT_HEAD)
    src = _split_kernel(src, "dkv_kernel_bf16(const", "  for (int i = 0; i < n_tiles; ++i) {",
                        "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    if (key[h] >= s)",
                        B2_PHASES, 0)
    src = _split_kernel(src, "dq_kernel_bf16(const", "  for (int j = 0; j < n_tiles; ++j) {",
                        "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    if (!live[h])",
                        B3_PHASES, 1)
    return src + ('\nextern "C" int qa_probe_cycles(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_cyc, sizeof(g_cyc));\n}\n'
                  'extern "C" int qa_probe_reset() {\n  void* p = nullptr;\n'
                  '  cudaGetSymbolAddress(&p, g_cyc);\n'
                  '  return (int)cudaMemset(p, 0, sizeof(g_cyc));\n}\n')


def _fbwd_call(lib, ops, kernel):
    """One fast launch of B2 (kernel "dkv") or B3 ("dq") from an altered
    build, as ops/flash_bwd.py's wrappers launch it."""
    from quantizedattention_tpu_torch.ops import flash_bwd as fbwd
    dev, bh_kv, rep, t, s, ld, bq = fbwd._launch_args(ops)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (ops.q, ops.k, ops.v, ops.do, ops.lse, ops.di)]
    if kernel == "dkv":
        dk = torch.empty((bh_kv, s, 64), dtype=torch.float32, device=dev)
        dv = torch.empty_like(dk)
        status = lib.qa_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), bh_kv, rep, t, s, ld,
                                      int(ops.causal), 1, 1.0 / ops.qk_scale, 1.0 / ops.sm_scale,
                                      stream)
    else:
        dq = torch.empty((bh_kv, rep, t, 64), dtype=torch.float32, device=dev)
        status = lib.qa_flash_bwd_dq(*ptrs, dq.data_ptr(), bh_kv, rep, t, s, ld, bq,
                                     int(ops.causal), 1, stream)
    if status:
        raise SystemExit(f"kernel_probe: launch failed with status {status}")


def probe_flash_bwd(smi) -> None:
    from quantizedattention_tpu_torch.ops import bwd_operands, flash_attention_fwd
    jobs = {name: _altered(edits, SRC_FBWD) for name, edits in FBWD_VARIANTS.items()}
    jobs["fbwd_split"] = _fbwd_split_source()
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))
    print("\n".join(line for lib in libs.values() for line in lib.ptxas), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, h_kv, t in FBWD_SHAPES:
        q, k, v, do = (torch.randn((b, n, t, 64), generator=gen, device="cuda")
                       for n in (h, h_kv, h_kv, h))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        ops = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True)
        for kernel, name in (("dkv", "B2"), ("dq", "B3")):
            times = {v_: _device_us(lambda v_=v_: _fbwd_call(libs[v_], ops, kernel))
                     for v_ in FBWD_VARIANTS}
            print(f"[probe] {name} ({b},{h},{h_kv},{t},64) causal: "
                  + ", ".join(f"{v_[5:]} {us:.2f}" for v_, us in times.items()) + f" us ({smi})",
                  flush=True)
        lib = libs["fbwd_split"]
        lib.qa_probe_reset()
        _fbwd_call(lib, ops, "dkv")
        _fbwd_call(lib, ops, "dq")
        torch.cuda.synchronize()
        cyc = np.zeros((2, 8192, 2, 9), dtype=np.int64)
        lib.qa_probe_cycles(ctypes.c_void_p(cyc.ctypes.data))
        for which, (name, phases) in enumerate((("B2", B2_PHASES), ("B3", B3_PHASES))):
            for wg in (0, 1):
                c = cyc[which, :, wg]
                tiles = c[:, 8].sum()
                per = c[:, :len(phases)].sum(axis=0) / max(tiles, 1)
                print(f"[split] {name} ({b},{h},{h_kv},{t},64) causal, warpgroup {wg}, cycles "
                      f"per mainloop tile ({tiles} tiles): " + ", ".join(
                          f"{label} {x:.0f}" for (_, label, _), x in zip(phases, per))
                      + f"; all {per.sum():.0f}", flush=True)


# --- B2/B3 exact mode against float64 (a witness, not a timing) ---

ONE_TOKEN = (1, 3, 1, 1, 1, True)  # chip_smoke.py BWD_EDGE_CASES[-1]


def _bwd_f64(ops):
    """(dq, dk, dv) of the exact backward on the kernels' operands `ops`,
    evaluated in float64 (the plain versions' formulas)."""
    q, k, v, do = (x.double() for x in (ops.q, ops.k[:, None], ops.v[:, None], ops.do))
    t, s = q.shape[2], k.shape[2]
    scores = q @ k.transpose(-1, -2)
    if ops.causal:
        visible = torch.ones((t, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(visible, scores, -30000.0)
    p = torch.exp2(scores - ops.lse.double()[..., None])
    ds = p * (do @ v.transpose(-1, -2) - ops.di.double()[..., None])
    return (ds @ k, (ds.transpose(-1, -2) @ q).sum(1) / ops.qk_scale,
            (p.transpose(-1, -2) @ do).sum(1) / ops.sm_scale)


def _bwd_exact_readings(q, k, v, do, causal, fast=False):
    """{tensor: (kernel vs plain, kernel vs f64, plain vs f64)}, each
    max|diff| / max|reference|, on B1's forward of (q, k, v)."""
    from quantizedattention_tpu_torch.ops import (bwd_operands, flash_attention_fwd, flash_bwd_dkv,
                                                  flash_bwd_dkv_plain, flash_bwd_dq,
                                                  flash_bwd_dq_plain)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ops = bwd_operands(q, k, v, o, lse, do, causal=causal, fast=fast)
    got = (flash_bwd_dq(ops), *flash_bwd_dkv(ops))
    plain = (flash_bwd_dq_plain(ops), *flash_bwd_dkv_plain(ops))
    exact = _bwd_f64(ops)
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()

    return {name: (rel(g, p), rel(g, e), rel(p, e))
            for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact)}


def _replayed_phase6_inputs(dev):
    """q, k, v, dO of phase 6's one-token case as phase 6 drew them when
    phase 3's edge cases took their inputs from the shared generator: every
    draw of phases 3, 4 and 6 before it, in order, from seed 0."""
    import chip_smoke as smoke
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, h, h_kv, t, s, _ in smoke.FLASH_CASES + smoke.FLASH_EDGE_CASES:
        for n, m in ((h, t), (h_kv, s), (h_kv, s)):
            torch.randn((b, n, m, 64), generator=gen, device=dev)
    for _ in range(3):
        torch.randn((smoke.N_SLOTS, 16, smoke.PROMPT_LEN, 64), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    smoke.phase_decode(dev, gen)
    cases = smoke.FLASH_CASES + smoke.BWD_EDGE_CASES
    assert cases[-1] == ONE_TOKEN
    for b, h, h_kv, t, s, _ in cases:
        qkvdo = smoke._qkvdo(gen, dev, b, h, h_kv, t, s)
    return qkvdo


def _fmt(readings):
    return "; ".join(f"{n} {a:.3e} / {b:.3e} / {c:.3e}" for n, (a, b, c) in readings.items())


def probe_bwd_exact(smi) -> None:
    dev = torch.device("cuda", 0)
    b, h, h_kv, t, s, causal = ONE_TOKEN
    print(f"[bwd_exact] (1,3q/1kv,1,64) causal, kernel vs plain / kernel vs f64 / plain vs f64, "
          f"each max|diff| / max|reference| (phase 6's gate: kernel vs plain <= 1e-4 exact, "
          f"<= 1e-2 fast) ({smi})", flush=True)
    readings = _bwd_exact_readings(*_replayed_phase6_inputs(dev), causal)
    print(f"[bwd_exact] phase 6's inputs with phase 3's edge cases on the shared generator: "
          f"{_fmt(readings)}", flush=True)
    for mode, fast, gate in (("exact", False, 1e-4), ("fast", True, 1e-2)):
        worst, over, half = {}, 0, 0
        for seed in range(256):
            gen = torch.Generator(device=dev).manual_seed(1000 + seed)
            qkvdo = [torch.randn((b, n, m, 64), generator=gen, device=dev)
                     for n, m in ((h, t), (h_kv, s), (h_kv, s), (h, t))]
            r = _bwd_exact_readings(*qkvdo, causal, fast)
            top = max(a for a, _, _ in r.values())
            over += top > gate
            half += top > gate / 2
            worst = {n: tuple(max(x, y) for x, y in zip(r[n], worst.get(n, (0.0,) * 3)))
                     for n in r}
        print(f"[bwd_exact] {mode} mode, 256 seeds: kernel vs plain over {gate:g} on {over}, over "
              f"half of it on {half}; worst {_fmt(worst)}", flush=True)


FP32_CASE = (1, 3, 300)  # (b, h = h_kv, t = s), head_dim 64
FP32_SEEDS = 256
JVP_SHAPES = [(4, 4, 4096), (4, 16, 4096)]  # (b, h, t = s), non-causal: the DiT's, bench_jvp's
# B1 fp32's knock-outs (each computes wrong results on purpose)
_F32_S_SMALL = ("""    wgmma_tf32_m64n64k8_rs_zero(sacc, qa[0], desc_f32(stage + 2 * F_BLK, 0));  // Q big . K small
#pragma unroll
    for (int kk = 1; kk < D / 8; ++kk)
      wgmma_tf32_m64n64k8_rs(sacc, qa[kk], desc_f32(stage + 2 * F_BLK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q small . K big
      wgmma_tf32_m64n64k8_ss(sacc, desc_f32(qs_base, kk), desc_f32(stage, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q big . K big
      wgmma_tf32_m64n64k8_rs(sacc, qa[kk], desc_f32(stage, kk), 1);
""", """    wgmma_tf32_m64n64k8_rs_zero(sacc, qa[0], desc_f32(stage, 0));
#pragma unroll
    for (int kk = 1; kk < D / 8; ++kk)
      wgmma_tf32_m64n64k8_rs(sacc, qa[kk], desc_f32(stage, kk), 1);
""")
_F32_PV_SMALL = """#pragma unroll
    for (int kk = 0; kk < F_KEYS / 8; ++kk)  // P small . V big
      wgmma_tf32_m64n64k8_rs(oacc, ps[kk], desc_f32(stage + 4 * F_BLK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 8; ++kk)  // P big . V small
      wgmma_tf32_m64n64k8_rs(oacc, pb[kk], desc_f32(stage + 6 * F_BLK, kk), 1);
"""
_F32_PV_BIG = """#pragma unroll
    for (int kk = 0; kk < F_KEYS / 8; ++kk)  // P big . V big
      wgmma_tf32_m64n64k8_rs(oacc, pb[kk], desc_f32(stage + 4 * F_BLK, kk), 1);
"""
_F32_SOFTMAX = "    if (edge(j))\n      softmax_tf32<true>"
# warpgroup turns: each warpgroup issues its products only after the other
# issued its last ones (bar.sync on its own barrier, bar.arrive on the
# other's), so one's elementwise work could run under the other's products
_ARRIVE = ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n'
           "__device__ __forceinline__ void named_barrier_arrive(int id, int count) {\n"
           '  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(count) : "memory");\n}\n')


def _turns(first):
    """The turn lambdas on barriers first, first + 1 (warpgroup 0's, 1's)."""
    return (f"  auto take_turn = [&]() {{ named_barrier({first} + wg, 256); }};\n"
            f"  auto pass_turn = [&]() {{ named_barrier_arrive({first + 1} - wg, 256); }};\n")


_F32_TURNS = [
    _ARRIVE,
    ("  mbar_wait(full(0), 0);\n  reg_fence(sacc);\n  wgmma_fence();\n  issue_s(stage_of(0));\n",
     _turns(3) + "  if (wg == 1) pass_turn();\n  mbar_wait(full(0), 0);\n  reg_fence(sacc);\n"
     "  take_turn();\n  wgmma_fence();\n  issue_s(stage_of(0));\n  pass_turn();\n"),
    ("    reg_fence(ps);\n    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < F_KEYS / 8;",
     "    reg_fence(ps);\n    take_turn();\n    wgmma_fence();\n#pragma unroll\n"
     "    for (int kk = 0; kk < F_KEYS / 8;"),
    ("    issue_s(stage_of(jn));\n    wgmma_wait<0>();\n",
     "    issue_s(stage_of(jn));\n    if (wg == 0 || j + 1 < n_tiles) pass_turn();\n"
     "    wgmma_wait<0>();\n"),
]
F32_VARIANTS = {
    "f32v_as_is": [],
    "f32v_1xtf32": [_F32_S_SMALL, (_F32_PV_SMALL, "")],
    "f32v_no_exp": [("const float p = MASK && !visible(i) ? 0.f : exp2f(s[i] - m[h]);",
                     "const float p = MASK && !visible(i) ? 0.f : (s[i] - m[h]);")],
    "f32v_no_softmax": [(_F32_SOFTMAX, _SKIP + _F32_SOFTMAX)],
    "f32v_no_pv": [(_F32_PV_SMALL + _F32_PV_BIG, "")],
    "f32v_turns": _F32_TURNS,
}
# B11 fast's knock-outs
_DKV_TERMS = "    if (q0 + JD_ROWS > t || kw0 + 64 > s || (causal && q0 < kw0 + 63))\n      dkv_terms<true>"
DKV_VARIANTS = {
    "dkvv_as_is": [],
    "dkvv_no_exp": [("float pe = exp2_ftz(st[i] * qk_scale - (odd ? lse2.y : lse2.x));",
                     "float pe = (st[i] * qk_scale - (odd ? lse2.y : lse2.x));")],
    "dkvv_no_elementwise": [(_DKV_TERMS, _SKIP + _DKV_TERMS)],
    "dkvv_no_second": [],  # the second products cut out: _dkv_source
    "dkvv_turns": [
        _ARRIVE,
        ("  if (n_tiles > 0) mbar_wait(kv_bar, 0);\n",
         _turns(1) + "  if (n_tiles > 0) mbar_wait(kv_bar, 0);\n"
         "  if (n_tiles > 0 && wg == 1) pass_turn();\n"),
        ("    mbar_wait(full(st), (i / JD_STAGES) & 1);\n",
         "    mbar_wait(full(st), (i / JD_STAGES) & 1);\n    if (i == 0) take_turn();\n"),
        ("      wgmma_commit();\n    }\n    // the last tile's second products are done",
         "      wgmma_commit();\n    }\n    pass_turn();\n"
         "    // the last tile's second products are done"),
        ("      const uint64_t ddto = desc_mnmajor_sw128(tiles + 3 * JD_TILE);\n      wgmma_fence();\n",
         "      const uint64_t ddto = desc_mnmajor_sw128(tiles + 3 * JD_TILE);\n      take_turn();\n"
         "      wgmma_fence();\n"),
        ("  wgmma_wait<0>();\n  reg_fence(dk_acc);\n",
         "  if (n_tiles > 0 && wg == 0) pass_turn();\n  wgmma_wait<0>();\n  reg_fence(dk_acc);\n"),
    ],
}
_DKV_SECOND = ("#pragma unroll\n      for (int kk = 0; kk < JD_ROWS / 16; ++kk) {  // dV += p^T dO",
               "      wgmma_commit();\n    }\n  }\n  wgmma_wait<0>();\n  reg_fence(dk_acc);")


def _dkv_source(name) -> str:
    """jvp.cu with B11 fast's knock-out `name`."""
    src = _altered(DKV_VARIANTS[name], SRC_JVP)
    if name == "dkvv_no_second":
        a, b = src.index(_DKV_SECOND[0]), src.index(_DKV_SECOND[1])
        src = src[:a] + src[b:]
    return src


def _fp32_f64(q, k, v, causal, qk_scale):
    """B1 fp32's function in float64 on the same inputs, q scaled by qk_scale
    in f32 first (as both designs scale it): (O, lse)."""
    t, s = q.shape[2], k.shape[2]
    scores = (q * qk_scale).double() @ k.double().transpose(-1, -2)
    mask = tile_mask(0, 0, t, s, s, causal, device=q.device)
    scores = torch.where(mask, scores, MASK_VALUE)
    m = scores.amax(-1, keepdim=True) + EPS_BIAS
    p = torch.where(mask, torch.exp2(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return (p @ v.double()) / l, (m + torch.log2(l))[..., 0]


def _ffma_fp32(lib, q, k, v, causal, qk_scale):
    """The FFMA design's fp32 kernel (a parent checkout's csrc/flash_fwd.cu),
    launched as its wrapper launched it: q pre-scaled in f32, all contiguous."""
    b, h, t, d = q.shape
    qs = (q * qk_scale).contiguous()
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    status = lib.qa_flash_fwd_f32(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), b * h, 1, t, k.shape[2], int(causal),
                                  torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: the FFMA fp32 launch failed with status {status}")
    return o, lse


def _f32_call(lib, q, prep, o, lse):
    """One launch of B1 fp32 from an altered build on the K/V prep's outputs."""
    b, h, t, _ = q.shape
    s = prep[0].shape[1]
    status = lib.qa_flash_fwd_f32(q.data_ptr(), *tfwd._strides(q), *(x.data_ptr() for x in prep),
                                  o.data_ptr(), lse.data_ptr(), b, h, h, t, s, 0, 0.125 * LOG2_E,
                                  torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: launch failed with status {status}")


def probe_fwd_fp32(smi, parent=None) -> None:
    """B1 fp32 against float64 over FP32_SEEDS seeds at FP32_CASE, causal and
    not: this checkout's kernel (3xTF32) and, given a parent checkout, its
    FFMA kernel, on the same inputs; then the kernel's knock-outs timed."""
    designs = {"3xTF32": lambda q, k, v, c: tfwd.flash_attention_fwd_fp32(q, k, v, causal=c)}
    if parent:
        csrc = os.path.join(parent, "quantizedattention_tpu_torch", "csrc")
        with open(os.path.join(csrc, "flash_fwd.cu")) as f:
            lib = _build_lib("ffma_parent", f.read(), csrc)
        designs["FFMA"] = lambda q, k, v, c: _ffma_fp32(lib, q, k, v, c, 0.125 * LOG2_E)
    b, h, t = FP32_CASE
    for causal in (False, True):
        worst = {name: [0.0, 0.0] for name in designs}
        for seed in range(FP32_SEEDS):
            gen = torch.Generator(device="cuda").manual_seed(2000 + seed)
            q, k, v = (torch.randn((b, h, t, 64), generator=gen, device="cuda") for _ in range(3))
            o64, lse64 = _fp32_f64(q, k, v, causal, 0.125 * LOG2_E)
            for name, fn in designs.items():
                o, lse = fn(q, k, v, causal)
                torch.cuda.synchronize()
                worst[name][0] = max(worst[name][0],
                                     ((o.double() - o64).abs().max() / o64.abs().max()).item())
                worst[name][1] = max(worst[name][1], (lse.double() - lse64).abs().max().item())
        ratio = ""
        if "FFMA" in worst:
            ratio = (f"; 3xTF32 / FFMA: O {worst['3xTF32'][0] / worst['FFMA'][0]:.2f}x, lse "
                     f"{worst['3xTF32'][1] / worst['FFMA'][1]:.2f}x (the design's gate: 4x)")
        print(f"[fwd_fp32] ({b},{h},{t},64) causal={causal}, {FP32_SEEDS} seeds, worst against "
              "float64, max|dO| / max|O| and max|dlse|: "
              + "; ".join(f"{n} {o_:.3e}, {l_:.3e}" for n, (o_, l_) in worst.items())
              + ratio + f" ({smi})", flush=True)
    jobs = {name: _altered(edits, SRC_FWD) for name, edits in F32_VARIANTS.items()}
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))
    print("\n".join(line for lib in libs.values() for line in lib.ptxas if "f32_kernel" in line
                    or "registers" in line), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, t in JVP_SHAPES:
        q, k, v = (torch.randn((b, h, t, 64), generator=gen, device="cuda") for _ in range(3))
        prep = tfwd.kv_split_tf32(k, v)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
        times = {v_: _device_us(lambda v_=v_: _f32_call(libs[v_], q, prep, o, lse), 2, 5)
                 for v_ in F32_VARIANTS}
        print(f"[probe] B1 fp32 kernel ({b},{h},{t},64): "
              + ", ".join(f"{v_[5:]} {us:.1f}" for v_, us in times.items()) + f" us ({smi})",
              flush=True)


def _dkv_call(lib, prep, outs, causal=False):
    """One launch of B11 fast from an altered build on the prep's outputs."""
    ops8, rows = prep
    bh, t, _ = ops8[0].shape
    s = ops8[1].shape[1]
    status = lib.qa_jvp_bwd_dkv_bf16(*(x.data_ptr() for x in ops8), rows.data_ptr(),
                                     *(x.data_ptr() for x in outs), bh, t, s, rows.stride(1),
                                     int(causal), 0.125, 0.125 * LOG2_E,
                                     torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: launch failed with status {status}")


def probe_jvp_bwd(smi) -> None:
    """B11 fast's knock-outs timed beside the unaltered build, on the prep's
    outputs at the DiT's and bench_jvp's shapes."""
    from quantizedattention_tpu_torch.ops import attention_jvp_fwd, jvp_bwd_operands, jvp_bwd_prep

    jobs = {name: _dkv_source(name) for name in DKV_VARIANTS}
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))
    print("\n".join(line for lib in libs.values() for line in lib.ptxas if "dkv_wgmma" in line),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, t in JVP_SHAPES:
        q, k, v, tq, tk, tv, do, dto = (torch.randn((b, h, t, 64), generator=gen, device="cuda")
                                        for _ in range(8))
        fwd = attention_jvp_fwd(q, k, v, tq, tk, tv, fast=True)
        prep = jvp_bwd_prep(jvp_bwd_operands(q, k, v, tq, tk, tv, *fwd, do, dto, fast=True))
        outs = [torch.empty((b * h, t, 64), dtype=torch.float32, device="cuda") for _ in range(4)]
        times = {v_: _device_us(lambda v_=v_: _dkv_call(libs[v_], prep, outs), 2, 5)
                 for v_ in DKV_VARIANTS}
        print(f"[probe] B11 fast kernel ({b},{h},{t},64): "
              + ", ".join(f"{v_[5:]} {us:.1f}" for v_, us in times.items()) + f" us ({smi})",
              flush=True)


# B9 fast's and B12 fast's knock-outs (each computes wrong results on purpose)
B9_VARIANTS = {
    "b9v_as_is": [],
    "b9v_no_exp": [("p[e] = MASK && !visible(i) ? 0.f : exp2_ftz(sc[i] - m[h]);",
                    "p[e] = MASK && !visible(i) ? 0.f : (sc[i] - m[h]);")],
    "b9v_no_elementwise": [("    if (edge(j))\n      fwd_terms<true>",
                            _SKIP + "    if (edge(j))\n      fwd_terms<true>")],
    "b9v_no_second": [("    issue_out(stage(j));\n", "")],
    "b9v_keys32": [("constexpr int JF_KEYS = 64;", "constexpr int JF_KEYS = 32;")],
}
_DQ_TERMS = "    if (k0 + JQ_KEYS > s || (causal && k0 + JQ_KEYS - 1 > qw0))\n      dq_terms<true>"
B12_VARIANTS = {
    "b12v_as_is": [],
    "b12v_no_exp": [("float p = exp2_ftz(sc[i] * qk_scale - lse[h]);",
                     "float p = (sc[i] * qk_scale - lse[h]);")],
    "b12v_no_elementwise": [(_DQ_TERMS, _SKIP + _DQ_TERMS)],
    "b12v_no_second": [],  # the second products cut out: _b12_source
    "b12v_keys64": [("constexpr int JQ_KEYS = 32;", "constexpr int JQ_KEYS = 64;")],
}
_DQ_SECOND = ("#pragma unroll\n      for (int kk = 0; kk < JQ_KEYS / 16; ++kk) {\n"
              "        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dq_acc",
              "      wgmma_commit();\n    }\n  }\n  wgmma_wait<0>();\n  reg_fence(dq_acc);")


def _variant_source(variants, name) -> str:
    """jvp.cu with the knock-out `name` of `variants` (B9_VARIANTS or
    B12_VARIANTS)."""
    src = _altered(variants[name], SRC_JVP)
    if name == "b12v_no_second":
        a, b = src.index(_DQ_SECOND[0]), src.index(_DQ_SECOND[1])
        src = src[:a] + src[b:]
    return src


def _kernel_ptxas(lib, kernel) -> list:
    """The registers and spill lines ptxas printed for `kernel` in a build."""
    lines, inside = [], False
    for line in lib.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("registers" in line or "spill" in line) or "C75" in line:
            lines.append(line.split(" in function")[0].strip())
    return lines


def _variant_libs(variants):
    jobs = {name: _variant_source(variants, name) for name in variants}
    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))


def probe_jvp_fwd(smi) -> None:
    """B9 fast's knock-outs timed beside the unaltered build, the kernel
    alone on its prep's outputs, at the DiT's and bench_jvp's shapes."""
    from quantizedattention_tpu_torch.ops import jvp_fwd_prep

    libs = _variant_libs(B9_VARIANTS)
    for name, lib in libs.items():
        print(f"[ptxas] {name} jvp_fwd_wgmma: " + "; ".join(_kernel_ptxas(lib, "jvp_fwd_wgmma")),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, t in JVP_SHAPES:
        q, k, v, tq, tk, tv = (torch.randn((b, t, h, 64), generator=gen, device="cuda")
                               .transpose(1, 2) for _ in range(6))
        kv = jvp_fwd_prep(k, v, tk, tv)
        o, to = (torch.empty((b, h, t, 64), device="cuda") for _ in range(2))
        lse, mu = (torch.empty((b, h, t), device="cuda") for _ in range(2))

        def call(lib):
            status = lib.qa_jvp_fwd_bf16(
                q.data_ptr(), *tfwd._strides(q), tq.data_ptr(), *tfwd._strides(tq),
                *(x.data_ptr() for x in kv), o.data_ptr(), to.data_ptr(), lse.data_ptr(),
                mu.data_ptr(), b, h, t, t, 0, 0.125, 0.125 * LOG2_E,
                torch.cuda.current_stream().cuda_stream)
            if status:
                raise SystemExit(f"kernel_probe: launch failed with status {status}")

        times = {v_: _device_us(lambda v_=v_: call(libs[v_]), 2, 5) for v_ in B9_VARIANTS}
        print(f"[probe] B9 fast kernel ({b},{h},{t},64): "
              + ", ".join(f"{v_[4:]} {us:.1f}" for v_, us in times.items()) + f" us ({smi})",
              flush=True)


def probe_jvp_dq(smi) -> None:
    """B12 fast's knock-outs timed beside the unaltered build, the kernel
    alone on the shared prep's outputs, at the DiT's and bench_jvp's
    shapes."""
    from quantizedattention_tpu_torch.ops import attention_jvp_fwd, jvp_bwd_operands, jvp_bwd_prep

    libs = _variant_libs(B12_VARIANTS)
    for name, lib in libs.items():
        print(f"[ptxas] {name} jvp_dq_wgmma: " + "; ".join(_kernel_ptxas(lib, "jvp_dq_wgmma")),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, t in JVP_SHAPES:
        q, k, v, tq, tk, tv, do, dto = (torch.randn((b, h, t, 64), generator=gen, device="cuda")
                                        for _ in range(8))
        fwd = attention_jvp_fwd(q, k, v, tq, tk, tv, fast=True)
        ops8, rows = jvp_bwd_prep(jvp_bwd_operands(q, k, v, tq, tk, tv, *fwd, do, dto, fast=True))
        dq, dtq = (torch.empty((b * h, t, 64), device="cuda") for _ in range(2))

        def call(lib):
            status = lib.qa_jvp_bwd_dq_bf16(
                *(x.data_ptr() for x in ops8), rows.data_ptr(), dq.data_ptr(), dtq.data_ptr(),
                b * h, t, t, rows.stride(1), 0, 0.125, 0.125 * LOG2_E,
                torch.cuda.current_stream().cuda_stream)
            if status:
                raise SystemExit(f"kernel_probe: launch failed with status {status}")

        times = {v_: _device_us(lambda v_=v_: call(libs[v_]), 2, 5) for v_ in B12_VARIANTS}
        print(f"[probe] B12 fast kernel ({b},{h},{t},64): "
              + ", ".join(f"{v_[5:]} {us:.1f}" for v_, us in times.items()) + f" us ({smi})",
              flush=True)


# --- the decode kernels (B13-B16, one body in csrc/cache_decode.cu) ---

SRC_CACHE = os.path.join(_build.CSRC_DIR, "cache_decode.cu")
# (label, kv heads of 16 q heads, length of 1280, spec), 8 sequences: the
# serving decode, its verify pass, the capacity at 16/16 and at 16/4 heads
D4_SHAPES = [("serve", 16, 304, 1), ("verify", 16, 304, 5), ("capacity", 16, 1280, 1),
             ("capacity gqa", 4, 1280, 1)]
D4_CAP = 1280
_D4_NO_MERGE = ("  {  // the last block of the (kv head, sequence) merges",
                "  if (false) {  // the last block of the (kv head, sequence) merges")
_D4_LOADS_ONLY = ("    const int n_tiles = min(max((len - t0 + TILE - 1) / TILE, 0), TILES);",
                  "    const int n_tiles = 0;")
_D4_ONE_CHUNK = ("  const int n_live = max(1, (len + CH - 1) / CH);", "  const int n_live = 1;")
# the merge by a second launch, for d4_merge_launch: no_merge's kernel, then this
_D4_MERGE_LAUNCH = """
namespace {
__global__ void __launch_bounds__(THREADS)
probe_merge_kernel(Partials part, const int* __restrict__ length, int capacity,
                   float* __restrict__ o, float* __restrict__ lse, int n_kv, int rows, int spec) {
  const size_t pair = static_cast<size_t>(blockIdx.y) * n_kv + blockIdx.x;
  const int len = min(max(length[blockIdx.y], 0), capacity);
  merge_rows<CHUNK4>(part, pair * part.n_chunks, pair * rows, len, rows, spec, o, lse);
}
}  // namespace

extern "C" int qa_probe_merge(void* part_acc, void* part_ml, const void* length, int capacity,
                              void* o, void* lse, int n_seqs, int n_kv, int rows, int spec,
                              void* stream) {
  const Partials part{static_cast<float*>(part_acc), static_cast<float*>(part_ml), nullptr,
                      (capacity + CHUNK4 - 1) / CHUNK4};
  probe_merge_kernel<<<dim3(n_kv, n_seqs), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      part, static_cast<const int*>(length), capacity, static_cast<float*>(o),
      static_cast<float*>(lse), n_kv, rows, spec);
  return static_cast<int>(cudaGetLastError());
}
"""
D4_VARIANTS = {
    "d4_as_is": [],
    "d4_no_merge": [_D4_NO_MERGE],
    "d4_merge_launch": [_D4_NO_MERGE],  # + _D4_MERGE_LAUNCH
    "d4_no_unpack": [
        ("              mma_bf16(s[n], qa[ks], signed_nibbles_to_bf16x2(y), "
         "signed_nibbles_to_bf16x2(y >> 8));",
         "              mma_bf16(s[n], qa[ks], y, y >> 8);"),
        ("              mma_bf16(acc[n], pa[kk], signed_nibble_pair(vw[kk][0][n / 4], "
         "vw[kk][1][n / 4], n % 4),\n                       signed_nibble_pair(vw[kk][2][n / 4], "
         "vw[kk][3][n / 4], n % 4));",
         "              mma_bf16(acc[n], pa[kk], vw[kk][0][n / 4], vw[kk][2][n / 4]);")],
    "d4_loads_only": [_D4_NO_MERGE, _D4_LOADS_ONLY],
    "d4_one_chunk": [_D4_NO_MERGE, _D4_ONE_CHUNK],
    "d4_ex2_approx": [("exp2f(s[n][2 * h + e] - m[h])", "exp2_ftz(s[n][2 * h + e] - m[h])")],
    "d4_empty": [("  Smem<PACKED, CH>& sm = *reinterpret_cast<Smem<PACKED, CH>*>(smem_raw);\n",
                  "  Smem<PACKED, CH>& sm = *reinterpret_cast<Smem<PACKED, CH>*>(smem_raw);\n"
                  "  if (rows > 0) return;\n")],
}
# the int8 instance (B13): knock-outs, and 128- against 256-token chunks
D8_VARIANTS = {
    "d8_as_is": [],
    "d8_no_merge": [_D4_NO_MERGE],
    "d8_no_widen": [
        ("              const uint2 b = widen4(kw[n][ks]);",
         "              const uint2 b = make_uint2(kw[n][ks], kw[n][ks] >> 8);"),
        ("              mma_bf16(acc[n], pa[kk], widen_pair(vw[kk][0][n / 4], vw[kk][1][n / 4], "
         "n % 4),\n                       widen_pair(vw[kk][2][n / 4], vw[kk][3][n / 4], n % 4));",
         "              mma_bf16(acc[n], pa[kk], vw[kk][0][n / 4], vw[kk][2][n / 4]);")],
    "d8_loads_only": [_D4_NO_MERGE, _D4_LOADS_ONLY],
    "d8_one_chunk": [_D4_NO_MERGE, _D4_ONE_CHUNK],
    "d8_chunk128": [("constexpr int CHUNK8 = 256;", "constexpr int CHUNK8 = 128;")],
}
D4_STAMPS = ["start", "length read", "staged", "S", "max exchanged", "PV", "warps' sums shared",
             "partials written", "arrived", "end"]  # a block's last chunk (and m-tile) from "staged"
# the instance's mangled name: decode_kernel<PACKED, CH>
INSTANCE = {4: "decode_kernelILb1E", 8: "decode_kernelILb0E"}


def _d4_stamped() -> str:
    """cache_decode.cu with a %globaltimer stamp at D4_STAMPS of every block
    of either instance (thread 0, warp 0: tile 0; the last m-tile's)."""
    src = open(SRC_CACHE).read().replace(
        '#include "hopper.cuh"',
        '#include "hopper.cuh"\n__device__ unsigned long long g_t[8192][16];\n'
        '#define STAMP(i) if (threadIdx.x == 0) { unsigned long long t_; '
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
        'g_t[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)][i] = t_; }')
    k0 = src.index("decode_kernel(const")
    for i, (anchor, after) in enumerate((
            ("  const size_t pair = static_cast<size_t>(seq) * n_kv + kvh;\n", True),
            ("    cp_async_wait<0>();\n    return;\n  }\n", True),
            ("      cp_async_wait<0>();\n    }\n    __syncthreads();\n", True),
            ("      if (j == 0) {\n        sm.red_max[warp][g] = mx[0];", False),
            ("      // the online softmax's m after tile 0", False),
            ("      // the warps' acc and l of the live rows", False),
            ("      // tile 0's sums (its warps in order)", False),
            ("  {  // the last block of the (kv head, sequence) merges", False),
            ("    if (sm.merges) merge_rows", False),
            ("spec, o, lse);\n  }\n", True))):
        at = src.index(anchor, k0) + (len(anchor) if after else 0)
        src = src[:at] + f"STAMP({i})\n" + src[at:]
    return src + ('\nextern "C" int qa_probe_stamps(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_t, sizeof(g_t));\n}\n'
                  'extern "C" int qa_probe_reset() {\n  static unsigned long long z[8192][16];\n'
                  '  return (int)cudaMemcpyToSymbol(g_t, z, sizeof(g_t));\n}\n')


def _d4_case(gen, n_kv, length, spec, bits=4):
    """q [8, 16 * spec, 64] f32, a slotted cache of random bytes and scales
    (int4 or int8) at capacity D4_CAP, all rows at `length`, its paged twin
    (pages of 128 shuffled across the pool), and the partials (room for
    128-token chunks)."""
    from quantizedattention_tpu_torch import parallel as P

    n, dev = 8, "cuda"
    per_page = 64 if bits == 4 else 128
    q = torch.randn((n, 16 * spec, 64), generator=gen, device=dev)
    k, v = (torch.randint(-128, 128, (n, n_kv, D4_CAP * per_page // 128, 64), generator=gen,
                          device=dev, dtype=torch.int8) for _ in range(2))
    scale = 0.28 if bits == 4 else 0.028
    sk, sv = (torch.rand((n, n_kv, D4_CAP), generator=gen, device=dev) * scale + scale / 14
              for _ in range(2))
    lengths = torch.full((n,), length, dtype=torch.int32, device=dev)
    slotted = (P.Int4KVCache if bits == 4 else P.QuantizedKVCache)(k, sk, v, sv, lengths)
    ps, max_pages = 128, D4_CAP // 128
    perm = torch.randperm(n * max_pages, generator=torch.Generator().manual_seed(0)) + 1
    table = perm.reshape(n, max_pages).int().to(dev)
    pay = [torch.zeros((n_kv, 1 + n * max_pages, per_page, 64), dtype=torch.int8, device=dev)
           for _ in range(2)]
    scales = [torch.zeros((1 + n * max_pages, n_kv, ps), device=dev) for _ in range(2)]
    for x, p in zip((k, v), pay):  # any bytes do: the twin is timed, not compared
        p[:, table.flatten().long()] = x.reshape(n, n_kv, max_pages, per_page, 64).transpose(
            0, 1).reshape(n_kv, n * max_pages, per_page, 64)
    for x, sc in zip((sk, sv), scales):
        sc[table.flatten().long()] = x.reshape(n, n_kv, max_pages, ps).transpose(1, 2).reshape(
            n * max_pages, n_kv, ps)
    paged = (P.Paged4KVCache if bits == 4 else P.PagedKVCache)(pay[0], scales[0], pay[1],
                                                                scales[1], table, lengths)
    rows = 16 * spec // n_kv
    acc, ml = (torch.empty(shape, device=dev)
               for shape in ((n, n_kv, D4_CAP // 128, rows, 64), (n, n_kv, D4_CAP // 128, rows, 2)))
    o = torch.empty((n, 16 * spec, 64), device=dev)
    lse = torch.empty((n, 16 * spec), device=dev)
    return q, slotted, paged, (acc, ml, o, lse)


def _d4_call(lib, q, cache, outs, arrived, n_kv, spec, paged=False, bits=4, chunk=256):
    """One launch of the slotted or paged entry of `lib` for `bits`, its z
    from decode_tiling.grid's rule for `chunk`-token chunks."""
    from quantizedattention_tpu_torch.parallel import decode_tiling as dt

    acc, ml, o, lse = outs
    group = 16 // n_kv
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_z = min(-(-D4_CAP // chunk), max(1, dt.RESIDENT * sms // (8 * n_kv)))
    args = [q.data_ptr(), *(x.data_ptr() for x in cache), o.data_ptr(), lse.data_ptr(),
            acc.data_ptr(), ml.data_ptr(), arrived, int(q.dtype == torch.float32)]
    stream = torch.cuda.current_stream().cuda_stream
    if paged:
        entry = lib.qa_paged4_decode if bits == 4 else lib.qa_paged_decode
        status = entry(*args, 8, n_kv, group, spec, cache[0].shape[1], 128,
                       cache.page_table.shape[1], grid_z, 0.125 * LOG2_E, stream)
    else:
        entry = lib.qa_decode4 if bits == 4 else lib.qa_decode
        status = entry(*args, 8, n_kv, group, spec, D4_CAP, grid_z, 0.125 * LOG2_E, stream)
    if status:
        raise SystemExit(f"kernel_probe: launch failed with status {status}")


def _d4_split(lib, label, qb, cache, outs, arrived, n_kv, spec, bits) -> str:
    """The stamped copy's phases, medians over the blocks that run."""
    _d4_call(lib, qb, cache, outs, arrived, n_kv, spec, bits=bits)
    torch.cuda.synchronize()
    lib.qa_probe_reset()
    _d4_call(lib, qb, cache, outs, arrived, n_kv, spec, bits=bits)
    torch.cuda.synchronize()
    stamps = np.zeros((8192, 16), dtype=np.uint64)
    lib.qa_probe_stamps(ctypes.c_void_p(stamps.ctypes.data))
    t = stamps[:n_kv * 8 * D4_CAP // 256, :len(D4_STAMPS)].astype(np.int64)
    live = t[:, 1] > 0
    first = t[:, 0][t[:, 0] > 0].min()
    phases = np.diff(t[live], axis=1) / 1e3
    return (f"{int(live.sum())} of {len(t)} blocks run; "
            + ", ".join(f"{a} -> {b} {np.median(phases[:, i]):.2f}"
                        for i, (a, b) in enumerate(zip(D4_STAMPS, D4_STAMPS[1:])))
            + f" us (medians over the blocks that run); block starts over "
            f"{(t[live, 0].max() - first) / 1e3:.2f} us; first start to last end "
            f"{(t[live, -1].max() - first) / 1e3:.2f} us")


def _d4_libs(variants, extra):
    """Build every variant (`extra`: name -> source, in place of a variant's
    edits or beside them) in parallel; print each build's registers and
    spills for the instance probed."""
    jobs = {name: _altered(edits, SRC_CACHE) for name, edits in variants.items()
            if name not in extra}
    jobs.update(extra)
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))
    bits = 4 if next(iter(variants)).startswith("d4") else 8
    for name, lib in libs.items():
        print(f"[ptxas] {name} decode_kernel<int{bits}>: "
              + "; ".join(_kernel_ptxas(lib, INSTANCE[bits])), flush=True)
        if lib.qa_decode_init():
            raise SystemExit(f"kernel_probe: {name}'s shared-memory attribute was refused")
    return libs


def probe_decode4(smi) -> None:
    """B15's knock-outs (on bf16 q), B15 on f32 q (rounded in the kernel),
    the merge by a second launch, B16, the q cast and the whole wrapper
    call, timed at D4_SHAPES; then the stamped copy's phases per block."""
    from quantizedattention_tpu_torch.parallel import decode_attention_int4

    libs = _d4_libs(D4_VARIANTS, {"d4_stamped": _d4_stamped(), "d4_merge_launch": _altered(
        D4_VARIANTS["d4_merge_launch"], SRC_CACHE) + _D4_MERGE_LAUNCH})
    counters = torch.zeros(8 * 16, dtype=torch.int32, device="cuda")
    arrived = counters.data_ptr()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, n_kv, length, spec in D4_SHAPES:
        q, slotted, paged, outs = _d4_case(gen, n_kv, length, spec)
        qb = q.to(torch.bfloat16)
        variants = [v for v in D4_VARIANTS if v != "d4_merge_launch"]
        times = {v[3:]: _device_us(lambda v=v: _d4_call(libs[v], qb, slotted, outs, arrived, n_kv,
                                                        spec)) for v in variants}
        times["f32_q"] = _device_us(
            lambda: _d4_call(libs["d4_as_is"], q, slotted, outs, arrived, n_kv, spec))
        merge = libs["d4_merge_launch"]

        def two_launches():
            _d4_call(merge, qb, slotted, outs, arrived, n_kv, spec)
            acc, ml, o, lse = outs
            status = merge.qa_probe_merge(acc.data_ptr(), ml.data_ptr(), slotted.length.data_ptr(),
                                          D4_CAP, o.data_ptr(), lse.data_ptr(), 8, n_kv,
                                          16 * spec // n_kv, spec,
                                          torch.cuda.current_stream().cuda_stream)
            if status:
                raise SystemExit(f"kernel_probe: merge launch failed with status {status}")

        times["merge_launch"] = _device_us(two_launches)
        times["b16"] = _device_us(
            lambda: _d4_call(libs["d4_as_is"], qb, paged, outs, arrived, n_kv, spec, paged=True))
        times["q_cast"] = _device_us(lambda: q.to(torch.bfloat16))
        if spec == 1:
            times["call_f32_q"] = _device_us(lambda: decode_attention_int4(q, slotted))
            times["call_bf16_q"] = _device_us(lambda: decode_attention_int4(qb, slotted))
        print(f"[probe] B15 {label}: 8 x 16 q / {n_kv} kv heads x spec {spec}, length {length} "
              f"of {D4_CAP}: " + ", ".join(f"{v} {us:.2f}" for v, us in times.items())
              + f" us ({smi})", flush=True)
        print(f"[split] B15 {label}: " + _d4_split(libs["d4_stamped"], label, qb, slotted, outs,
                                                   arrived, n_kv, spec, 4), flush=True)


# B13's and B14's error against their plain versions on chip_smoke.py's
# phase-21 and phase-23 inputs (non-finite stale scales, junk pages), drawn
# afresh from seed 0, and a digest of B15's and B16's outputs there (equal
# digests in two checkouts: the same bits); run in a checkout's own process
# by `python -c`
_D8_ERRORS = """
import hashlib, torch
import chip_smoke as cs
dev, out, bits = torch.device("cuda", 0), {}, hashlib.sha256()
gen = torch.Generator(device=dev).manual_seed(0)
for n_kv in (16, 4):
    q, d8, p8, d4, p4 = cs._cache_kinds(dev, gen, 16, n_kv, cs.CACHE_LENGTHS, True)
    for o in (*cs.decode_attention_int4(q, d4, return_lse=True),
              *cs.paged4_decode_attention(q, p4, return_lse=True)):
        bits.update(o.cpu().numpy().tobytes())
    for name, fn, plain, c in (("b13", cs.decode_attention, cs.decode_attention_plain, d8),
                               ("b14", cs.paged_decode_attention,
                                cs.paged_decode_attention_plain, p8)):
        out[f"{name} 16/{n_kv}"] = (fn(q, c) - plain(q, c)).abs().max().item()
    for spec in (2, 5):
        _, d8, p8, d4, p4 = cs._cache_kinds(dev, gen, 16, n_kv, cs.SPEC_LENGTHS, True)
        q = torch.randn((8, 16, spec, 64), generator=gen, device=dev)
        for o in (cs.verify_decode_attention_int4(q, d4), cs.paged4_verify_attention(q, p4)):
            bits.update(o.cpu().numpy().tobytes())
        for name, fn, plain, c in (("b13", cs.verify_decode_attention,
                                    cs.verify_decode_attention_plain, d8),
                                   ("b14", cs.paged_verify_attention,
                                    cs.paged_verify_attention_plain, p8)):
            out[f"{name} 16/{n_kv} spec {spec}"] = (fn(q, c) - plain(q, c)).abs().max().item()
print(", ".join(f"{k} {v:.3e}" for k, v in out.items()) + f"; B15/B16 bits {bits.hexdigest()[:16]}")
"""


def _d8_errors(tree) -> str:
    proc = subprocess.run([sys.executable, "-c", _D8_ERRORS], cwd=os.path.abspath(tree),
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"kernel_probe: the error check failed in {tree}:\n{proc.stderr[-3000:]}")
    return proc.stdout.strip()


def probe_decode8(smi, parent=None) -> None:
    """B13's knock-outs and its 128-token-chunk variant (on bf16 q), B13 on
    f32 q (rounded in the kernel), B14, and the whole wrapper call, timed at
    D4_SHAPES; then the stamped copy's phases per block; then B13's and
    B14's max|dO| against their plain versions and a digest of B15's and
    B16's outputs, in this checkout and, given one, the parent checkout."""
    from quantizedattention_tpu_torch.parallel import decode_attention

    libs = _d4_libs(D8_VARIANTS, {"d8_stamped": _d4_stamped()})
    counters = torch.zeros(8 * 16, dtype=torch.int32, device="cuda")
    arrived = counters.data_ptr()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, n_kv, length, spec in D4_SHAPES:
        q, slotted, paged, outs = _d4_case(gen, n_kv, length, spec, bits=8)
        qb = q.to(torch.bfloat16)
        times = {v[3:]: _device_us(lambda v=v: _d4_call(
            libs[v], qb, slotted, outs, arrived, n_kv, spec, bits=8,
            chunk=128 if v == "d8_chunk128" else 256)) for v in D8_VARIANTS}
        times["f32_q"] = _device_us(
            lambda: _d4_call(libs["d8_as_is"], q, slotted, outs, arrived, n_kv, spec, bits=8))
        times["b14"] = _device_us(lambda: _d4_call(libs["d8_as_is"], qb, paged, outs, arrived,
                                                   n_kv, spec, paged=True, bits=8))
        if spec == 1:
            times["call_f32_q"] = _device_us(lambda: decode_attention(q, slotted))
        print(f"[probe] B13 {label}: 8 x 16 q / {n_kv} kv heads x spec {spec}, length {length} "
              f"of {D4_CAP}: " + ", ".join(f"{v} {us:.2f}" for v, us in times.items())
              + f" us ({smi})", flush=True)
        print(f"[split] B13 {label}: " + _d4_split(libs["d8_stamped"], label, qb, slotted, outs,
                                                   arrived, n_kv, spec, 8), flush=True)
    for tree in ([parent] if parent else []) + ["."]:
        print(f"[error] B13/B14 max|dO| vs plain (DECODE_TOL 5e-3), {os.path.abspath(tree)}: "
              + _d8_errors(tree) + f" ({smi})", flush=True)


# --------------------------------------------------------------------------
# B4, the Q/K/V quantizer
# --------------------------------------------------------------------------

SRC_QUANT = os.path.join(_build.CSRC_DIR, "quant_int8.cu")
QUANT_SHAPE = (4, 16, 2048)  # (b, h = h_kv, t = s): the training shape, grains of 1024
# knock-outs of this design (each computes wrong results on purpose)
_Q_DIV = "rintf(__fdiv_rn(v, s))"
QUANT_VARIANTS = {
    "quantv_as_is": [],
    # the payload stores skipped (the scale still written): the loads, the
    # absmax and the cluster exchange
    "quantv_loads_only": [("    if constexpr (VEC == 4)\n      *reinterpret_cast<uint32_t*>(o)",
                           "    if (s < 0.f)\n    if constexpr (VEC == 4)\n"
                           "      *reinterpret_cast<uint32_t*>(o)")],
    # a product instead of the IEEE division
    "quantv_no_div": [(_Q_DIV, "rintf(__fmul_rn(v, s))")],
    # each block's own max, no read of the other blocks' (the barriers stay)
    "quantv_no_exchange": [("  for (int q = 0; q < CLUSTER; ++q) amax = fmaxf(amax, ld_cluster_f32(at, q));",
                            "  amax = block_max;")],
    # the second cluster arrival right after the reads of the other blocks'
    # maxima, before the stores (the wait stays at the end)
    "quantv_early_arrive": [("  for (int q = 0; q < CLUSTER; ++q) amax = fmaxf(amax, ld_cluster_f32(at, q));\n",
                             "  for (int q = 0; q < CLUSTER; ++q) amax = fmaxf(amax, ld_cluster_f32(at, q));\n"
                             "  cluster_arrive();\n"),
                            ("  cluster_arrive();\n  cluster_wait();\n}", "  cluster_wait();\n}")],
    # blocks of 256 threads (8 chunks a thread at grain 1024)
    "quantv_threads256": [("constexpr int THREADS = 128;", "constexpr int THREADS = 256;")],
}
# the first design's (a parent checkout's): pass 2 reads nothing (it
# quantizes zeros), so the grain is read from memory once
_P_SECOND = ("  for (int tok = tok0 + r0; tok < tok0 + jb.grain; tok += ROWS_PER_STEP) {\n"
             "    const float4 v = load_shifted(jb, xrow, tok, sub);\n    char4 qv;",
             "  for (int tok = tok0 + r0; tok < tok0 + jb.grain; tok += ROWS_PER_STEP) {\n"
             "    const float4 v = make_float4(0.f, 0.f, 0.f, 0.f);\n    char4 qv;")


def _quant_call(lib, jobs, out):
    """One launch of a quant_int8.cu build of this design over `jobs`."""
    from quantizedattention_tpu_torch.quantize import int8 as tq
    n = len(jobs)
    views = [tq._rows_view(j.x) for j in jobs]
    status = lib.qa_quant_int8(
        (ctypes.c_void_p * n)(*(j.x.data_ptr() for j in jobs)),
        (ctypes.c_longlong * (3 * n))(*(st for j in jobs for st in tq._strides(j.x))),
        (ctypes.c_int * n)(*(v[1] for v in views)),
        (ctypes.c_void_p * n)(*(None if j.sub is None else j.sub.data_ptr() for j in jobs)),
        (ctypes.c_void_p * n)(*(x.data_ptr() for x, _ in out)),
        (ctypes.c_void_p * n)(*(sc.data_ptr() for _, sc in out)),
        (ctypes.c_int * n)(*(v[0] for v in views)), (ctypes.c_int * n)(*(v[2] for v in views)),
        (ctypes.c_int * n)(*(j.pad for j in jobs)), (ctypes.c_int * n)(*(j.grain for j in jobs)),
        n, tq.IN_TYPES[jobs[0].x.dtype], torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: quant launch failed with status {status}")


def _quant_call_parent(lib, jobs, out):
    """One launch of the first design's kernel (rows [rows, t, 64] contiguous)."""
    from quantizedattention_tpu_torch.quantize import int8 as tq
    n = len(jobs)
    rows = [j.x.reshape(-1, j.x.shape[-2], 64) for j in jobs]
    if not all(r.is_contiguous() for r in rows):
        raise SystemExit("kernel_probe: the first design takes contiguous rows")
    status = lib.qa_quant_int8(
        (ctypes.c_void_p * n)(*(r.data_ptr() for r in rows)),
        (ctypes.c_void_p * n)(*(None if j.sub is None else j.sub.data_ptr() for j in jobs)),
        (ctypes.c_void_p * n)(*(x.data_ptr() for x, _ in out)),
        (ctypes.c_void_p * n)(*(sc.data_ptr() for _, sc in out)),
        (ctypes.c_int * n)(*(r.shape[0] for r in rows)), (ctypes.c_int * n)(*(r.shape[1] for r in rows)),
        (ctypes.c_int * n)(*(j.pad for j in jobs)), (ctypes.c_int * n)(*(j.grain for j in jobs)),
        n, tq.IN_TYPES[jobs[0].x.dtype], torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: parent quant launch failed with status {status}")


def probe_quant(smi, parent=None) -> None:
    """B4 at the training shape on contiguous f32, the model's strided f32
    views and bf16 (B6's route), this design beside its knock-outs and,
    given a parent checkout, the first design as built there and without its
    second read of the grain; each build's ptxas registers and spills."""
    from quantizedattention_tpu_torch.ops import int8_fwd as ifwd
    from quantizedattention_tpu_torch.quantize import int8 as tq
    jobs = {name: _altered(edits, SRC_QUANT) for name, edits in QUANT_VARIANTS.items()}
    if parent:
        with open(os.path.join(parent, "quantizedattention_tpu_torch", "csrc", "quant_int8.cu")) as f:
            src = f.read()
        jobs["quantp_as_is"] = src
        if _P_SECOND[0] not in src:
            raise SystemExit("kernel_probe: the parent's quant_int8.cu has no second read to remove")
        jobs["quantp_no_second_read"] = src.replace(*_P_SECOND)
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: _build_lib(*item), jobs.items())))
    for name, lib in libs.items():
        print(f"[ptxas] {name}: " + "; ".join(_kernel_ptxas(lib, "quant_int8_kernel")), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, t = QUANT_SHAPE
    views = [torch.randn((b, t, h, 64), generator=gen, device="cuda").transpose(1, 2)
             for _ in range(3)]
    k_mean = views[1].mean(-2, keepdim=True)
    cases = {"f32 contiguous": [x.contiguous() for x in views], "f32 views": views,
             "bf16 contiguous": [x.contiguous().to(torch.bfloat16) for x in views]}
    for label, (q, k, v) in cases.items():
        qjobs = ifwd._qkv_jobs(q, k, v, k_mean, to_f32=False)
        out = [(torch.empty((tq._rows_view(j.x)[0], j.pad, 64), dtype=torch.int8, device="cuda"),
                torch.empty((tq._rows_view(j.x)[0], j.pad // j.grain), device="cuda"))
               for j in qjobs]
        times = {}
        for name, lib in libs.items():
            if name.startswith("quantp") and label == "f32 views":
                continue  # the first design reads contiguous rows only
            call = _quant_call_parent if name.startswith("quantp") else _quant_call
            times[name] = _device_us(lambda lib=lib, call=call: call(lib, qjobs, out))
        print(f"[probe] B4 ({b},{h},{t},64) {label}: "
              + ", ".join(f"{n} {us:.1f}" for n, us in times.items()) + f" us ({smi})", flush=True)


# --------------------------------------------------------------------------
# B10 exact, the tangent (3xTF32)
# --------------------------------------------------------------------------

TANGENT_CASE = (4, 4, 4096)  # the DiT's attention shape, non-causal
TANGENT_SEEDS = 256
# the first tile-sum design: every tile's h V + p tV summed into acc in place
# on the tensor cores (their truncating accumulation, over every key tile)
_TG_FRESH = ("    wgmma_tf32_m64n64k8_rs_zero(tacc, hs[0], desc_kmajor_sw128(st + TG_VB));",
             "    wgmma_tf32_m64n64k8_rs(acc, hs[0], desc_kmajor_sw128(st + TG_VB), 1);")
TG_VARIANTS = {
    "tgv_as_is": [],
    "tgv_in_place": [_TG_FRESH, ("wgmma_tf32_m64n64k8_rs(tacc,", "wgmma_tf32_m64n64k8_rs(acc,"),
                     ("#pragma unroll\n    for (int e = 0; e < 32; ++e) acc[e] += tacc[e];\n", ""),
                     ("    float tacc[32];\n", ""), ("    reg_fence(tacc);", "    reg_fence(acc);")],
    # the exponential's argument as p (no MUFU.EX2)
    "tgv_no_exp": [("exp2f(sacc[i] * qk_scale - lse[h2])", "(sacc[i] * qk_scale - lse[h2])")],
}


def _tangent_f64(q, k, v, o, lse, tq, tk, tv, sm_scale, qk_scale):
    """B10's function in float64 on the same inputs (non-causal): tO."""
    q, k, v, o, lse, tq, tk, tv = (x.double() for x in (q, k, v, o, lse, tq, tk, tv))
    p = torch.exp2((q @ k.transpose(-1, -2)) * qk_scale - lse[..., None])
    hp = p * ((tq @ k.transpose(-1, -2) + q @ tk.transpose(-1, -2)) * sm_scale)
    return hp @ v + p @ tv - hp.sum(-1, keepdim=True) * o


def _tangent_call(lib, q, o, lse, tq, prep, to, sm_scale, qk_scale, entry="qa_jvp_tangent_tf32"):
    """One launch of a B10 exact build on the prep's outputs (z = 1)."""
    b, h, t, _ = q.shape
    s = prep[0].shape[1]
    per = -(-s // 32)

    def st(x):
        return (ctypes.c_longlong * 3)(*x.stride()[:3])

    status = getattr(lib, entry)(
        q.data_ptr(), st(q), tq.data_ptr(), st(tq), o.data_ptr(), st(o), lse.data_ptr(), st(lse),
        (ctypes.c_void_p * 8)(*(x.data_ptr() for x in prep)), to.data_ptr(), None, b, h, t, s, 0,
        1, per, sm_scale, qk_scale, torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: B10 launch failed with status {status}")


def _tangent_ffma(lib, q, k, v, o, lse, tq, tk, tv, sm_scale, qk_scale):
    """The FFMA design's B10 exact (a parent checkout's csrc/jvp.cu), as its
    wrapper launched it: every input a contiguous f32 copy."""
    b, h, t, _ = q.shape
    ins = [x.float().contiguous() for x in (q, k, v, tq, tk, tv, o, lse)]
    to = torch.empty((b, h, t, 64), device=q.device)
    status = lib.qa_jvp_tangent(*(x.data_ptr() for x in ins), to.data_ptr(), b * h, t, k.shape[2],
                                0, 0, sm_scale, qk_scale, torch.cuda.current_stream().cuda_stream)
    if status:
        raise SystemExit(f"kernel_probe: the FFMA B10 launch failed with status {status}")
    return to


def probe_jvp_tangent(smi, parent=None) -> None:
    """B10 exact against float64 over TANGENT_SEEDS seeds at the DiT's shape
    (q, k, v, tq, tk, tv unit normal [b, h, t, d] views of [b, t, h, d]
    tensors; O and lse from B1 fp32): this design (3xTF32, as
    `attention_tangent_fwd` runs it), its first tile-sum design (in_place)
    and, given a parent checkout, the FFMA design; worst max|dtO| / max|tO|
    of each and the ratio to FFMA's (the design's gate: 4x). Then the
    kernel alone at the DiT, bench_jvp and dit_jvp shapes beside its
    knock-outs, and each build's ptxas registers and spills."""
    from quantizedattention_tpu_torch.ops import jvp_tangent as tjt
    jobs = {name: _altered(edits, SRC_JVP) for name, edits in TG_VARIANTS.items()}
    if parent:
        csrc = os.path.join(parent, "quantizedattention_tpu_torch", "csrc")
        with open(os.path.join(csrc, "jvp.cu")) as f:
            ffma_src = f.read()
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        futures = {name: pool.submit(_build_lib, name, src) for name, src in jobs.items()}
        if parent:
            futures["tgffma_parent"] = pool.submit(_build_lib, "tgffma_parent", ffma_src, csrc)
        libs = {name: f.result() for name, f in futures.items()}
    for name, lib in libs.items():
        kernel = "jvp_tangent_kernel" if name.startswith("tgffma") else "jvp_tangent_tf32"
        print(f"[ptxas] {name}: " + "; ".join(_kernel_ptxas(lib, kernel)), flush=True)
    sm_scale, qk_scale = 0.125, 0.125 * LOG2_E
    b, h, t = TANGENT_CASE
    designs = {"3xTF32": None, "in_place": libs["tgv_in_place"]}
    if parent:
        designs["FFMA"] = libs["tgffma_parent"]
    worst = dict.fromkeys(designs, 0.0)
    for seed in range(TANGENT_SEEDS):
        gen = torch.Generator(device="cuda").manual_seed(3000 + seed)
        q, k, v, tq, tk, tv = (torch.randn((b, t, h, 64), generator=gen, device="cuda")
                               .transpose(1, 2) for _ in range(6))
        o, lse = tfwd.flash_attention_fwd_fp32(q, k, v)
        want = _tangent_f64(q, k, v, o, lse, tq, tk, tv, sm_scale, qk_scale)
        scale = want.abs().max()
        for name, lib in designs.items():
            if name == "3xTF32":
                got = tjt.attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv)
            elif name == "FFMA":
                got = _tangent_ffma(lib, q, k, v, o, lse, tq, tk, tv, sm_scale, qk_scale)
            else:
                got = torch.empty((b, h, t, 64), device="cuda")
                _tangent_call(lib, q, o, lse, tq, tjt.tangent_prep(k, v, tk, tv), got, sm_scale,
                              qk_scale)
            worst[name] = max(worst[name], ((got.double() - want).abs().max() / scale).item())
        del want
    ratio = ""
    if "FFMA" in worst:
        ratio = "; 3xTF32 / FFMA " + f"{worst['3xTF32'] / worst['FFMA']:.2f}x (the gate: 4x)"
    print(f"[jvp_tangent] ({b},{h},{t},64), {TANGENT_SEEDS} seeds, worst max|dtO| / max|tO| "
          "against float64: " + ", ".join(f"{n} {e:.3e}" for n, e in worst.items()) + ratio
          + f" ({smi})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, t in [*JVP_SHAPES, (2, 4, 512)]:
        q, k, v, tq, tk, tv = (torch.randn((b, t, h, 64), generator=gen, device="cuda")
                               .transpose(1, 2) for _ in range(6))
        o, lse = tfwd.flash_attention_fwd_fp32(q, k, v)
        prep = tjt.tangent_prep(k, v, tk, tv)
        to = torch.empty((b, h, t, 64), device="cuda")
        times = {n: _device_us(lambda lib=lib: _tangent_call(lib, q, o, lse, tq, prep, to, sm_scale,
                                                             qk_scale), 2, 5)
                 for n, lib in libs.items() if n.startswith("tgv")}
        print(f"[probe] B10 exact kernel alone, one key range, ({b},{h},{t},64): "
              + ", ".join(f"{n[4:]} {us:.1f}" for n, us in times.items()) + f" us ({smi})",
              flush=True)



def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_probe: no CUDA device")
    every = ["weights", "int8_bwd", "flash_fwd", "flash_bwd", "bwd_exact", "fwd_fp32", "jvp_bwd",
             "jvp_fwd", "jvp_dq", "decode4", "decode8", "quant", "jvp_tangent"]
    dirs = [a for a in sys.argv[1:] if os.path.isdir(a)]
    parts = [a for a in sys.argv[1:] if a not in dirs] or every
    if set(parts) - set(every) or len(dirs) > 1:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if "weights" in parts:
        probe_weights(smi)
    if "int8_bwd" in parts:
        probe_int8_bwd(smi)
    if "flash_fwd" in parts:
        probe_flash_fwd(smi)
    if "flash_bwd" in parts:
        probe_flash_bwd(smi)
    if "bwd_exact" in parts:
        probe_bwd_exact(smi)
    if "fwd_fp32" in parts:
        probe_fwd_fp32(smi, dirs[0] if dirs else None)
    if "jvp_bwd" in parts:
        probe_jvp_bwd(smi)
    if "jvp_fwd" in parts:
        probe_jvp_fwd(smi)
    if "jvp_dq" in parts:
        probe_jvp_dq(smi)
    if "decode4" in parts:
        probe_decode4(smi)
    if "decode8" in parts:
        probe_decode8(smi, dirs[0] if dirs else None)
    if "quant" in parts:
        probe_quant(smi, dirs[0] if dirs else None)
    if "jvp_tangent" in parts:
        probe_jvp_tangent(smi, dirs[0] if dirs else None)



if __name__ == "__main__":
    main()
