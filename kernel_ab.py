"""Time kernels of two checkouts of the PyTorch port on one GPU, in turns:
the weight-only matmuls (B17 int8, B18 int4) beside bf16 torch.matmul, the
int8 backward (B7 dK/dV, B8 dQ), the corrected-bf16 flash forward (B1) and
its backward (B2 dK/dV, B3 dQ), B1's fp32 mode and the second-order
backward's fast dK/dV (B11).

    python3 kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT [weights] [int8_bwd] [flash_fwd] [flash_bwd]
                                                   [flash_fwd_fp32] [jvp_bwd]
    python3 kernel_ab.py --one CHECKOUT flash_fwd      (one checkout, once)

(every part without a third argument). Each checkout is timed in its own
process (its own package and kernel build), in the order old, new, new, old:
the weight matmuls at chip_smoke.py's WEIGHT_SHAPES, m = 8 (decode), 40 (a
spec verify pass) and 2048 (prefill) rows against the bench LM's (k, n); B7
and B8 at chip_smoke.py's phase-8 timing shapes, (4, 16, 2048, 64) and GQA
rep 4 (2, 16 q / 4 kv, 2048, 64), causal, on the forward's residuals; B1's
wrapper `flash_attention_fwd`, causal, at the serving prefill (8, 16, 256,
64) on bf16 inputs, the training shape (4, 16, 2048, 64) on f32 and on bf16
inputs, (4, 16, {4096, 8192}, 64) bf16 and GQA rep 4 (4, 16 q / 4 kv, 4096,
64) bf16, each call also split by torch.profiler into the B1 kernel's device
time and the rest of the call (the wrapper's prep launches); the backward's
fast mode, B2 and B3 on prepared operands and the whole
`flash_attention_bwd` call on the model's inputs (f32 [b, h, t, 64] views
of [b, t, h, 64] tensors, O and lse from B1), at (4, 16, {2048, 4096,
8192}, 64) and GQA rep 4 (2, 16 q / 4 kv, 2048, 64), causal, the call split
by torch.profiler into B2, B3 and the rest (the operand prep), and exact
mode's B2 and B3 at the first shape; B1's fp32 mode (`flash_attention_fwd_fp32`,
non-causal, on the DiT's f32 [b, h, t, 64] views of [b, t, h, 64] tensors)
beside SDPA f32 on the same inputs, and B11 fast's whole `jvp_bwd_dkv` call
(on `jvp_bwd_operands`' fast operands from B9's residuals), each at the DiT's
attention shape (4, 4, 4096, 64) and bench_jvp's (4, 16, 4096, 64) and split
by torch.profiler into the kernel (flash_fwd_f32_kernel; B11's jvp_dkv_mma
or jvp_dkv_wgmma) and the rest of the call (its prep). A time is the
mean device time of one wrapper call, from CUDA-graph replays as in
chip_smoke.py:device_ms. Inputs come from a seeded generator, so both
checkouts see the same ones. Prints one JSON line a run and a summary line a
shape (the mean of each checkout's two runs); exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

MS = (8, 40, 2048)
KN = ((1024, 1024), (1024, 4096), (4096, 1024), (1024, 8192))
BWD_SHAPES = ((4, 16, 16, 2048), (2, 16, 4, 2048))  # (b, h, h_kv, t = s), causal
# (b, h, h_kv, t = s, input dtype), causal
FWD_SHAPES = ((8, 16, 16, 256, "bfloat16"), (4, 16, 16, 2048, "float32"),
              (4, 16, 16, 2048, "bfloat16"), (4, 16, 16, 4096, "bfloat16"),
              (4, 16, 16, 8192, "bfloat16"), (4, 16, 4, 4096, "bfloat16"))
# (b, h, h_kv, t = s), causal, f32 inputs as the model hands them in
FLASH_BWD_SHAPES = ((4, 16, 16, 2048), (2, 16, 4, 2048), (4, 16, 16, 4096), (4, 16, 16, 8192))
# (b, h, t = s), non-causal: the DiT's attention shape, bench_jvp's
JVP_SHAPES = ((4, 4, 4096), (4, 16, 4096))
PARTS = ("weights", "int8_bwd", "flash_fwd", "flash_bwd", "flash_fwd_fp32", "jvp_bwd")


def _device_ms(torch, fn, calls=20, replays=10) -> float:
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
    return start.elapsed_time(end) / (calls * replays)


def _weight_rows(torch, gen, dev) -> dict:
    import torch.nn.functional as F

    from quantizedattention_tpu_torch.ops import int4_weight_matmul, int8_weight_matmul
    from quantizedattention_tpu_torch.quantize.weights import quantize_weight, quantize_weight_int4

    rows = {}
    for m in MS:
        for k, n in KN:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            q8, q4 = quantize_weight(w), quantize_weight_int4(w)
            x4 = F.pad(x, (0, 2 * q4.packed.shape[0] - k))
            wb = w.to(torch.bfloat16)
            rows[f"m={m} k={k} n={n}"] = {
                "int8_ms": _device_ms(torch, lambda: int8_weight_matmul(x, q8.w_i8, q8.scale)),
                "int4_ms": _device_ms(
                    torch, lambda: int4_weight_matmul(x4, q4.packed, q4.scale, q4.group)),
                "bf16_matmul_ms": _device_ms(torch, lambda: torch.matmul(x, wb))}
    return rows


def _int8_bwd_rows(torch, gen, dev) -> dict:
    from quantizedattention_tpu_torch.ops import (int8_attention_fwd_from_quantized, int8_bwd_dkv,
                                                  int8_bwd_dq, int8_bwd_operands, quantize_qkv)

    rows = {}
    for b, h, h_kv, t in BWD_SHAPES:
        q, k, v, do = (torch.randn((b, n, t, 64), generator=gen, device=dev)
                       for n in (h, h_kv, h_kv, h))
        k_mean = k.mean(dim=-2, keepdim=True)
        res = quantize_qkv(q, k, v, k_sub=k_mean)
        dims = (b, h, t, t, 64)
        o, lse = int8_attention_fwd_from_quantized(res, dims, causal=True)
        ops = int8_bwd_operands(res, k_mean, o, lse, do, dims, causal=True)
        rows[f"b={b} h={h} h_kv={h_kv} t={t} causal"] = {
            "b7_ms": _device_ms(torch, lambda: int8_bwd_dkv(ops)),
            "b8_ms": _device_ms(torch, lambda: int8_bwd_dq(ops))}
    return rows


def _kernel_split_ms(torch, fn, names=("flash_fwd_kernel",), calls=20) -> list[float]:
    """The device time per `fn()` call of each kernel in `names` (by CUDA
    function name), then of every other launch, from torch.profiler over
    `calls` eager calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = [0.0] * (len(names) + 1)
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            at = next((i for i, n in enumerate(names) if f"{n}(" in e.key), len(names))
            split[at] += e.self_device_time_total
    return [x / calls / 1e3 for x in split]


def _flash_fwd_rows(torch, gen, dev) -> dict:
    from quantizedattention_tpu_torch.ops import flash_attention_fwd

    rows = {}
    for b, h, h_kv, t, dtype in FWD_SHAPES:
        q, k, v = (torch.randn((b, n, t, 64), generator=gen, device=dev).to(getattr(torch, dtype))
                   for n in (h, h_kv, h_kv))

        def call():
            return flash_attention_fwd(q, k, v, causal=True)

        kernel_ms, prep_ms = _kernel_split_ms(torch, call)
        rows[f"b={b} h={h} h_kv={h_kv} t={t} {dtype} causal"] = {
            "call_ms": _device_ms(torch, call), "kernel_ms": kernel_ms, "prep_ms": prep_ms}
    return rows


def _flash_bwd_rows(torch, gen, dev) -> dict:
    from quantizedattention_tpu_torch.ops import (bwd_operands, flash_attention_bwd,
                                                  flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq)

    rows = {}
    for b, h, h_kv, t in FLASH_BWD_SHAPES:
        q, k, v, do = (torch.randn((b, t, n, 64), generator=gen, device=dev).transpose(1, 2)
                       for n in (h, h_kv, h_kv, h))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        ops = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True)

        def call():
            return flash_attention_bwd(q, k, v, o, lse, do, causal=True, fast=True)

        b2, b3, prep = _kernel_split_ms(torch, call, ("dkv_kernel_bf16", "dq_kernel_bf16"))
        row = rows[f"b={b} h={h} h_kv={h_kv} t={t} f32 causal"] = {
            "b2_ms": _device_ms(torch, lambda: flash_bwd_dkv(ops)),
            "b3_ms": _device_ms(torch, lambda: flash_bwd_dq(ops)),
            "call_ms": _device_ms(torch, call), "call_b2_ms": b2, "call_b3_ms": b3,
            "call_prep_ms": prep}
        if (b, h, h_kv, t) == FLASH_BWD_SHAPES[0]:  # exact mode (FFMA) at the first shape
            ops = bwd_operands(q, k, v, o, lse, do, causal=True, fast=False)
            row["b2_exact_ms"] = _device_ms(torch, lambda: flash_bwd_dkv(ops), calls=4, replays=5)
            row["b3_exact_ms"] = _device_ms(torch, lambda: flash_bwd_dq(ops), calls=4, replays=5)
        del ops
    return rows


def _dit_views(torch, gen, dev, b, h, t, n):
    """n f32 [b, h, t, 64] views of [b, t, h, 64] tensors, as the DiT hands
    them to attention."""
    return [torch.randn((b, t, h, 64), generator=gen, device=dev).transpose(1, 2)
            for _ in range(n)]


def _fwd_fp32_rows(torch, gen, dev) -> dict:
    import torch.nn.functional as F

    from quantizedattention_tpu_torch.ops import flash_attention_fwd_fp32

    rows = {}
    for b, h, t in JVP_SHAPES:
        q, k, v = _dit_views(torch, gen, dev, b, h, t, 3)

        def call():
            return flash_attention_fwd_fp32(q, k, v)

        kernel_ms, prep_ms = _kernel_split_ms(torch, call, ("flash_fwd_f32_kernel",), calls=5)
        rows[f"fp32 b={b} h={h} t={t}"] = {
            "call_ms": _device_ms(torch, call, calls=5, replays=5), "kernel_ms": kernel_ms,
            "prep_ms": prep_ms,
            "sdpa_f32_ms": _device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v),
                                      calls=5, replays=5)}
    return rows


def _jvp_bwd_rows(torch, gen, dev) -> dict:
    from quantizedattention_tpu_torch.ops import attention_jvp_fwd, jvp_bwd_dkv, jvp_bwd_operands

    rows = {}
    for b, h, t in JVP_SHAPES:
        q, k, v, tq, tk, tv, do, dto = _dit_views(torch, gen, dev, b, h, t, 8)
        fwd = attention_jvp_fwd(q, k, v, tq, tk, tv, fast=True)
        ops = jvp_bwd_operands(q, k, v, tq, tk, tv, *fwd, do, dto, fast=True)

        def call():
            return jvp_bwd_dkv(ops)

        mma, wgmma, prep = _kernel_split_ms(torch, call, ("jvp_dkv_mma", "jvp_dkv_wgmma"), calls=5)
        rows[f"b11 fast b={b} h={h} t={t}"] = {
            "call_ms": _device_ms(torch, call, calls=5, replays=5), "kernel_ms": mma + wgmma,
            "prep_ms": prep}
        del ops, fwd
    return rows


def run_one(tree: str, parts) -> None:
    """Time `tree`'s kernels; print one JSON object."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    if "weights" in parts:
        rows.update(_weight_rows(torch, gen, dev))
    if "int8_bwd" in parts:
        rows.update(_int8_bwd_rows(torch, gen, dev))
    if "flash_fwd" in parts:
        rows.update(_flash_fwd_rows(torch, gen, dev))
    if "flash_bwd" in parts:
        rows.update(_flash_bwd_rows(torch, gen, dev))
    if "flash_fwd_fp32" in parts:
        rows.update(_fwd_fp32_rows(torch, gen, dev))
    if "jvp_bwd" in parts:
        rows.update(_jvp_bwd_rows(torch, gen, dev))
    print(json.dumps({"tree": tree, "device": torch.cuda.get_device_name(0), "rows": rows}))


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2], sys.argv[3:] or list(PARTS))
        return
    parts = sys.argv[3:] or list(PARTS)
    if len(sys.argv) < 3 or set(parts) - set(PARTS):
        sys.exit(__doc__)
    old, new = sys.argv[1:3]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for tree in (old, new, new, old):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, *parts],
                             capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"timing {tree} failed:\n{out.stderr[-3000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for shape, row in runs[0]["rows"].items():
        mean = {label: {key: sum(runs[i]["rows"][shape][key] for i in idx) / 2 for key in row}
                for label, idx in (("old", (0, 3)), ("new", (1, 2)))}
        print(f"[ab] {shape}: " + ", ".join(
            f"{key[:-3]} {mean['old'][key]:.4f} -> {mean['new'][key]:.4f} ms" for key in row)
              + f" ({smi})", flush=True)


if __name__ == "__main__":
    main()
