"""Time kernels of two checkouts of the PyTorch port on one GPU, in turns:
the weight-only matmuls (B17 int8, B18 int4) beside bf16 torch.matmul, the
int8 backward (B7 dK/dV, B8 dQ), the corrected-bf16 flash forward (B1) and
its backward (B2 dK/dV, B3 dQ), B1's fp32 mode, the second-order
backward's fast dK/dV (B11) and dQ (B12), and the JVP forward's fast mode
(B9), the int4 decode kernels (B15 slotted, B16 paged) beside the paged
int8 one (B14), and the int8 decode kernels (B13 slotted, B14 paged)
beside the int4 ones, the Q/K/V quantizer (B4) and the tangent's exact
mode (B10 exact).

    python3 kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT [weights] [int8_bwd] [flash_fwd] [flash_bwd]
                                                   [flash_fwd_fp32] [jvp_bwd] [jvp_fwd] [jvp_dq]
                                                   [decode4] [decode8] [quant] [jvp_tangent]
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
or jvp_dkv_wgmma) and the rest of the call (its prep); at the same two
shapes B9 fast's whole `attention_jvp_fwd` call and B12 fast's `jvp_bwd_dq`
call (which runs its own prep where the checkout has one), each split into
the kernel (jvp_fwd_mma or jvp_fwd_wgmma; jvp_dq_mma or jvp_dq_wgmma) and
the rest of the call (its prep or its operands' f32 copies); B15 and B16
through each checkout's public wrappers (the parent has no decode_tiling)
at 8 sequences x 16 q heads: spec 1 and the verify wrappers at spec 5,
length 304 of 1280 (the serving decode), and spec 1 at 1280 of 1280 with
16 and 4 kv heads, the paged pools' pages of 128 shuffled, with B14 at the
first shape on int8 pages; decode8 times B13 and B14 (`decode_attention`,
`paged_decode_attention` and their verify wrappers) at the same shapes, and
B15 and B16 beside them on the same shapes' int4 caches; quant times B4
through each checkout's `quantize_qkv` at the training shape (4, 16, 2048,
64) on contiguous f32 and on the model's f32 [b, h, t, 64] views of [b, t,
h, 64] tensors (that call split by torch.profiler into the B4 kernel and the
rest: the copies a checkout makes before it), B4 on bf16 through
`quant_int8_uncounted` on the jobs B6 builds, and B6's whole call at (4, 16,
2048, 64) bf16 causal; jvp_tangent times B10 exact's whole
`attention_tangent_fwd` call on the DiT's views (O and lse from B1 fp32) at
the DiT's shape, bench_jvp's and the dit_jvp path's (2, 4, 512, 64), split
into the B10 kernel (jvp_tangent_kernel or jvp_tangent_tf32) and the rest
(copies, prep, merge). A time is the
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
# (kv heads of 16 q heads, length of 1280, spec), 8 sequences: the serving
# decode and its verify pass, the capacity at 16/16 and 16/4 heads
DECODE4_SHAPES = ((16, 304, 1), (16, 304, 5), (16, 1280, 1), (4, 1280, 1))
QUANT_SHAPE = (4, 16, 2048)  # (b, h = h_kv, t = s): the int8 training shape
# (b, h, t = s), non-causal: the DiT's, bench_jvp's, the dit_jvp path's
TANGENT_SHAPES = ((4, 4, 4096), (4, 16, 4096), (2, 4, 512))
PARTS = ("weights", "int8_bwd", "flash_fwd", "flash_bwd", "flash_fwd_fp32", "jvp_bwd", "jvp_fwd",
         "jvp_dq", "decode4", "decode8", "quant", "jvp_tangent")


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


def _jvp_fast_rows(torch, gen, dev, part) -> dict:
    """B9 fast's (`part` "jvp_fwd") or B12 fast's ("jvp_dq") whole call at
    JVP_SHAPES on the DiT's views, split into its kernel and the rest."""
    from quantizedattention_tpu_torch.ops import attention_jvp_fwd, jvp_bwd_dq, jvp_bwd_operands

    rows = {}
    for b, h, t in JVP_SHAPES:
        q, k, v, tq, tk, tv, do, dto = _dit_views(torch, gen, dev, b, h, t, 8)
        if part == "jvp_fwd":
            def call():
                return attention_jvp_fwd(q, k, v, tq, tk, tv, fast=True)
        else:
            fwd = attention_jvp_fwd(q, k, v, tq, tk, tv, fast=True)
            ops = jvp_bwd_operands(q, k, v, tq, tk, tv, *fwd, do, dto, fast=True)

            def call():
                return jvp_bwd_dq(ops)

        name = "jvp_fwd" if part == "jvp_fwd" else "jvp_dq"
        mma, wgmma, rest = _kernel_split_ms(torch, call, (f"{name}_mma", f"{name}_wgmma"), calls=5)
        rows[f"{'b9' if part == 'jvp_fwd' else 'b12'} fast b={b} h={h} t={t}"] = {
            "call_ms": _device_ms(torch, call, calls=5, replays=5), "kernel_ms": mma + wgmma,
            "prep_ms": rest}
    return rows


def _decode_rows(torch, gen, dev, part) -> dict:
    """The decode kernels through each checkout's public wrappers (spec 1,
    and the verify wrappers at spec 5) at DECODE4_SHAPES; q f32 as
    chip_smoke.py draws it, int8 and int4 caches of random bytes and scales
    (chip_smoke.py's ranges), the paged pools' pages of 128 shuffled.
    decode4: B15 and B16, and B14 at the first shape; decode8: B13 and B14,
    and B15 and B16 beside them."""
    from quantizedattention_tpu_torch import parallel as P

    rows = {}
    n, cap, ps = 8, 1280, 128
    max_pages = cap // ps
    for n_kv, length, spec in DECODE4_SHAPES:
        q = torch.randn((n, 16, 64) if spec == 1 else (n, 16, spec, 64), generator=gen,
                        device=dev)
        lengths = torch.full((n,), length, dtype=torch.int32, device=dev)
        table = (torch.randperm(n * max_pages, generator=torch.Generator().manual_seed(0)) + 1)
        table = table.reshape(n, max_pages).int().to(dev)
        pages = table.flatten().long()
        caches = {}
        for bits, lo, per_page, scale in ((4, -128, ps // 2, 0.28), (8, -127, ps, 0.028)):
            k, v = (torch.randint(lo, 128, (n, n_kv, max_pages * per_page, 64), generator=gen,
                                  device=dev, dtype=torch.int8) for _ in range(2))
            sk, sv = (torch.rand((n, n_kv, cap), generator=gen, device=dev) * scale + scale / 14
                      for _ in range(2))
            pool = []
            for x, y in ((k, sk), (v, sv)):
                p = torch.zeros((n_kv, 1 + n * max_pages, per_page, 64), dtype=torch.int8,
                                device=dev)
                p[:, pages] = x.reshape(n, n_kv, max_pages, per_page, 64).transpose(0, 1).reshape(
                    n_kv, n * max_pages, per_page, 64)
                sc = torch.zeros((1 + n * max_pages, n_kv, ps), device=dev)
                sc[pages] = y.reshape(n, n_kv, max_pages, ps).transpose(1, 2).reshape(
                    n * max_pages, n_kv, ps)
                pool += [p, sc]
            slotted = (P.Int4KVCache if bits == 4 else P.QuantizedKVCache)(k, sk, v, sv, lengths)
            paged = (P.Paged4KVCache if bits == 4 else P.PagedKVCache)(*pool, table, lengths)
            caches[bits] = slotted, paged
        calls = {"b13": (P.decode_attention, P.verify_decode_attention, caches[8][0]),
                 "b14": (P.paged_decode_attention, P.paged_verify_attention, caches[8][1]),
                 "b15": (P.decode_attention_int4, P.verify_decode_attention_int4, caches[4][0]),
                 "b16": (P.paged4_decode_attention, P.paged4_verify_attention, caches[4][1])}
        names = ["b13", "b14", "b15", "b16"] if part == "decode8" else ["b15", "b16"]
        if part == "decode4" and (n_kv, length, spec) == DECODE4_SHAPES[0]:
            names.append("b14")
        row = rows[f"{part} 8 x 16 q / {n_kv} kv heads x spec {spec}, length {length} of {cap}"] = {}
        for name in names:
            one, verify, cache = calls[name]
            fn = one if spec == 1 else verify
            row[f"{name}_ms"] = _device_ms(torch, lambda: fn(q, cache))
    return rows


def _quant_rows(torch, gen, dev) -> dict:
    """B4 through `quantize_qkv` (contiguous f32; the model's f32 views, split
    into the kernel and the rest), on bf16 as B6 launches it, and B6's call."""
    from quantizedattention_tpu_torch.ops import int8_attention_fwd_fused, quantize_qkv
    from quantizedattention_tpu_torch.ops import int8_fwd as ifwd
    from quantizedattention_tpu_torch.quantize.int8 import quant_int8_uncounted

    b, h, t = QUANT_SHAPE
    views = _dit_views(torch, gen, dev, b, h, t, 3)
    dense = [x.contiguous() for x in views]
    k_mean = dense[1].mean(-2, keepdim=True)
    bf16 = [x.to(torch.bfloat16) for x in dense]
    k_sub = bf16[1].float().mean(-2, keepdim=True).to(torch.bfloat16)
    jobs = ifwd._qkv_jobs(*bf16, k_sub, to_f32=False)

    def on_views():
        return quantize_qkv(*views, k_sub=k_mean)

    kernel_ms, rest_ms = _kernel_split_ms(torch, on_views, ("quant_int8_kernel<float>",))
    return {f"quant b={b} h={h} t={t}": {
        "f32_contiguous_ms": _device_ms(torch, lambda: quantize_qkv(*dense, k_sub=k_mean)),
        "f32_views_ms": _device_ms(torch, on_views), "f32_views_kernel_ms": kernel_ms,
        "f32_views_rest_ms": rest_ms,
        "bf16_ms": _device_ms(torch, lambda: quant_int8_uncounted(jobs)),
        "b6_bf16_causal_ms": _device_ms(torch, lambda: int8_attention_fwd_fused(
            *bf16, causal=True, k_sub=k_sub))}}


def _tangent_rows(torch, gen, dev) -> dict:
    """B10 exact's whole call on the DiT's views at TANGENT_SHAPES, split
    into its kernel and the rest of the call."""
    from quantizedattention_tpu_torch.ops import attention_tangent_fwd, flash_attention_fwd_fp32

    rows = {}
    for b, h, t in TANGENT_SHAPES:
        q, k, v, tq, tk, tv = _dit_views(torch, gen, dev, b, h, t, 6)
        o, lse = flash_attention_fwd_fp32(q, k, v)

        def call():
            return attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv)

        ffma, tf32, rest = _kernel_split_ms(torch, call, ("jvp_tangent_kernel", "jvp_tangent_tf32"),
                                            calls=5)
        rows[f"b10 exact b={b} h={h} t={t}"] = {
            "call_ms": _device_ms(torch, call, calls=5, replays=5), "kernel_ms": ffma + tf32,
            "rest_ms": rest}
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
    for part in ("jvp_fwd", "jvp_dq"):
        if part in parts:
            rows.update(_jvp_fast_rows(torch, gen, dev, part))
    for part in ("decode4", "decode8"):
        if part in parts:
            rows.update(_decode_rows(torch, gen, dev, part))
    if "quant" in parts:
        rows.update(_quant_rows(torch, gen, dev))
    if "jvp_tangent" in parts:
        rows.update(_tangent_rows(torch, gen, dev))
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
