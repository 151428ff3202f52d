"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the CUDA kernels and the native scheduler from this
     checkout's sources, all at once (quantizedattention_tpu_torch/_build.py);
  3. flash_fwd kernel vs its plain PyTorch version (O and lse);
  4. decode kernel vs its plain version, with stale non-finite scales and
     junk payloads written past every row's length;
  5. serving at full width: the bench LM (vocab 8192, d_model 1024, 16 heads,
     head_dim 64, 4 layers, max_seq 1280, bf16) serves 8 requests of 256
     random tokens x 96 new tokens through ServingEngine (8 slots, decode
     horizon 32), after a warm-up run. The timed run must launch both
     kernels, repeat the warm-up's tokens, and match `generate` on the same
     8 prompts as one batch; prefill logits must agree with the plain path
     on the CPU;
  6. flash_bwd: the dK/dV (B2) and dQ (B3) kernels vs their plain versions in
     fast and exact mode (O and lse from the B1 kernel), on the forward's
     cases and a few edge shapes, and autograd through
     flash_attention_bf16 against the fp32 oracle within the JAX package's
     envelope;
  7. the training shape (4, 16, 2048, 64), causal: B1, B2 and B3 (both
     modes) held against their plain versions, then timed beside them and
     beside F.scaled_dot_product_attention (a yardstick only; the port never
     calls it);
  8. int8 kernels: B4 (quantize, byte-equal), B5 (forward), B7 (dK/dV) and
     B8 (dQ) against their plain versions at the training shape, a ragged
     length with a large K mean, GQA rep 4, the GQA train shape (rep 2), the
     int8 serving prefill's shape (8, 16, 256, 64) and an odd cross length, with B8's K-smoothing term held on its own where
     the K mean is large; then each timed at (4, 16, 2048, 64) causal beside
     its plain version;
  9. sage_attention_int8 at (4, 16, 2048, 64) causal against the fp32
     oracle by the JAX package's criteria, with the tiny-magnitude causal
     case and K-smoothing against the raw int8 path;
 10. train at full width, with bf16 and then with int8 attention from the
     same init: the bench LM's widths at max_seq 2048 with f32 params,
     4 x 2048 tokens, 1 warm-up + 10 timed AdamW steps through
     make_train_step; losses finite and falling; each step launches its
     attention kind's kernels (B1/B2/B3, or B4/B5/B7/B8) n_layers times and
     the other kind's never; lm_loss gradients on the card vs the CPU plain
     path; torch.profiler over one more step (device time by kernel, busy
     share); the int8 run's global gradient norm within 2x of the bf16
     run's at every step (BASELINE config 4);
 11. train GQA: the entry() config (4 q / 2 kv heads), 8 x 512 tokens, 10
     steps, with bf16 and with int8 attention; losses finite and falling,
     the dK/dV kernels run with rep 2;
 12. the fused int8 inference kernel (B6) against its plain version (bf16
     and f32 inputs at (4, 16, 2048, 64) causal, a ragged length with a
     large K mean, GQA rep 4, an odd cross length, rep 3 and one token), and
     against B4 then B5 on the same inputs up to 8192 tokens (lse equal);
 13. sage_attention_int8_inference at (4, 16, 2048, 64) against the fp32
     oracle with bench.py's gate, and with a K offset of 8 (smoothing);
 14. BASELINE config 3: sage_attention_int8_inference at (4, 16, {2048,
     4096, 8192}, 64) causal on bf16 inputs (the path run whose B6 launches
     are counted), then B6 timed beside SDPA bf16, B4 -> B5 and B1 on the
     same inputs, and at the GQA shape (4, 16 q / 4 kv, 4096, 64);
 15. the weight-only int8 (B17) and int4 (B18) matmuls against their plain
     versions at decode (m = 8) and prefill (m = 2048) rows of the bench
     widths and an odd shape, then timed beside the bf16 GEMM they replace;
 16. quantized serving at full width, as phase 5, with attention="int8"
     (prefill through B4 + B5, never B1), with weight_quant="int8" (every
     projection and the unembedding through B17) and with
     weight_quant="int4" (B18); each repeats its warm-up, matches
     `generate` on its own params and the CPU plain path's prefill logits;
     two bf16 runs bracket them, and each is compared with their mean;
 17. the JVP family against its plain versions: B1's fp32 mode, B9 (O, tO,
     lse, mu), B10 (tO given O and lse), B11 (dK, dV, dtK, dtV) and B12
     (dQ, dtQ), B9-B12 in fast and exact mode, at (2, 4, 1024, 64) causal
     and not, the DiT's attention shape (4, 4, 4096, 64), 77x201 causal and
     not, (1, 3, 33, 130) causal and not, and one token;
 18. BASELINE config 5's gate: attention_value_and_jvp (exact) and
     torch.func.jvp of attention_jvp at (1, 2, 4096, 64) against the fp32
     oracle's (O, tO), 0 mismatches at atol 1e-2; at (1, 2, 256, 64),
     causal and not, the gradients of a loss over (O, tO) and of
     attention_jvp against autograd through the oracle; fast against
     exact;
 19. timing of B1 fp32 (beside F.scaled_dot_product_attention on the same
     f32 inputs) and B9-B12 in both modes, at the DiT's attention shape
     (4, 4, 4096, 64) beside their plain versions and at bench.py's
     bench_jvp shape (4, 16, 4096, 64), non-causal;
 20. the rCM distillation step of the DiT at BASELINE config 5
     (DiTConfig(seq_len=4096): d_model 256, 4 heads, 2 layers; batch 4;
     `ada` and `out` drawn at 1/sqrt(fan_in), so attention reaches the
     loss), fast=True: 1 warm-up + 5 AdamW steps through make_dit_rcm_step,
     losses finite and falling, each step launching B1 fp32, B9, B11 and
     B12 n_layers times and no other kernel; step time, tokens/s and peak
     memory; torch.profiler over one more step; at seq 512 the loss and
     every gradient against the CPU plain path, (u, du/dt) against finite
     differences, and torch.func.jvp of dit_forward through B10.
Then one JSON line with per-kernel launches, errors, times and bounds, and,
last, {"ok": true, "device": {...}}. Weights and inputs are random from fixed
seeds. Kernel times are device times per call (wrapper included: casts and
allocation), from CUDA events around CUDA-graph replays; serving and train
step times are CUDA events or host wall clock around synchronised work. They
are records, not claims.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch import _build
from quantizedattention_tpu_torch.models import (
    DiTConfig,
    TransformerConfig,
    dit_forward,
    dit_jvp_step,
    dit_param_leaves,
    init_dit,
    make_dit_rcm_step,
    rcm_loss,
    generate,
    init_transformer,
    lm_loss,
    make_train_step,
    param_leaves,
    transformer_forward,
)
from quantizedattention_tpu_torch.ops import (
    attention_jvp,
    attention_jvp_fwd,
    attention_jvp_fwd_plain,
    attention_tangent_fwd,
    attention_tangent_fwd_plain,
    attention_value_and_jvp,
    jvp_bwd_dkv,
    jvp_bwd_dkv_plain,
    jvp_bwd_dq,
    jvp_bwd_dq_plain,
    jvp_bwd_operands,
    bwd_operands,
    flash_attention_bf16,
    int4_weight_matmul,
    int4_weight_matmul_plain,
    int8_attention_fwd_fused,
    int8_attention_fwd_fused_plain,
    int8_weight_matmul,
    int8_weight_matmul_plain,
    sage_attention_int8_inference,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    int8_attention_fwd,
    int8_attention_fwd_from_quantized,
    int8_attention_fwd_from_quantized_plain,
    int8_bwd_dkv,
    int8_bwd_dkv_plain,
    int8_bwd_dq,
    int8_bwd_dq_plain,
    int8_bwd_operands,
    quantize_qkv,
    quantize_qkv_plain,
    sage_attention_int8,
)
from quantizedattention_tpu_torch.ops.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_fp32,
    flash_attention_fwd_plain,
)
from quantizedattention_tpu_torch.parallel.kv_cache import (
    QuantizedKVCache,
    decode_attention,
    decode_attention_plain,
)
from quantizedattention_tpu_torch.quantize.int8 import quant_int8
from quantizedattention_tpu_torch.quantize.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    quantize_weight,
    quantize_weight_int4,
)
from quantizedattention_tpu_torch.reference import (
    reference_attention,
    reference_attention_jvp,
    reference_attention_vjp,
)
from quantizedattention_tpu_torch.serve import ServingEngine
from quantizedattention_tpu_torch.utils.testing import ATOL, GRAD_MISMATCH_RATE, mismatch_report

# kernel vs plain, unit-normal inputs: only the summation order and where P
# is rounded to bf16 differ. The kernel rounds each 64-key tile's P against
# the running max, the plain version against the row's final max, so an
# entry can differ by up to one bf16 ulp (2^-7 relative); in a row dominated
# by a few keys that moves l, and lse = m + log2(l) by up to log2(1 + 2^-7)
# = 1.1e-2 in the worst case.
FLASH_O_TOL, FLASH_LSE_TOL = 5e-3, 5e-3
DECODE_TOL = 5e-3
# bf16 model on the card vs the same bf16 model through the plain path on
# the CPU: relative L2 distance of the prefill logits
LOGITS_REL_TOL = 5e-2
# Backward kernel vs plain, as max|diff| / max|plain| per tensor, with O and
# lse from the same B1 run handed to both. Fast: both round the same
# operands at the same points, so only the f32 summation order differs, and
# it can tip a P or dS entry across a bf16 rounding boundary (one ulp, 2^-8
# relative, of one term of a sum over up to s terms): a few 1e-3 at most.
# Exact: fp32 throughout, only the summation order: ~1e-6.
BWD_FAST_TOL, BWD_EXACT_TOL = 1e-2, 1e-4
# Int8 backward kernels (B7, B8) vs plain, the same measure: both take the
# same int8 payloads, scales, O and lse and round P, dO and dS to bf16 at the
# same points, so only the f32 summation order differs (1.1e-4 at most on an
# H100 at the training shape). 1e-3 is the CPU tests' BWD_REL.
INT8_BWD_TOL = 1e-3
# lm_loss on the card vs the CPU plain path, same f32 params: the two differ
# where B1 rounds P (per 64-key tile on the card, per row on the CPU; a few
# 1e-3 in O, as the flash_fwd phase shows) and in summation order. Loss and
# gradients are smooth in O, so they move by the same order; the loss
# averages it away.
TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2 = 1e-3, 5e-2
# The int8 path against the fp32 oracle: the JAX package's own criteria
# (tests/test_int8_attention.py): forward mismatch rate <= 2e-3 at atol 5e-2
# (also for tiny-magnitude causal inputs, whose dequant scale is ~1e-9), and
# gradients within relative L2 0.06.
INT8_ATOL, INT8_FWD_RATE, INT8_GRAD_REL_L2 = 5e-2, 2e-3, 0.06
# BASELINE config 4: the int8 run's global gradient norm stays below twice
# the bf16 run's at every step (tests/test_baseline_configs.py:96-98).
GRAD_NORM_RATIO = 2.0
# B6 against B4 then B5 on the same inputs: the same payloads and scales and
# B5's tile order, so lse must be equal and O within the JAX package's
# fused-vs-materialized criterion (tests/test_int8_attention.py:95-108).
FUSED_O_TOL = 1e-6
# B17/B18 against their plain versions: with an f32 output only the f32
# summation order differs (2e-4 of max|plain|, the JAX package's kernel test,
# tests/test_int8_weights.py:54); a bf16 output rounds that once more, so it
# may land one bf16 ulp away (on top of the f32 difference, which matters
# only for results near 0).
WEIGHT_F32_REL = 2e-4
# The JVP family (B1 fp32, B9-B12) against its plain versions, as
# max|diff| / max|plain| per tensor (lse: max|diff|), as B2/B3 are held.
# Where a tensor is 0 in exact arithmetic (one key: the softmax is constant,
# so dS = 0 and dK, dtK, dQ, dtQ vanish) both sides hold rounding noise, so
# it is held by max|diff| alone, against the unit-normal inputs' scale.
# Exact: fp32 throughout, only the summation order differs (3e-6 at 4096
# keys on an H100). B9 fast: the kernel rounds P to bf16 against the running max of each
# 32-key tile, the plain version against the row's final max, so an entry can
# differ by one bf16 ulp: compared as B1 bf16 is, 5e-3. B10-B12 fast: both
# round the same operands at the same points, so only the summation order
# differs, and it can tip an entry across a bf16 rounding boundary:
# BWD_FAST_TOL, as B2/B3.
JVP_EXACT_TOL, JVP_FWD_FAST_TOL = 1e-4, 5e-3
# BASELINE config 5's gate (tests/test_baseline_configs.py:101-116): 0
# mismatches at atol 1e-2 against the fp32 oracle; the JAX package's
# second-order gradient envelope (tests/test_jvp_grad.py), rtol and atol
# 5e-4; and its fast-vs-exact envelope, O 2e-2 and tO 5e-2.
CONFIG5_ATOL, JVP_GRAD_TOL, JVP_FAST_O, JVP_FAST_TO = 1e-2, 5e-4, 2e-2, 5e-2
# The rCM loss and gradients on the card vs the CPU plain path with the same
# params, both fast: the kernels' summation order against the plain
# versions' flips bf16 rounding of single products (1e-2 at most per kernel
# output, phase 17), and the loss and gradients are smooth in them.
DIT_GRAD_REL_L2 = 5e-2
# du/dt through torch.func.jvp of dit_forward (fp32 B1, exact B10) against
# the rCM pair path (fast B9): the same function, the pair path rounding each
# product's operands to bf16 (2^-8 relative), which the relative L2 distance
# averages over the output (1.0e-4 on an H100 at seq 512).
DIT_JVP_REL_L2 = 1e-2

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): a kernel's
# bound is the larger of its operations over the peak of their type and its
# bytes (each input read once, each output written once) over HBM bandwidth.
PEAK_BF16, PEAK_INT8, PEAK_FP32, HBM_BYTES_S = 989e12, 1979e12, 67e12, 3.35e12

BENCH_CFG = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=16,
                              head_dim=64, n_layers=4, max_seq=1280)
N_SLOTS, PROMPT_LEN, NEW_TOKENS, HORIZON = 8, 256, 96, 32
# training: BASELINE config 2's attention shape (4, 16, 2048, 64) in every layer
TRAIN_CFG = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=16,
                              head_dim=64, n_layers=4, max_seq=2048)
TRAIN_BATCH, TRAIN_STEPS, PARITY_LEN = 4, 10, 256
GQA_CFG = TransformerConfig(vocab_size=512, d_model=256, n_heads=4, n_kv_heads=2,
                            head_dim=64, n_layers=2, max_seq=512)
GQA_BATCH = 8
# BASELINE config 5: the DiT's own defaults at seq 4096 (models/dit.py:43-50),
# batch 4; its attention shape is (4, 4, 4096, 64), non-causal
DIT_CFG = DiTConfig(seq_len=4096)
DIT_BATCH, DIT_STEPS, DIT_PARITY_LEN = 4, 5, 512
JVP_BENCH_SHAPE = (4, 16, 4096)  # bench.py:bench_jvp's (b, h, t), head_dim 64


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean device time of one `fn()` call in ms.

    `calls` calls are captured in one CUDA graph and the graph is replayed
    `replays` times between two CUDA events, so the span holds no host
    dispatch: at these sizes an eager loop of small launches measures the
    host's Python, not the card.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture (lazy library and allocator set-up)
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


def eager_ms(fn, calls: int = 20) -> float:
    """Mean time of one `fn()` from CUDA events around an eager loop of
    `calls` calls, after one warm-up call. For work of 0.1 ms and more per
    call, which the host enqueues faster than the card runs it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def visible_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs attention computes: causal keeps k <= q."""
    if not causal:
        return t * s
    n = min(t, s)
    return n * (n + 1) // 2 + (t - n) * s


def bound(n_bytes: float, *work: tuple[float, float]) -> dict:
    """The least time for `n_bytes` of traffic and the operations of `work`,
    given as (operations, peak rate of their type) pairs whose times add."""
    t_ops, t_bytes = sum(ops / peak for ops, peak in work), n_bytes / HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} visible, using {name}")
    return name, smi


def phase_build() -> None:
    secs = _build.build_all()
    log(f"[build] kernels + scheduler built/loaded in {secs:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


FLASH_CASES = [  # (b, h, h_kv, t, s, causal)
    (2, 16, 16, 256, 256, True),
    (2, 16, 4, 1000, 1000, True),
    (1, 4, 2, 77, 201, False),
]


def phase_flash(dev, gen) -> dict:
    worst = 0.0
    for b, h, h_kv, t, s, causal in FLASH_CASES:
        q = torch.randn((b, h, t, 64), generator=gen, device=dev)
        k = torch.randn((b, h_kv, s, 64), generator=gen, device=dev)
        v = torch.randn((b, h_kv, s, 64), generator=gen, device=dev)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=causal)
        err_o = (o - o_p).abs().max().item()
        err_l = (lse - lse_p).abs().max().item()
        log(f"[flash_fwd] b={b} h={h} h_kv={h_kv} t={t} s={s} causal={causal}: "
            f"max|dO|={err_o:.3e} (tol {FLASH_O_TOL}) max|dlse|={err_l:.3e} (tol {FLASH_LSE_TOL})")
        if not (err_o <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
            raise AssertionError("flash_fwd kernel disagrees with its plain version")
        worst = max(worst, err_o)
    # time at the serving prefill's shape: 8 prompts x 256 tokens, 16 heads
    q, k, v = (torch.randn((N_SLOTS, 16, PROMPT_LEN, 64), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    ms = device_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = device_ms(lambda: flash_attention_fwd_plain(q, k, v, causal=True))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    flops = 2 * 2 * N_SLOTS * 16 * visible_pairs(PROMPT_LEN, PROMPT_LEN, True) * 64
    bnd = bound(nbytes(q, k, v, o, lse), (flops, PEAK_BF16))
    log(f"[flash_fwd] (8,16,256,64) causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": lib_ms,
            "library_call": "F.scaled_dot_product_attention(is_causal=True), bf16"}


def _decode_case(dev, gen, n_q, n_kv, lengths, stale):
    b, max_len = len(lengths), BENCH_CFG.max_seq
    shape = (b, n_kv, max_len, 64)
    k_i8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    v_i8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    sk = torch.rand(shape[:3], generator=gen, device=dev) * 0.028 + 0.002
    sv = torch.rand(shape[:3], generator=gen, device=dev) * 0.028 + 0.002
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if stale:
        dead = torch.arange(max_len, device=dev)[None, None, :] >= length.long()[:, None, None]
        sk = torch.where(dead, torch.nan, sk)
        sv = torch.where(dead, torch.inf, sv)
    q = torch.randn((b, n_q, 64), generator=gen, device=dev)
    return q, QuantizedKVCache(k_i8, sk, v_i8, sv, length)


def phase_decode(dev, gen) -> dict:
    lengths = [0, 1, 127, 128, 1000, 1280, 300, 640]
    worst = 0.0
    for n_q, n_kv in ((16, 16), (16, 4)):
        q, cache = _decode_case(dev, gen, n_q, n_kv, lengths, stale=True)
        o, lse = decode_attention(q, cache, return_lse=True)
        torch.cuda.synchronize()
        o_p, lse_p = decode_attention_plain(q, cache, return_lse=True)
        live = cache.length > 0
        err_o = (o - o_p).abs().max().item()
        err_l = (lse[live] - lse_p[live]).abs().max().item()
        empty_ok = bool((o[~live] == 0).all() and torch.isneginf(lse[~live]).all())
        log(f"[decode] 8 slots, {n_q} q / {n_kv} kv heads, max_len {BENCH_CFG.max_seq}, "
            f"lengths {lengths}, non-finite stale scales: finite={bool(torch.isfinite(o).all())} "
            f"max|dO|={err_o:.3e} max|dlse|={err_l:.3e} (tol {DECODE_TOL}) empty_rows_ok={empty_ok}")
        if not (torch.isfinite(o).all() and err_o <= DECODE_TOL and err_l <= DECODE_TOL
                and empty_ok):
            raise AssertionError("decode kernel disagrees with its plain version")
        worst = max(worst, err_o)
    # time at the serving decode's shape: 8 slots x 16 heads, mid-generation
    length = PROMPT_LEN + NEW_TOKENS // 2
    q, cache = _decode_case(dev, gen, 16, 16, [length] * N_SLOTS, stale=False)
    ms = device_ms(lambda: decode_attention(q, cache))
    plain_ms = device_ms(lambda: decode_attention_plain(q, cache))
    o = decode_attention(q, cache)
    # the data needs each slot's K/V payloads and scales below its length only
    live_tokens = int(cache.length.sum()) * cache.k_i8.shape[1]
    kv_bytes = live_tokens * 2 * (64 * cache.k_i8.element_size() + cache.sk.element_size())
    flops = 2 * 2 * int(cache.length.sum()) * q.shape[1] * 64
    bnd = bound(kv_bytes + nbytes(q, o, cache.length), (flops, PEAK_BF16))
    log(f"[decode] 8 slots x 16 heads, length {length} of {BENCH_CFG.max_seq}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None}


def _serve(dev, smi, cfg, weight_quant=None) -> tuple[list, dict, float]:
    """One full-width serving run of `cfg` (bf16 params, `weight_quant`):
    a warm-up run, every launch count set to 0, the timed run. It must give
    every request its budget of in-vocab tokens, repeat the warm-up's tokens,
    match `generate` on the engine's own params and the same 8 prompts, and
    keep prefill logits within LOGITS_REL_TOL of the plain path on the CPU.
    Returns (each request's tokens, the timed run's launches by kernel, its
    tokens/s)."""
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                              torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=PROMPT_LEN).tolist() for _ in range(N_SLOTS)]
    eng = ServingEngine(params, cfg, dev, n_slots=N_SLOTS, scheduler="native",
                        param_dtype=torch.bfloat16, decode_horizon=HORIZON,
                        weight_quant=weight_quant)
    label = f"attention={cfg.attention} weight_quant={weight_quant}"

    def serve():
        rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return [out[r] for r in rids], time.perf_counter() - t0

    warm, _ = serve()
    _reset_counts()
    results, wall = serve()
    launches = _launch_counts()

    for r in results:
        if r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS:
            raise AssertionError(f"request {r.request_id}: {r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: token out of vocab")
    if [r.tokens for r in results] != [r.tokens for r in warm]:
        raise AssertionError(f"{label}: a second run gave different tokens")
    want = generate(eng.params, torch.tensor(prompts, device=dev), cfg, NEW_TOKENS)
    want = want[:, PROMPT_LEN:].tolist()
    same = sum(r.tokens == w for r, w in zip(results, want))
    if same != N_SLOTS:
        raise AssertionError(f"{label}: engine tokens equal generate's for only {same}/{N_SLOTS} "
                             "requests")

    # the full model on the card vs the plain path on the CPU, same weights
    probe = torch.tensor([prompts[0][:64]], device=dev)
    with torch.no_grad():
        logits = transformer_forward(eng.params, probe, cfg).float().cpu()
        ref = transformer_forward(_to(eng.params, "cpu"), probe.cpu(), cfg).float()
    rel = ((logits - ref).norm() / ref.norm()).item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[serve] {label}: prefill logits vs CPU plain path ({probe.shape[1]} tokens): rel L2 "
        f"{rel:.3e} (tol {LOGITS_REL_TOL}), argmax agreement {agree:.3f}")
    if not (torch.isfinite(logits).all() and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"{label}: prefill logits disagree with the plain CPU path")

    n_tok = sum(len(r.tokens) for r in results)
    ttft_ms = statistics.median(r.ttft_s for r in results) * 1e3
    led = eng.ledger()
    log(f"[serve] {label}: {N_SLOTS} requests x {NEW_TOKENS} tokens (prompt {PROMPT_LEN}, "
        f"horizon {HORIZON}) on {smi}: {n_tok / wall:.1f} tokens/s, wall {wall:.3f} s, median "
        f"TTFT {ttft_ms:.2f} ms, launches { {k: v for k, v in launches.items() if v} }, "
        f"dispatches {led['dispatches']}, fetch_s {led['fetch_s']:.3f}; tokens == generate "
        f"for {same}/{N_SLOTS}; repeat run identical")
    return [r.tokens for r in results], launches, n_tok / wall


def phase_serving(dev, smi) -> tuple[list, dict]:
    """Phase 5: bf16 serving through B1 (prefill) and B13 (decode) only."""
    tokens, launches, _ = _serve(dev, smi, BENCH_CFG)
    used = {k for k, v in launches.items() if v}
    if used != {"flash_fwd", "decode"}:
        raise AssertionError(f"the served run launched {launches}, want flash_fwd and decode only")
    return tokens, launches


def phase_serving_quantized(dev, smi, bf16_tokens, bf16_launches) -> dict:
    """Phase 16: the bench LM served with int8 attention, then with int8 and
    int4 weights, between two bf16 runs of phase 5's (the engine is
    host-bound, so its speed drifts over a process's life: each quantized
    run is compared with bf16 runs made beside it). Returns each quantized
    run's launches of the kernels it ran, by path."""
    n_layers = BENCH_CFG.n_layers
    per_pass = 6 * n_layers + 1  # projections and the unembedding of one forward
    runs, speed = {}, {}
    for path, cfg, wq in (("bf16_before", BENCH_CFG, None),
                          ("serve_int8", dataclasses.replace(BENCH_CFG, attention="int8"), None),
                          ("serve_w8", BENCH_CFG, "int8"), ("serve_w4", BENCH_CFG, "int4"),
                          ("bf16_after", BENCH_CFG, None)):
        tokens, launches, speed[path] = _serve(dev, smi, cfg, wq)
        used = {k for k, v in launches.items() if v}
        if path.startswith("bf16"):
            if tokens != bf16_tokens or launches != bf16_launches:
                raise AssertionError(f"{path}: the bf16 run differs from phase 5's")
            continue
        if path == "serve_int8":
            # prefill through B4 + B5, n_layers launches per prefill dispatch
            ok = (used == {"quant_int8", "int8_fwd", "decode"}
                  and launches["quant_int8"] == launches["int8_fwd"]
                  and launches["int8_fwd"] % n_layers == 0)
        else:
            kernel = "int8_linear" if wq == "int8" else "int4_linear"
            passes = (launches["flash_fwd"] + launches["decode"]) // n_layers
            ok = (used == {"flash_fwd", "decode", kernel}
                  and launches[kernel] == passes * per_pass)
        if not ok:
            raise AssertionError(f"{path}: launches {launches}")
        flat = [t for toks in tokens for t in toks]
        ref = [t for toks in bf16_tokens for t in toks]
        share = sum(a == b for a, b in zip(flat, ref)) / len(ref)
        log(f"[serve] {path}: {share:.3f} of the tokens equal the bf16 run's")
        runs[path] = {k: v for k, v in launches.items() if v}
    if bf16_launches["decode"] != runs["serve_w8"]["decode"]:
        raise AssertionError("the quantized runs decoded another number of steps")
    bf16 = (speed["bf16_before"] + speed["bf16_after"]) / 2
    log("[serve] tokens/s against the mean of the bf16 runs beside them ("
        f"{speed['bf16_before']:.1f}, {speed['bf16_after']:.1f}): "
        + ", ".join(f"{path} {speed[path] / bf16:.3f}" for path in runs))
    return runs


def _to(params, device):
    """A detached copy of an LM params dict on `device` (quantized weights
    move with their payloads and scales as they are)."""

    def move(v):
        return v.to(device) if isinstance(v, (QuantizedWeight, QuantizedWeight4)) \
            else v.detach().to(device)

    out = {k: move(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: move(v) for k, v in lay.items()} for lay in params["layers"]]
    return out


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

# The oracle envelope is held on per-head gradients (rep 1) at half a
# million elements a tensor, where a mismatch rate is stable (at 3e4
# elements, as in the JAX package's CPU test, one seed's count swings
# between 2 and 12), on the cross case (rep 2) and on GQA rep 4 with a
# ragged tile.
ORACLE_CASES = [(2, 16, 16, 256, 256, True), (2, 16, 16, 256, 256, False),
                (1, 4, 2, 77, 201, False), (2, 16, 4, 1000, 1000, True)]


def _qkvdo(gen, dev, b, h, h_kv, t, s):
    return (torch.randn((b, h, t, 64), generator=gen, device=dev),
            torch.randn((b, h_kv, s, 64), generator=gen, device=dev),
            torch.randn((b, h_kv, s, 64), generator=gen, device=dev),
            torch.randn((b, h, t, 64), generator=gen, device=dev))


# shapes the forward cases do not reach: a rep that does not divide 64, rep 64
# (one row per group in a dQ block), a single token, causal with t < s
BWD_EDGE_CASES = [(2, 6, 2, 33, 130, True), (1, 64, 1, 70, 70, True), (1, 3, 1, 1, 1, True)]


def _check_bwd(ops, label: str) -> dict:
    """B2 and B3 on `ops` against their plain versions, max|diff| /
    max|plain| per tensor within the mode's tolerance (raises otherwise).
    Returns each kernel's max|diff|."""
    tol = BWD_FAST_TOL if ops.fast else BWD_EXACT_TOL
    dk, dv = flash_bwd_dkv(ops)
    dq = flash_bwd_dq(ops)
    torch.cuda.synchronize()
    dk_p, dv_p = flash_bwd_dkv_plain(ops)
    dq_p = flash_bwd_dq_plain(ops)
    rel, err = {}, {"flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0}
    for name, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_bwd {name} is not finite")
        diff = (got - want).abs().max().item()
        rel[name] = diff / want.abs().max().item()
        kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        err[kernel] = max(err[kernel], diff)
    log(f"[flash_bwd] {label} {'fast' if ops.fast else 'exact'}: max|diff|/max|plain| dq "
        f"{rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol {tol})")
    if max(rel.values()) > tol:
        raise AssertionError("flash_bwd kernels disagree with their plain versions")
    return err


def _worst(*errs: dict) -> dict:
    return {k: max(e[k] for e in errs) for k in errs[0]}


def phase_flash_bwd(dev, gen) -> dict:
    errs = []
    for b, h, h_kv, t, s, causal in FLASH_CASES + BWD_EDGE_CASES:
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        for fast in (True, False):
            ops = bwd_operands(q, k, v, o, lse, do, causal=causal, fast=fast)
            errs.append(_check_bwd(ops, f"b={b} h={h} h_kv={h_kv} t={t} s={s} causal={causal}"))

    # autograd through flash_attention_bf16 vs the fp32 oracle: the JAX
    # package's envelope (atol 1e-2, mismatch rate <= 3.5e-4), whose atol is
    # per head. A GQA dk/dv sums rep heads' gradients, and in fast mode each
    # head's term carries its own bf16 rounding of P and dS, so fast dk/dv are
    # held at rep x atol; exact mode holds the per-head atol everywhere.
    for case in ORACLE_CASES:
        b, h, h_kv, t, s, causal = case
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s)
        want = reference_attention_vjp(q, k, v, do, causal=causal)
        for exact in (False, True):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            got = torch.autograd.grad(
                flash_attention_bf16(*leaves, causal=causal, bwd_exact=exact), leaves, do)
            kv_atol = ATOL if exact else ATOL * (h // h_kv)
            reps = [mismatch_report(n, g, w, atol) for n, g, w, atol
                    in zip(("dq", "dk", "dv"), got, want, (ATOL, kv_atol, kv_atol))]
            log(f"[flash_bwd] autograd vs fp32 oracle {case} bwd_exact={exact}: "
                + "; ".join(map(str, reps)))
            if max(r.mismatch_rate for r in reps) > GRAD_MISMATCH_RATE:
                raise AssertionError("flash_attention_bf16 gradients outside the envelope")
    return _worst(*errs)


def phase_train_timing(dev, gen) -> tuple[dict, dict]:
    """At the training shape, causal, f32 inputs as the model hands them in:
    B1, B2 and B3 (both modes) against their plain versions, then device
    time per call; bf16 for the library call. Returns (times and bounds,
    each kernel's max|diff| against its plain version)."""
    b, h, t, d = TRAIN_BATCH, 16, TRAIN_CFG.max_seq, 64
    q, k, v, do = _qkvdo(gen, dev, b, h, h, t, t)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=True)
    err_o = (o - o_p).abs().max().item()
    err_l = (lse - lse_p).abs().max().item()
    log(f"[flash_fwd] ({b},{h},{t},{d}) causal, f32 in: max|dO|={err_o:.3e} (tol {FLASH_O_TOL}) "
        f"max|dlse|={err_l:.3e} (tol {FLASH_LSE_TOL})")
    if not (err_o <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
        raise AssertionError("flash_fwd kernel disagrees with its plain version")
    del o_p, lse_p
    fast = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True)
    exact = bwd_operands(q, k, v, o, lse, do, causal=True, fast=False)
    label = f"({b},{h},{t},{d}) causal"
    errs = {"flash_fwd": err_o, **_worst(_check_bwd(fast, label), _check_bwd(exact, label))}
    dk, dv = flash_bwd_dkv(fast)
    dq = flash_bwd_dq(fast)
    pairs = b * h * visible_pairs(t, t, True)
    out = {
        "flash_fwd": {"ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
                      "plain_ms": device_ms(lambda: flash_attention_fwd_plain(q, k, v, True),
                                            calls=4, replays=5),
                      **bound(nbytes(q, k, v, o, lse), (2 * 2 * pairs * d, PEAK_BF16))},
        "flash_bwd_dkv": {
            "ms": device_ms(lambda: flash_bwd_dkv(fast)),
            "plain_ms": device_ms(lambda: flash_bwd_dkv_plain(fast), calls=4, replays=5),
            "exact_ms": device_ms(lambda: flash_bwd_dkv(exact), calls=4, replays=5),
            **bound(nbytes(*fast[:6], dk, dv), (4 * 2 * pairs * d, PEAK_BF16)),
            "exact_bound_ms": bound(nbytes(*exact[:6], dk, dv),
                                    (4 * 2 * pairs * d, PEAK_FP32))["bound_ms"]},
        "flash_bwd_dq": {
            "ms": device_ms(lambda: flash_bwd_dq(fast)),
            "plain_ms": device_ms(lambda: flash_bwd_dq_plain(fast), calls=4, replays=5),
            "exact_ms": device_ms(lambda: flash_bwd_dq(exact), calls=4, replays=5),
            **bound(nbytes(*fast[:6], dq), (3 * 2 * pairs * d, PEAK_BF16)),
            "exact_bound_ms": bound(nbytes(*exact[:6], dq),
                                    (3 * 2 * pairs * d, PEAK_FP32))["bound_ms"]},
    }
    # the library yardstick on bf16 inputs: forward by graph replays; the
    # backward alone as (forward + backward) - forward, both from CUDA events
    # around an eager loop
    qb, kb, vb = (x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    dob = do.to(torch.bfloat16)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qb, kb, vb, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qb, kb, vb, is_causal=True),
                            (qb, kb, vb), dob)

    def ours_fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.autograd.grad(flash_attention_bf16(*leaves, causal=True), leaves, do)

    sdpa_fwd_ms = device_ms(sdpa_fwd)
    sdpa_bwd_ms = eager_ms(sdpa_fwd_bwd) - eager_ms(sdpa_fwd)
    ours_fb_ms = eager_ms(ours_fwd_bwd)
    out["flash_fwd"]["library_ms"] = sdpa_fwd_ms
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        out[name]["library_ms"] = sdpa_bwd_ms
        out[name]["library_call"] = ("backward of F.scaled_dot_product_attention(is_causal="
                                     "True), bf16: dq, dk, dv together")
    for name, r in out.items():
        log(f"[timing] {name} at ({b},{h},{t},{d}) causal: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f", exact mode {r['exact_ms']:.4f} ms (bound {r['exact_bound_ms']:.4f} ms "
               "at the fp32 peak)" if "exact_ms" in r else ""))
    log(f"[timing] sdpa bf16 forward {sdpa_fwd_ms:.4f} ms, backward {sdpa_bwd_ms:.4f} ms; "
        f"flash_attention_bf16 forward + backward {ours_fb_ms:.4f} ms (eager, CUDA events)")
    out["flash_fwd"]["fwd_bwd_ms"] = ours_fb_ms
    return out, errs


def _grads(params, tokens, targets, cfg):
    """(loss, gradients in param_leaves order) on the tokens' device."""
    copy = _to(params, tokens.device)
    leaves = [x.requires_grad_(True) for x in param_leaves(copy)]
    loss = lm_loss(copy, tokens, targets, cfg)
    return loss.item(), torch.autograd.grad(loss, leaves)


# the wrappers a train step may launch, by attention kind
TRAIN_KERNELS = {"bf16": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
                 "int8": ("quant_int8", "int8_fwd", "int8_bwd_dkv", "int8_bwd_dq")}
_COUNTED = {"flash_fwd": flash_attention_fwd, "flash_bwd_dkv": flash_bwd_dkv,
            "flash_bwd_dq": flash_bwd_dq, "quant_int8": quant_int8,
            "int8_fwd": int8_attention_fwd_from_quantized, "int8_bwd_dkv": int8_bwd_dkv,
            "int8_bwd_dq": int8_bwd_dq, "decode": decode_attention,
            "int8_fused": int8_attention_fwd_fused, "int8_linear": int8_weight_matmul,
            "int4_linear": int4_weight_matmul, "flash_fwd_fp32": flash_attention_fwd_fp32,
            "jvp_fwd": attention_jvp_fwd, "jvp_tangent": attention_tangent_fwd,
            "jvp_bwd_dkv": jvp_bwd_dkv, "jvp_bwd_dq": jvp_bwd_dq}


def _launch_counts():
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _reset_counts():
    for fn in _COUNTED.values():
        fn.launches = 0


def _grad_norm(leaves):
    """Global L2 norm of the leaves' gradients (optax.global_norm), on device."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.grad) for t in leaves]))


def _train(cfg, params, tokens, targets, steps):
    """1 warm-up + `steps` timed steps; returns (losses, step ms, launches per
    step, the global gradient norm of every step). Each step must launch
    each kernel of its attention kind n_layers times and no other."""
    _, step = make_train_step(cfg, params)
    leaves = param_leaves(params)
    losses = [step(tokens, targets)]
    norms = [_grad_norm(leaves)]
    torch.cuda.synchronize()
    _reset_counts()
    per_step, times = [], []
    for _ in range(steps):
        before = _launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(tokens, targets))
        end.record()
        times.append((start, end))
        per_step.append({k: v - before[k] for k, v in _launch_counts().items()})
        norms.append(_grad_norm(leaves))
    torch.cuda.synchronize()
    losses = torch.stack(losses).tolist()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite and falling: {losses}")
    want = {k: cfg.n_layers if k in TRAIN_KERNELS[cfg.attention] else 0 for k in _COUNTED}
    if any(c != want for c in per_step):
        raise AssertionError(f"kernel launches per step {per_step}, want {want}")
    return losses, [s.elapsed_time(e) for s, e in times], per_step, torch.stack(norms).tolist()


def phase_train(dev, smi, cfg) -> tuple[dict, dict]:
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_seq))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)

    # gradient parity on one 256-token sequence: the card vs the CPU plain path
    tok, tgt = tokens[:1, :PARITY_LEN], targets[:1, :PARITY_LEN]
    loss_c, grads_c = _grads(params, tok, tgt, cfg)
    loss_p, grads_p = _grads(_to(params, "cpu"), tok.cpu(), tgt.cpu(), cfg)
    rels = [((g.cpu() - w).norm() / w.norm()).item() for g, w in zip(grads_c, grads_p)]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    log(f"[train] lm_loss on the card vs CPU plain path (1 x {PARITY_LEN} tokens): loss "
        f"{loss_c:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, tol {TRAIN_LOSS_REL}); grad rel L2 "
        f"max {max(rels):.3e} median {statistics.median(rels):.3e} over {len(rels)} tensors "
        f"(tol {TRAIN_GRAD_REL_L2})")
    if not (loss_rel <= TRAIN_LOSS_REL and max(rels) <= TRAIN_GRAD_REL_L2):
        raise AssertionError("lm_loss gradients on the card disagree with the CPU plain path")

    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, per_step, norms = _train(cfg, params, tokens, targets, TRAIN_STEPS)
    launches = {k: sum(c[k] for c in per_step) for k in TRAIN_KERNELS[cfg.attention]}
    med = statistics.median(step_ms)
    mem = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[train] {cfg.attention} attention, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, f32 params, {TRAIN_BATCH} x "
        f"{cfg.max_seq} tokens on {smi}: median step {med:.2f} ms (min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}; CUDA events), {tokens.numel() / med * 1e3:.0f} tokens/s, "
        f"max_memory_allocated {mem:.2f} GiB, launches {launches} over {TRAIN_STEPS} steps; "
        f"losses {[round(x, 4) for x in losses]}; grad norms {[round(x, 4) for x in norms]}")
    _profile_step(cfg, params, tokens, targets)
    return launches, {"median_ms": med, "max_memory_gib": mem, "grad_norms": norms}


def _profile_step(cfg, params, tokens, targets):
    """torch.profiler over one train step: device time by kernel, and busy share."""
    from torch.profiler import ProfilerActivity, profile

    _, step = make_train_step(cfg, params)
    step(tokens, targets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens, targets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] one train step: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{total_us / 1e3:.2f} ms ({total_us / 1e3 / wall_ms:.1%} of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d} calls  "
            f"{e.self_device_time_total / total_us:6.1%}  {e.key[:90]}")


def phase_train_gqa(dev, cfg) -> dict:
    """Returns the launches of each of the run's attention kernels over its
    timed steps."""
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (GQA_BATCH, cfg.max_seq))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    losses, step_ms, per_step, _ = _train(cfg, params, tokens, targets, TRAIN_STEPS)
    launches = {k: sum(c[k] for c in per_step) for k in TRAIN_KERNELS[cfg.attention]}
    # attention is GQA-native (k/v keep their kv heads), so each dK/dV launch
    # that _train counted sums a group of n_heads // n_kv_heads q heads
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep != 2:
        raise AssertionError(f"the dK/dV kernel runs with rep {rep} at the GQA config, want 2")
    log(f"[train_gqa] {cfg.attention} attention, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads, "
        f"d_model {cfg.d_model}, {GQA_BATCH} x {cfg.max_seq} tokens: {TRAIN_STEPS} steps, median "
        f"{statistics.median(step_ms):.2f} ms, dK/dV kernel rep {rep}, launches {launches}; "
        f"losses {[round(x, 4) for x in losses]}")
    return launches


# --------------------------------------------------------------------------
# The int8 (SageAttention) path
# --------------------------------------------------------------------------

INT8_TRAIN_CFG = dataclasses.replace(TRAIN_CFG, attention="int8")
INT8_GQA_CFG = dataclasses.replace(GQA_CFG, attention="int8")

# (b, h, h_kv, t, s, causal, K offset): the training shape; a ragged length
# whose padded K rows, smoothed to -k_mean, set the last K grain's scale (a
# large K mean makes that visible); GQA rep 4, where the Q grain is 512; the
# GQA train phase's attention shape (rep 2, grains 512); the int8 serving
# run's prefill (all 8 prompts in one dispatch, grains 256); an odd cross
# length, non-causal (grains 128 and 256); then the backward's edge shapes: a
# rep that does not divide 64 with t < s, and one token.
INT8_CASES = [(4, 16, 16, 2048, 2048, True, 0.0), (2, 16, 16, 1000, 1000, True, 4.0),
              (2, 16, 4, 2048, 2048, True, 0.0),
              (GQA_BATCH, GQA_CFG.n_heads, GQA_CFG.n_kv_heads, GQA_CFG.max_seq, GQA_CFG.max_seq,
               True, 0.0),
              (N_SLOTS, BENCH_CFG.n_heads, BENCH_CFG.n_kv_heads, PROMPT_LEN, PROMPT_LEN, True, 0.0),
              (1, 4, 2, 77, 201, False, 4.0), (2, 6, 2, 33, 130, True, 4.0),
              (1, 3, 1, 1, 1, True, 0.0)]


def _check_int8(q, k, v, do, causal, label) -> dict:
    """B4 (byte for byte), B5, B7 and B8 against their plain versions on one
    case, raising outside the tolerances; returns each kernel's max|diff|."""
    k_mean = k.mean(dim=-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    torch.cuda.synchronize()
    res_p = quantize_qkv_plain(q, k, v, k_sub=k_mean)
    if not all(torch.equal(a, b) for pair, pair_p in zip(res, res_p) for a, b in zip(pair, pair_p)):
        raise AssertionError(f"quant_int8 is not byte-equal to its plain version at {label}")
    dims = (*q.shape[:3], k.shape[2], q.shape[3])
    o, lse = int8_attention_fwd_from_quantized(res, dims, causal=causal)
    torch.cuda.synchronize()
    o_p, lse_p = int8_attention_fwd_from_quantized_plain(res, dims, causal=causal)
    err = {"quant_int8": 0.0, "int8_fwd": (o - o_p).abs().max().item()}
    err_l = (lse - lse_p).abs().max().item()
    del o_p, lse_p
    ops = int8_bwd_operands(res, k_mean, o, lse, do, dims, causal=causal)
    dk, dv = int8_bwd_dkv(ops)
    dq = int8_bwd_dq(ops)
    torch.cuda.synchronize()
    dk_p, dv_p = int8_bwd_dkv_plain(ops)
    dq_p = int8_bwd_dq_plain(ops)
    rel = {}
    for name, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"int8 backward {name} is not finite at {label}")
        diff = (got - want).abs().max().item()
        rel[name] = diff / want.abs().max().item()
        kernel = "int8_bwd_dq" if name == "dq" else "int8_bwd_dkv"
        err[kernel] = max(err.get(kernel, 0.0), diff)
    log(f"[int8] {label}: quant_int8 byte-equal; int8_fwd max|dO|={err['int8_fwd']:.3e} (tol "
        f"{FLASH_O_TOL}) max|dlse|={err_l:.3e} (tol {FLASH_LSE_TOL}); backward max|diff|/"
        f"max|plain| dq {rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol {INT8_BWD_TOL})")
    if not (err["int8_fwd"] <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
        raise AssertionError("int8_fwd kernel disagrees with its plain version")
    if max(rel.values()) > INT8_BWD_TOL:
        raise AssertionError("int8 backward kernels disagree with their plain versions")
    if k_mean.abs().max().item() > 1.0:
        _check_k_mean_term(ops, label)
    return err


def _check_k_mean_term(ops, label) -> None:
    """B8's K-smoothing term rowsum(dS)·k_mean on its own. With D = rowsum(dO·O)
    the rowsum of dS cancels to ~0, so the term hides in the dQ check above;
    halving D makes it rowsum(P·dP)/2·sm_scale per row. B8 must then still
    match its plain version, and the term must be large enough that a kernel
    without it would not."""
    ops = ops._replace(di=ops.di * 0.5)
    dq = int8_bwd_dq(ops)
    torch.cuda.synchronize()
    dq_p = int8_bwd_dq_plain(ops)
    term = int8_bwd_dq_plain(ops._replace(k_mean=torch.zeros_like(ops.k_mean))) - dq_p
    scale = dq_p.abs().max().item()
    rel, rel_term = (dq - dq_p).abs().max().item() / scale, term.abs().max().item() / scale
    log(f"[int8] {label}, D halved: dq max|diff|/max|plain| {rel:.3e} (tol {INT8_BWD_TOL}); "
        f"k_mean term max|term|/max|plain| {rel_term:.3e} (want > {10 * INT8_BWD_TOL})")
    if not (rel <= INT8_BWD_TOL and rel_term > 10 * INT8_BWD_TOL):
        raise AssertionError("int8_bwd_dq's K-smoothing term disagrees with its plain version")


def phase_int8_kernels(dev, gen) -> dict:
    errs = []
    for b, h, h_kv, t, s, causal, shift in INT8_CASES:
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s)
        errs.append(_check_int8(q, k + shift, v, do, causal, f"b={b} h={h} h_kv={h_kv} t={t} "
                                f"s={s} causal={causal} K mean {shift}"))
    return _worst(*errs)


def phase_int8_timing(dev, gen, sdpa: dict) -> dict:
    """Device time per call of B4, B5, B7 and B8 at the training shape,
    causal, beside their plain versions and their bounds. No single PyTorch
    call computes int8 attention; SDPA's bf16 times ride along for scale."""
    b, h, t, d = TRAIN_BATCH, 16, TRAIN_CFG.max_seq, 64
    q, k, v, do = _qkvdo(gen, dev, b, h, h, t, t)
    k_mean = k.mean(dim=-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    dims = (b, h, t, t, d)
    o, lse = int8_attention_fwd_from_quantized(res, dims, causal=True)
    ops = int8_bwd_operands(res, k_mean, o, lse, do, dims, causal=True)
    dk, dv = int8_bwd_dkv(ops)
    dq = int8_bwd_dq(ops)
    prod = 2 * b * h * visible_pairs(t, t, True) * d  # one product over the visible pairs
    payload = nbytes(*(x for pair in res for x in pair))
    rows_in = nbytes(ops.do, ops.lse, ops.di)

    def plain_ms(fn):
        return device_ms(fn, calls=4, replays=5)

    out = {
        "quant_int8": {
            "ms": device_ms(lambda: quantize_qkv(q, k, v, k_sub=k_mean)),
            "plain_ms": plain_ms(lambda: quantize_qkv_plain(q, k, v, k_sub=k_mean)),
            **bound(nbytes(q, k, v, k_mean) + payload, (2 * (q.numel() + 2 * k.numel()), PEAK_FP32))},
        "int8_fwd": {
            "ms": device_ms(lambda: int8_attention_fwd_from_quantized(res, dims, causal=True)),
            "plain_ms": plain_ms(lambda: int8_attention_fwd_from_quantized_plain(res, dims, True)),
            **bound(payload + nbytes(o, lse), (prod, PEAK_INT8), (prod, PEAK_BF16)),
            "sdpa_bf16_ms": sdpa["fwd"]},
        "int8_bwd_dkv": {
            "ms": device_ms(lambda: int8_bwd_dkv(ops)),
            "plain_ms": plain_ms(lambda: int8_bwd_dkv_plain(ops)),
            **bound(payload + rows_in + nbytes(dk, dv), (prod, PEAK_INT8), (3 * prod, PEAK_BF16)),
            "sdpa_bf16_ms": sdpa["bwd"]},
        "int8_bwd_dq": {
            "ms": device_ms(lambda: int8_bwd_dq(ops)),
            "plain_ms": plain_ms(lambda: int8_bwd_dq_plain(ops)),
            **bound(payload + rows_in + nbytes(ops.k_mean, dq), (prod, PEAK_INT8),
                    (2 * prod, PEAK_BF16)),
            "sdpa_bf16_ms": sdpa["bwd"]},
    }

    def fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.autograd.grad(sage_attention_int8(*leaves, causal=True), leaves, do)

    fb_ms = eager_ms(fwd_bwd)
    for name, r in out.items():
        r["library_ms"] = None
        log(f"[timing] {name} at ({b},{h},{t},{d}) causal: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"[timing] sage_attention_int8 forward + backward {fb_ms:.4f} ms (eager, CUDA events); "
        f"sdpa bf16 forward {sdpa['fwd']:.4f} ms, backward {sdpa['bwd']:.4f} ms")
    out["int8_fwd"]["fwd_bwd_ms"] = fb_ms
    return out


def phase_int8_oracle(dev, gen) -> None:
    """sage_attention_int8 at the training shape against the fp32 oracle, by
    the JAX package's own criteria (tests/test_int8_attention.py)."""
    b, h, t, d = TRAIN_BATCH, 16, TRAIN_CFG.max_seq, 64
    q, k, v, do = _qkvdo(gen, dev, b, h, h, t, t)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = sage_attention_int8(*leaves, causal=True)
    got = torch.autograd.grad(o, leaves, do)
    fwd = mismatch_report("int8 fwd", o.detach(), reference_attention(q, k, v, causal=True),
                          INT8_ATOL)
    want = reference_attention_vjp(q, k, v, do, causal=True)
    rels = {n: ((g - w).norm() / w.norm()).item() for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    # tiny magnitudes: the dequant scale c is ~1e-9, and the mask sentinel
    # 30000 / -c must still keep the future out
    qs, ks = q * 0.01, k * 0.01
    tiny = mismatch_report("tiny-scale causal int8", int8_attention_fwd(qs, ks, v, causal=True)[0],
                           reference_attention(qs, ks, v, causal=True), INT8_ATOL)
    # a large common K component: K-smoothing must beat the raw int8 path
    k6 = k + 6.0
    want6 = reference_attention(q, k6, v)
    mse_s = (sage_attention_int8(q, k6, v) - want6).square().mean().item()
    mse_r = (int8_attention_fwd(q, k6, v)[0] - want6).square().mean().item()
    log(f"[int8] sage_attention_int8 vs fp32 oracle ({b},{h},{t},{d}) causal: {fwd}; grad rel L2 "
        + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
        + f" (tol {INT8_GRAD_REL_L2}); {tiny}; K + 6 non-causal: MSE smoothed {mse_s:.3e} vs raw "
        f"{mse_r:.3e}")
    if not (fwd.mismatch_rate <= INT8_FWD_RATE and tiny.mismatch_rate <= INT8_FWD_RATE
            and max(rels.values()) <= INT8_GRAD_REL_L2 and mse_s < mse_r):
        raise AssertionError("sage_attention_int8 outside the JAX package's oracle criteria")


# --------------------------------------------------------------------------
# Int8 inference (B6) and weight-only quantization (B17, B18)
# --------------------------------------------------------------------------

# (b, h, h_kv, t, s, causal, K offset, dtype): BASELINE config 3's shape in
# bf16 (the serving dtype) and f32; a ragged length whose padded K rows,
# smoothed to -k_mean, set the last K grain's scale; GQA rep 4 (Q grain 512);
# an odd cross length, non-causal; rep 3 with t < s; one token.
FUSED_CASES = [(4, 16, 16, 2048, 2048, True, 0.0, torch.bfloat16),
               (4, 16, 16, 2048, 2048, True, 0.0, torch.float32),
               (2, 16, 16, 1000, 1000, True, 4.0, torch.bfloat16),
               (4, 16, 4, 1024, 1024, True, 0.0, torch.bfloat16),
               (1, 4, 2, 77, 201, False, 4.0, torch.float32),
               (2, 6, 2, 33, 130, True, 4.0, torch.float32),
               (1, 3, 1, 1, 1, True, 0.0, torch.float32)]
CONFIG3_SEQS = (2048, 4096, 8192)


def _qkv(gen, dev, b, h, h_kv, t, s, dtype=torch.float32, shift=0.0):
    q = torch.randn((b, h, t, 64), generator=gen, device=dev)
    k = torch.randn((b, h_kv, s, 64), generator=gen, device=dev) + shift
    v = torch.randn((b, h_kv, s, 64), generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _check_fused(q, k, v, causal, label, plain=True) -> float:
    """B6 on one case, with the K shift the inference entry point takes (the
    K mean in k's dtype): against B4 then B5 on the same inputs (lse equal,
    O within FUSED_O_TOL) and, where it fits in memory, against its plain
    version (B5's tolerances). Returns max|dO| against the plain version."""
    k_sub = k.float().mean(-2, keepdim=True).to(k.dtype)
    o, lse = int8_attention_fwd_fused(q, k, v, causal=causal, k_sub=k_sub)
    res = quantize_qkv(q, k, v, k_sub=k_sub)
    o_m, lse_m = int8_attention_fwd_from_quantized(res, (*q.shape[:3], k.shape[2], 64), causal)
    torch.cuda.synchronize()
    d_o, d_l = (o - o_m).abs().max().item(), (lse - lse_m).abs().max().item()
    del res, o_m, lse_m
    msg = (f"[int8_fused] {label}: vs B4 -> B5 max|dO|={d_o:.3e} (tol {FUSED_O_TOL}) "
           f"max|dlse|={d_l:.3e} (want 0)")
    if not (torch.isfinite(o).all() and d_o <= FUSED_O_TOL and d_l == 0.0):
        raise AssertionError(msg + ": B6 disagrees with B4 then B5")
    err = 0.0
    if plain:
        o_p, lse_p = int8_attention_fwd_fused_plain(q, k, v, causal, k_sub=k_sub)
        err, err_l = (o - o_p).abs().max().item(), (lse - lse_p).abs().max().item()
        msg += (f"; vs plain max|dO|={err:.3e} (tol {FLASH_O_TOL}) max|dlse|={err_l:.3e} "
                f"(tol {FLASH_LSE_TOL})")
        if not (err <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
            raise AssertionError(msg + ": B6 disagrees with its plain version")
    log(msg)
    return err


def phase_int8_fused(dev, gen) -> float:
    """Phase 12. Returns B6's worst max|dO| against its plain version."""
    worst = 0.0
    for b, h, h_kv, t, s, causal, shift, dtype in FUSED_CASES:
        q, k, v = _qkv(gen, dev, b, h, h_kv, t, s, dtype, shift)
        worst = max(worst, _check_fused(q, k, v, causal, f"b={b} h={h} h_kv={h_kv} t={t} s={s} "
                                        f"causal={causal} K mean {shift} {dtype}"))
    # the plain version of (4,16,8192,64) would need tens of GB: B4 -> B5 only
    for t in CONFIG3_SEQS[1:]:
        q, k, v = _qkv(gen, dev, 4, 16, 16, t, t, torch.bfloat16)
        _check_fused(q, k, v, True, f"(4,16,{t},64) causal bf16", plain=False)
    return worst


def phase_int8_infer_oracle(dev, gen) -> None:
    """Phase 13: sage_attention_int8_inference against the fp32 oracle with
    bench.py's gate (f32 inputs), and with a common K offset of 8."""
    b, h, t = 4, 16, CONFIG3_SEQS[0]
    q, k, v = _qkv(gen, dev, b, h, h, t, t)
    rep = mismatch_report("int8 inference fwd", sage_attention_int8_inference(q, k, v, True),
                          reference_attention(q, k, v, causal=True), INT8_ATOL)
    k8 = k + 8.0
    rep8 = mismatch_report("int8 inference fwd, K + 8", sage_attention_int8_inference(q, k8, v),
                           reference_attention(q, k8, v), INT8_ATOL)
    log(f"[int8_fused] sage_attention_int8_inference vs fp32 oracle ({b},{h},{t},64) causal: "
        f"{rep}; non-causal {rep8} (gate: rate <= {INT8_FWD_RATE} at atol {INT8_ATOL})")
    if not (rep.mismatch_rate <= INT8_FWD_RATE and rep8.mismatch_rate <= INT8_FWD_RATE):
        raise AssertionError("sage_attention_int8_inference outside bench.py's gate")


def phase_int8_infer_timing(dev, gen) -> tuple[dict, dict]:
    """Phase 14, BASELINE config 3. The path run: sage_attention_int8_inference
    once at each sequence length on bf16 inputs, counts from 0. Then device
    time per call of B6 (with the K shift precomputed), SDPA bf16, B4 -> B5
    (`int8_attention_fwd`, which also casts to f32) and B1 on the same
    inputs. Returns (B6's numbers at (4,16,2048,64), the path's launches)."""
    inputs = {t: _qkv(gen, dev, 4, 16, 16, t, t, torch.bfloat16) for t in CONFIG3_SEQS}
    _reset_counts()
    for t, (q, k, v) in inputs.items():
        o = sage_attention_int8_inference(q, k, v, causal=True)
        if o.shape != q.shape or not torch.isfinite(o).all():
            raise AssertionError(f"sage_attention_int8_inference at {t} tokens: not finite")
    launches = _launch_counts()
    if {k for k, n in launches.items() if n} != {"int8_fused"}:
        raise AssertionError(f"the inference path launched {launches}, want int8_fused only")

    def plain_ms(fn):
        return device_ms(fn, calls=4, replays=5)

    rows, out = {}, None
    for t, (q, k, v) in inputs.items():
        k_sub = k.float().mean(-2, keepdim=True).to(k.dtype)
        o, lse = int8_attention_fwd_fused(q, k, v, causal=True, k_sub=k_sub)
        pairs = 4 * 16 * visible_pairs(t, t, True)
        flops = 4 * 4 * 16 * t * t * 64 * 0.5  # bench.py's count
        r = {"ms": device_ms(lambda: int8_attention_fwd_fused(q, k, v, True, k_sub=k_sub)),
             "entry_ms": device_ms(lambda: sage_attention_int8_inference(q, k, v, True)),
             "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
             "b4_b5_ms": device_ms(lambda: int8_attention_fwd(q, k, v, True, k_sub=k_sub)),
             "b1_ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
             **bound(nbytes(q, k, v, k_sub, o, lse), (2 * pairs * 64, PEAK_INT8),
                     (2 * pairs * 64, PEAK_BF16), (2 * (q.numel() + 2 * k.numel()), PEAK_FP32))}
        r["tflops"] = {name: flops / (r[key] * 1e-3) / 1e12 for name, key in (
            ("int8_fused", "ms"), ("sdpa", "sdpa_ms"), ("b4_b5", "b4_b5_ms"), ("b1", "b1_ms"))}
        if t == CONFIG3_SEQS[0]:
            r["plain_ms"] = plain_ms(lambda: int8_attention_fwd_fused_plain(q, k, v, True,
                                                                           k_sub=k_sub))
            out = r
        rows[t] = r
        log(f"[timing] config 3 (4,16,{t},64) causal bf16: B6 {r['ms']:.4f} ms "
            f"({r['tflops']['int8_fused']:.1f} TFLOP/s; entry point {r['entry_ms']:.4f} ms), "
            f"sdpa {r['sdpa_ms']:.4f} ms ({r['tflops']['sdpa']:.1f}), B4 -> B5 "
            f"{r['b4_b5_ms']:.4f} ms ({r['tflops']['b4_b5']:.1f}), B1 {r['b1_ms']:.4f} ms "
            f"({r['tflops']['b1']:.1f}); bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f"; B6 plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else ""))
    del inputs
    # the GQA A/B shape (bench.py:250)
    t = CONFIG3_SEQS[1]
    q, k, v = _qkv(gen, dev, 4, 16, 4, t, t, torch.bfloat16)
    k_sub = k.float().mean(-2, keepdim=True).to(k.dtype)
    gqa = {"ms": device_ms(lambda: int8_attention_fwd_fused(q, k, v, True, k_sub=k_sub)),
           "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)),
           "b4_b5_ms": device_ms(lambda: int8_attention_fwd(q, k, v, True, k_sub=k_sub)),
           "b1_ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=True))}
    log(f"[timing] GQA (4,16q/4kv,{t},64) causal bf16: B6 {gqa['ms']:.4f} ms, sdpa "
        f"{gqa['sdpa_ms']:.4f} ms, B4 -> B5 {gqa['b4_b5_ms']:.4f} ms, B1 {gqa['b1_ms']:.4f} ms")
    out.update(library_ms=out["sdpa_ms"],
               library_call="F.scaled_dot_product_attention(is_causal=True), bf16",
               by_seq={str(t): {k: v for k, v in r.items() if k != "bound_by"}
                       for t, r in rows.items()},
               gqa=gqa)
    return out, launches


# (m, k, n): decode (the engine's 8 slots) and prefill (8 x 256 tokens) rows
# against the bench widths' weights, and an odd shape
WEIGHT_SHAPES = [(m, k, n) for m in (N_SLOTS, N_SLOTS * PROMPT_LEN)
                 for k, n in ((1024, 1024), (1024, 4096), (4096, 1024), (1024, 8192))]
WEIGHT_ODD = (5, 1000, 300)
WEIGHT_HEADLINE = (N_SLOTS, 1024, 4096)  # decode through w1


def _check_weight(name, fn, plain, label) -> float:
    """A weight kernel against its plain version: the f32 output within
    WEIGHT_F32_REL of max|plain|, the bf16 output within one bf16 ulp plus
    that. Returns the f32 output's max|diff|."""
    got, want = fn(torch.float32), plain(torch.float32)
    got_b, want_b = fn(None).float(), plain(None).float()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ulp = torch.exp2(torch.floor(torch.log2(want_b.abs().clamp_min(1e-30))) - 7)
    over = ((got_b - want_b).abs() - ulp).max().item()
    bf16_ok = over <= WEIGHT_F32_REL * scale
    log(f"[{name}] {label}: f32 out max|diff|/max|plain| {err / scale:.3e} (tol {WEIGHT_F32_REL}); "
        f"bf16 out max(|diff| - ulp)/max|plain| {max(over, 0.0) / scale:.3e} "
        f"(tol {WEIGHT_F32_REL})")
    rel = err / scale
    if not (torch.isfinite(got).all() and rel <= WEIGHT_F32_REL and bf16_ok):
        raise AssertionError(f"{name} disagrees with its plain version at {label}")
    return err


def phase_weight_kernels(dev, gen) -> dict:
    """Phase 15: B17 and B18 against their plain versions, then timed beside
    torch.matmul of the bf16 weight they replace (a yardstick only). Returns
    each kernel's numbers at WEIGHT_HEADLINE with every shape's by shape."""
    out = {"int8_linear": {"max_abs_err": 0.0, "by_shape": {}},
           "int4_linear": {"max_abs_err": 0.0, "by_shape": {}}}
    for m, k, n in WEIGHT_SHAPES + [WEIGHT_ODD]:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        q8, q4 = quantize_weight(w), quantize_weight_int4(w)
        x4 = F.pad(x, (0, 2 * q4.packed.shape[0] - k))  # mm's padded contraction
        label = f"m={m} k={k} n={n}"
        e8 = _check_weight("int8_linear",
                           lambda dt: int8_weight_matmul(x, q8.w_i8, q8.scale, out_dtype=dt),
                           lambda dt: int8_weight_matmul_plain(x, q8.w_i8, q8.scale, dt), label)
        e4 = _check_weight(
            "int4_linear",
            lambda dt: int4_weight_matmul(x4, q4.packed, q4.scale, q4.group, out_dtype=dt),
            lambda dt: int4_weight_matmul_plain(x4, q4.packed, q4.scale, q4.group, dt), label)
        out["int8_linear"]["max_abs_err"] = max(out["int8_linear"]["max_abs_err"], e8)
        out["int4_linear"]["max_abs_err"] = max(out["int4_linear"]["max_abs_err"], e4)
        if (m, k, n) == WEIGHT_ODD:
            continue
        wb = w.to(torch.bfloat16)
        lib_ms = device_ms(lambda: torch.matmul(x, wb))
        y = torch.matmul(x, wb)
        for name, fn, plain, w_bytes in (
                ("int8_linear", lambda: int8_weight_matmul(x, q8.w_i8, q8.scale),
                 lambda: int8_weight_matmul_plain(x, q8.w_i8, q8.scale), nbytes(q8.w_i8, q8.scale)),
                ("int4_linear", lambda: int4_weight_matmul(x4, q4.packed, q4.scale, q4.group),
                 lambda: int4_weight_matmul_plain(x4, q4.packed, q4.scale, q4.group),
                 nbytes(q4.packed, q4.scale))):
            r = {"ms": device_ms(fn), "plain_ms": device_ms(plain, calls=4, replays=5),
                 "library_ms": lib_ms,
                 **bound(nbytes(x, y) + w_bytes, (2 * m * k * n, PEAK_BF16))}
            out[name]["by_shape"][label] = r
            log(f"[timing] {name} {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bf16 torch.matmul {lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    head = "m={} k={} n={}".format(*WEIGHT_HEADLINE)
    for name in out:
        out[name].update(out[name]["by_shape"][head])
        out[name]["library_call"] = "torch.matmul(x, w) with the weight in bf16"
        out[name]["headline_shape"] = head
    return out

# --------------------------------------------------------------------------
# The JVP family (B1 fp32, B9-B12) and the rCM DiT step
# --------------------------------------------------------------------------

JVP_KERNELS = ("flash_fwd_fp32", "jvp_fwd", "jvp_tangent", "jvp_bwd_dkv", "jvp_bwd_dq")
# (b, h, t, s, causal): a square pair; the DiT's attention shape (the rCM
# step's); odd cross lengths; a ragged t < s; one token
JVP_CASES = [(2, 4, 1024, 1024, True), (2, 4, 1024, 1024, False),
             (DIT_BATCH, DIT_CFG.n_heads, DIT_CFG.seq_len, DIT_CFG.seq_len, False),
             (1, 4, 77, 201, True), (1, 4, 77, 201, False), (1, 3, 33, 130, True),
             (1, 3, 33, 130, False), (1, 2, 1, 1, True)]


def _jvp_inputs(gen, dev, b, h, t, s):
    """q, k, v, tq, tk, tv, do, dto: unit normal f32."""
    q, tq, do, dto = (torch.randn((b, h, t, 64), generator=gen, device=dev) for _ in range(4))
    k, v, tk, tv = (torch.randn((b, h, s, 64), generator=gen, device=dev) for _ in range(4))
    return q, k, v, tq, tk, tv, do, dto


def _check_jvp(q, k, v, tq, tk, tv, do, dto, causal, label) -> dict:
    """B1 fp32 and B9-B12 in both modes against their plain versions on one
    case, by max|diff| / max|plain| per tensor (lse, and the gradients that
    vanish at one key: max|diff|), raising outside the tolerances. Returns
    each kernel's max|diff|."""
    err, msgs = dict.fromkeys(JVP_KERNELS, 0.0), []
    absolute = {"lse"} | ({"dk", "dtk", "dq", "dtq"} if k.shape[2] == 1 else set())

    def hold(kernel, mode, tol, names, got, want):
        torch.cuda.synchronize()
        rel = {}
        for name, g, w in zip(names, got, want):
            diff = (g - w).abs().max().item()
            err[kernel] = max(err[kernel], diff)
            rel[name] = diff if name in absolute else diff / w.abs().max().item()
            if not torch.isfinite(g).all():
                raise AssertionError(f"[jvp] {label}: {kernel} {mode} {name} is not finite")
        msgs.append(f"{kernel} {mode} " + " ".join(f"{n} {x:.2e}" for n, x in rel.items()))
        if max(rel.values()) > tol:
            raise AssertionError(f"[jvp] {label}: {msgs[-1]} (tol {tol}): the kernel disagrees "
                                 "with its plain version")

    hold("flash_fwd_fp32", "fp32", JVP_EXACT_TOL, ("o", "lse"),
         flash_attention_fwd_fp32(q, k, v, causal=causal),
         flash_attention_fwd_plain(q, k, v, causal=causal, precision="fp32"))
    for fast in (False, True):
        mode, tol = ("fast", BWD_FAST_TOL) if fast else ("exact", JVP_EXACT_TOL)
        fwd = attention_jvp_fwd(q, k, v, tq, tk, tv, causal=causal, fast=fast)
        hold("jvp_fwd", mode, JVP_FWD_FAST_TOL if fast else JVP_EXACT_TOL,
             ("o", "to", "lse", "mu"), fwd,
             attention_jvp_fwd_plain(q, k, v, tq, tk, tv, causal=causal, fast=fast))
        o, to, lse, mu = fwd  # the kernel's residuals, as the entry points hand them on
        hold("jvp_tangent", mode, tol, ("to",),
             [attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv, causal=causal, fast=fast)],
             [attention_tangent_fwd_plain(q, k, v, o, lse, tq, tk, tv, causal=causal, fast=fast)])
        ops = jvp_bwd_operands(q, k, v, tq, tk, tv, o, to, lse, mu, do, dto, causal=causal,
                               fast=fast)
        hold("jvp_bwd_dkv", mode, tol, ("dk", "dv", "dtk", "dtv"), jvp_bwd_dkv(ops),
             jvp_bwd_dkv_plain(ops))
        hold("jvp_bwd_dq", mode, tol, ("dq", "dtq"), jvp_bwd_dq(ops), jvp_bwd_dq_plain(ops))
    log(f"[jvp] {label} (tol exact {JVP_EXACT_TOL}, fast B9 {JVP_FWD_FAST_TOL}, fast B10-B12 "
        f"{BWD_FAST_TOL}): " + "; ".join(msgs))
    return err


def phase_jvp_kernels(dev, gen) -> dict:
    """Phase 17. Returns each kernel's worst max|diff| against its plain version."""
    errs = []
    for b, h, t, s, causal in JVP_CASES:
        errs.append(_check_jvp(*_jvp_inputs(gen, dev, b, h, t, s), causal,
                               f"b={b} h={h} t={t} s={s} causal={causal}"))
    # B1's fp32 mode is GQA-native, as its bf16 mode: rep 4, a ragged length
    q, k, v, _ = _qkvdo(gen, dev, 2, 8, 2, 300, 300)
    o, lse = flash_attention_fwd_fp32(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=True, precision="fp32")
    err_o = (o - o_p).abs().max().item()
    err_l = (lse - lse_p).abs().max().item()
    rel_o = err_o / o_p.abs().max().item()
    log(f"[jvp] flash_fwd_fp32 GQA (2,8q/2kv,300,64) causal: max|dO|/max|plain| {rel_o:.2e}, "
        f"max|dlse| {err_l:.2e} (tol {JVP_EXACT_TOL})")
    if max(rel_o, err_l) > JVP_EXACT_TOL:
        raise AssertionError("flash_fwd_fp32 disagrees with its plain version under GQA")
    errs.append({**dict.fromkeys(JVP_KERNELS, 0.0), "flash_fwd_fp32": err_o})
    return _worst(*errs)


def _jvp_launches() -> dict:
    counts = _launch_counts()
    return {k: counts[k] for k in (*JVP_KERNELS, "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd")}


def _within(got, want, tol) -> tuple[bool, float]:
    """|got - want| <= tol + tol |want| everywhere (rtol = atol = tol), and max|diff|."""
    diff = (got - want).abs()
    return bool((diff <= tol + tol * want.abs()).all()), diff.max().item()


def phase_jvp_oracle(dev, gen) -> dict:
    """Phase 18, BASELINE config 5's gate and the JVP family's AD against the
    fp32 oracle. The path run: every launch count from 0; returns the JVP
    kernels' (and B2/B3's) launches over the phase."""
    _reset_counts()
    b, h, t = 1, 2, DIT_CFG.seq_len
    q, k, v, tq, tk, tv, _, _ = _jvp_inputs(gen, dev, b, h, t, t)
    o_w, to_w = reference_attention_jvp((q, k, v), (tq, tk, tv))
    o, to = attention_value_and_jvp(q, k, v, tq, tk, tv)
    o_j, to_j = torch.func.jvp(attention_jvp, (q, k, v), (tq, tk, tv))
    o_f, to_f = attention_value_and_jvp(q, k, v, tq, tk, tv, fast=True)
    reps = [mismatch_report(n, g, w, CONFIG5_ATOL) for n, g, w in (
        ("value_and_jvp O", o, o_w), ("value_and_jvp tO", to, to_w),
        ("func.jvp(attention_jvp) O", o_j, o_w), ("func.jvp(attention_jvp) tO", to_j, to_w))]
    fast_ok_o, fast_o = _within(o_f, o, JVP_FAST_O)
    fast_ok_t, fast_t = _within(to_f, to, JVP_FAST_TO)
    log(f"[jvp_oracle] config 5 ({b},{h},{t},64) vs the fp32 oracle: " + "; ".join(map(str, reps))
        + f"; fast vs exact max|dO| {fast_o:.3e} (tol {JVP_FAST_O}), max|dtO| {fast_t:.3e} "
        f"(tol {JVP_FAST_TO})")
    if any(r.mismatches for r in reps) or not (fast_ok_o and fast_ok_t):
        raise AssertionError("the JVP entry points fail BASELINE config 5's gate")
    del q, k, v, tq, tk, tv, o_w, to_w, o, to, o_j, to_j, o_f, to_f

    for causal in (False, True):
        q, k, v, tq, tk, tv, wo, wt = _jvp_inputs(gen, dev, 1, 2, 256, 256)

        def loss(pair):
            return (torch.sin(pair[0]) * wo).sum() + (pair[1] * wt).sum() + pair[1].square().sum()

        leaves = [x.clone().requires_grad_(True) for x in (q, k, v, tq, tk, tv)]
        got = torch.autograd.grad(loss(attention_value_and_jvp(*leaves, causal=causal)), leaves)
        ref = [x.clone().requires_grad_(True) for x in (q, k, v, tq, tk, tv)]
        want = torch.autograd.grad(loss(reference_attention_jvp(ref[:3], ref[3:], causal)), ref)
        res = [_within(g, w, JVP_GRAD_TOL) for g, w in zip(got, want)]
        leaves = leaves[:3]
        got_j = torch.autograd.grad(attention_jvp(*leaves, causal=causal), leaves, wo)
        want_j = reference_attention_vjp(q, k, v, wo, causal=causal)
        res_j = [_within(g, w, JVP_GRAD_TOL) for g, w in zip(got_j, want_j)]
        log(f"[jvp_oracle] (1,2,256,64) causal={causal}: value_and_jvp grads vs autograd through "
            "torch.func.jvp of the oracle, max|diff| "
            + " ".join(f"d{n} {r[1]:.2e}" for n, r in zip(("q", "k", "v", "tq", "tk", "tv"), res))
            + "; attention_jvp grads vs the oracle's "
            + " ".join(f"d{n} {r[1]:.2e}" for n, r in zip("qkv", res_j))
            + f" (rtol = atol = {JVP_GRAD_TOL})")
        if not all(r[0] for r in res + res_j):
            raise AssertionError("JVP gradients outside the JAX package's envelope")
    launches = _jvp_launches()
    if not all(launches[k] for k in (*JVP_KERNELS, "flash_bwd_dkv", "flash_bwd_dq")) \
            or launches["flash_fwd"]:
        raise AssertionError(f"the oracle phase launched {launches}")
    return launches


def phase_jvp_timing(dev, gen) -> dict:
    """Phase 19: device time per call of B1 fp32 and B9-B12 (both modes) at
    the DiT's attention shape beside their plain versions, and at bench.py's
    bench_jvp shape; B1 fp32 beside SDPA on the same f32 inputs. The row's
    `ms`, `plain_ms` and `bound_ms` are at the DiT shape in the mode its main
    path runs (B9, B11, B12 fast as the rCM step; B10 exact as attention_jvp;
    B1 fp32); `other_ms` is the other mode's."""
    out = {k: {} for k in JVP_KERNELS}

    def few(fn):  # exact-mode calls take tens of ms: one call a graph, two replays
        return device_ms(fn, calls=1, replays=2)

    for tag, (b, h, t) in (("", (DIT_BATCH, DIT_CFG.n_heads, DIT_CFG.seq_len)),
                           ("bench_", JVP_BENCH_SHAPE)):
        q, k, v, tq, tk, tv, do, dto = _jvp_inputs(gen, dev, b, h, t, t)
        prod = 2 * b * h * t * t * 64  # one product over every (q, k) pair
        o, lse = flash_attention_fwd_fp32(q, k, v)
        fwd = {m: attention_jvp_fwd(q, k, v, tq, tk, tv, fast=m) for m in (True, False)}
        ops = {m: jvp_bwd_operands(q, k, v, tq, tk, tv, *fwd[m], do, dto, fast=m)
               for m in (True, False)}
        dkv, dq = jvp_bwd_dkv(ops[True]), jvp_bwd_dq(ops[True])
        io = {"jvp_fwd": nbytes(q, k, v, tq, tk, tv, *fwd[True]),
              "jvp_tangent": nbytes(q, k, v, tq, tk, tv, o, lse, fwd[True][1]),
              "jvp_bwd_dkv": nbytes(*ops[True][:12], *dkv),
              "jvp_bwd_dq": nbytes(*ops[True][:12], *dq)}
        dots = {"jvp_fwd": 6, "jvp_tangent": 5, "jvp_bwd_dkv": 12, "jvp_bwd_dq": 9}
        calls = {"jvp_fwd": lambda m: attention_jvp_fwd(q, k, v, tq, tk, tv, fast=m),
                 "jvp_tangent": lambda m: attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv,
                                                                fast=m),
                 "jvp_bwd_dkv": lambda m: jvp_bwd_dkv(ops[m]),
                 "jvp_bwd_dq": lambda m: jvp_bwd_dq(ops[m])}
        plains = {"jvp_fwd": lambda m: attention_jvp_fwd_plain(q, k, v, tq, tk, tv, fast=m),
                  "jvp_tangent": lambda m: attention_tangent_fwd_plain(q, k, v, o, lse, tq, tk,
                                                                       tv, fast=m),
                  "jvp_bwd_dkv": lambda m: jvp_bwd_dkv_plain(ops[m]),
                  "jvp_bwd_dq": lambda m: jvp_bwd_dq_plain(ops[m])}
        r = out["flash_fwd_fp32"]
        r[f"{tag}ms"] = few(lambda: flash_attention_fwd_fp32(q, k, v))
        r[f"{tag}library_ms"] = few(lambda: F.scaled_dot_product_attention(q, k, v))
        b1 = bound(nbytes(q, k, v, o, lse), (2 * prod, PEAK_FP32))
        r.update({f"{tag}{key}": val for key, val in b1.items()})
        if not tag:
            r["plain_ms"] = few(lambda: flash_attention_fwd_plain(q, k, v, precision="fp32"))
        for name in dots:
            main = name != "jvp_tangent"  # fast for the rCM step's kernels
            r = out[name]
            r[f"{tag}ms"] = few(lambda: calls[name](main))
            r[f"{tag}other_ms"] = few(lambda: calls[name](not main))
            for mode, peak in ((main, PEAK_BF16 if main else PEAK_FP32),
                               (not main, PEAK_BF16 if not main else PEAK_FP32)):
                key = "" if mode == main else "other_"
                bnd = bound(io[name], (dots[name] * prod, peak))
                r[f"{tag}{key}bound_ms"] = bnd["bound_ms"]
                r[f"{tag}{key}bound_by"] = bnd["bound_by"]
            if not tag:
                r["plain_ms"] = few(lambda: plains[name](main))
        del q, k, v, tq, tk, tv, do, dto, o, lse, fwd, ops, dkv, dq
    for name, r in out.items():
        r["mode"] = {"flash_fwd_fp32": "fp32", "jvp_tangent": "exact"}.get(name, "fast")
        r["shape"] = f"({DIT_BATCH},{DIT_CFG.n_heads},{DIT_CFG.seq_len},64)"
        r["bench_shape"] = "({},{},{},64)".format(*JVP_BENCH_SHAPE)
        if name == "flash_fwd_fp32":
            r["library_call"] = "F.scaled_dot_product_attention, f32 inputs"
            log(f"[timing] flash_fwd_fp32 {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, sdpa f32 {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms; {r['bench_shape']}: kernel {r['bench_ms']:.4f} ms, sdpa f32 "
                f"{r['bench_library_ms']:.4f} ms, bound {r['bench_bound_ms']:.4f} ms")
            continue
        r["library_ms"] = None
        r["library_call"] = "none (no single call)"
        other = "fast" if r["mode"] == "exact" else "exact"
        log(f"[timing] {name} {r['shape']}: {r['mode']} {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f}), {other} {r['other_ms']:.4f} ms (bound "
            f"{r['other_bound_ms']:.4f}), plain {r['mode']} {r['plain_ms']:.4f} ms; {r['bench_shape']}: "
            f"{r['mode']} {r['bench_ms']:.4f} ms (bound {r['bench_bound_ms']:.4f}), {other} "
            f"{r['bench_other_ms']:.4f} ms (bound {r['bench_other_bound_ms']:.4f})")
    return out


def _dit_params(dev, cfg, seed=0):
    """init_dit's params with `ada` and `out` drawn at 1/sqrt(fan_in): at the
    JAX init (both zero) attention would not reach the loss at all."""
    params = init_dit(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    d = cfg.d_model
    params["out"] = torch.randn((d, d), generator=gen, device=dev) / d ** 0.5
    for layer in params["layers"]:
        layer["ada"] = torch.randn((d, 6 * d), generator=gen, device=dev) / d ** 0.5
    return params


def _dit_copy(params, device):
    """A detached copy of DiT params on `device`, every tensor a leaf that
    requires grad."""
    def leaf(x):
        return x.detach().to(device).requires_grad_(True)

    out = {k: leaf(params[k]) for k in ("t_mlp1", "t_mlp2", "out")}
    out["layers"] = [{k: leaf(x) for k, x in layer.items()} for layer in params["layers"]]
    return out


def _dit_checks(dev, params, x, t) -> dict:
    """At seq DIT_PARITY_LEN: the rCM loss and every gradient on the card
    against the CPU plain path (both fast), (u, du/dt) against finite
    differences (central), and torch.func.jvp of dit_forward (default attention) through
    B10 once a layer. Returns that jvp run's launches."""
    cfg = dataclasses.replace(DIT_CFG, seq_len=DIT_PARITY_LEN)
    xs, ts = x[:2, :DIT_PARITY_LEN].contiguous(), t[:2].contiguous()
    res = {}
    for device in (dev, "cpu"):
        copy = _dit_copy(params, device)
        loss = rcm_loss(copy, xs.to(device), ts.to(device), cfg, fast=True)
        res[str(device)] = (loss.item(), torch.autograd.grad(loss, dit_param_leaves(copy)))
    (loss_c, grads_c), (loss_p, grads_p) = res[str(dev)], res["cpu"]
    rels = [((g.cpu() - w).norm() / w.norm()).item() for g, w in zip(grads_c, grads_p)]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    zero = [i for i, g in enumerate(grads_c) if not g.abs().max() > 0]
    log(f"[dit] rCM loss on the card vs CPU plain path (2 x {DIT_PARITY_LEN} tokens, fast): "
        f"{loss_c:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}); grad rel L2 max {max(rels):.3e} "
        f"median {statistics.median(rels):.3e} over {len(rels)} tensors (tol {DIT_GRAD_REL_L2}); "
        f"zero gradients: {zero}")
    if not (loss_rel <= DIT_GRAD_REL_L2 and max(rels) <= DIT_GRAD_REL_L2 and not zero):
        raise AssertionError("rCM gradients on the card disagree with the CPU plain path")

    with torch.no_grad():
        p = _dit_copy(params, dev)
        u, du = dit_jvp_step(p, xs, ts, cfg, fast=True)
        v = dit_forward(p, xs, ts, cfg)
        eps = 1e-3  # central differences: with `ada` and `out` nonzero the DiT
        # curves enough that a one-sided difference is off by ~1e-1 at this eps
        fd = (dit_forward(p, xs + eps * v, ts + eps, cfg)
              - dit_forward(p, xs - eps * v, ts - eps, cfg)) / (2 * eps)
        rel_fd = ((fd - du).norm() / du.norm()).item()
        _reset_counts()
        _, du_j = torch.func.jvp(lambda x_, t_: dit_forward(p, x_, t_, cfg), (xs, ts),
                                 (v, torch.ones_like(ts)))
        torch.cuda.synchronize()
        launches = _jvp_launches()
    rel_j = ((du_j - du).norm() / du_j.norm()).item()
    log(f"[dit] (u, du/dt) at seq {DIT_PARITY_LEN}: du/dt vs central differences rel L2 "
        f"{rel_fd:.3e} (tol 0.05); torch.func.jvp(dit_forward) (exact, B10) vs the fast pair "
        f"path rel L2 {rel_j:.3e} (tol {DIT_JVP_REL_L2}); its launches {launches}")
    want = {k: 0 for k in launches}
    want.update(flash_fwd_fp32=cfg.n_layers, jvp_tangent=cfg.n_layers)
    if not (rel_fd < 0.05 and rel_j <= DIT_JVP_REL_L2 and launches == want):
        raise AssertionError("dit_jvp_step disagrees with finite differences or with "
                             "torch.func.jvp of dit_forward, or the forward-mode DiT did not "
                             "run B10 once a layer")
    return launches


# each rCM step runs the fp32 prepass (B1 fp32), B9 forward, B11 + B12 backward
DIT_STEP_KERNELS = ("flash_fwd_fp32", "jvp_fwd", "jvp_bwd_dkv", "jvp_bwd_dq")


def phase_dit(dev, smi) -> tuple[dict, dict, dict]:
    """Phase 20, BASELINE config 5. Returns (the 5 timed steps' launches of
    the JVP kernels, the seq-512 jvp run's, step numbers)."""
    cfg = DIT_CFG
    params = _dit_params(dev, cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((DIT_BATCH, cfg.seq_len, cfg.d_model), generator=gen, device=dev)
    t = torch.rand((DIT_BATCH,), generator=gen, device=dev)
    jvp_launches = _dit_checks(dev, params, x, t)

    _, step = make_dit_rcm_step(cfg, params, fast=True)
    losses = [step(x, t)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    per_step, times = [], []
    for _ in range(DIT_STEPS):
        before = _launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(x, t))
        end.record()
        times.append((start, end))
        per_step.append({k: n - before[k] for k, n in _launch_counts().items()})
    torch.cuda.synchronize()
    losses = torch.stack(losses).tolist()
    step_ms = [s.elapsed_time(e) for s, e in times]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"rCM losses not finite and falling: {losses}")
    want = {k: cfg.n_layers if k in DIT_STEP_KERNELS else 0 for k in _COUNTED}
    if any(c != want for c in per_step):
        raise AssertionError(f"kernel launches per rCM step {per_step}, want {want}")
    med = statistics.median(step_ms)
    mem = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = DIT_BATCH * cfg.seq_len
    log(f"[dit] rCM step, fast, DiT d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_layers} "
        f"layers, {DIT_BATCH} x {cfg.seq_len} tokens on {smi}: median step {med:.2f} ms (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}; CUDA events), {tokens / med * 1e3:.0f} "
        f"tokens/s, max_memory_allocated {mem:.2f} GiB, launches per step "
        f"{ {k: n for k, n in per_step[0].items() if n} }; losses {[round(v, 6) for v in losses]}")
    _profile_dit_step(step, x, t)
    launches = {k: sum(c[k] for c in per_step) for k in JVP_KERNELS}
    return launches, jvp_launches, {"median_ms": med, "max_memory_gib": mem,
                                    "tokens_per_s": tokens / med * 1e3, "losses": losses}


def _profile_dit_step(step, x, t):
    """torch.profiler over one rCM step: device time by kernel, and busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] one rCM step: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{total_us / 1e3:.2f} ms ({total_us / 1e3 / wall_ms:.1%} of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d} calls  "
            f"{e.self_device_time_total / total_us:6.1%}  {e.key[:90]}")


def main() -> None:
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    flash = phase_flash(dev, gen)
    decode = phase_decode(dev, gen)
    serve_tokens, serve_launches = phase_serving(dev, smi)
    bwd_err = phase_flash_bwd(dev, gen)
    timing, train_err = phase_train_timing(dev, gen)
    int8_err = phase_int8_kernels(dev, gen)
    sdpa = {"fwd": timing["flash_fwd"]["library_ms"], "bwd": timing["flash_bwd_dq"]["library_ms"]}
    int8_timing = phase_int8_timing(dev, gen, sdpa)
    phase_int8_oracle(dev, gen)
    train_launches, bf16_run = phase_train(dev, smi, TRAIN_CFG)
    int8_launches, int8_run = phase_train(dev, smi, INT8_TRAIN_CFG)
    ratios = [a / b for a, b in zip(int8_run["grad_norms"], bf16_run["grad_norms"])]
    log(f"[train_int8] global grad norm int8 / bf16 per step: {[round(r, 4) for r in ratios]} "
        f"(limit {GRAD_NORM_RATIO}); median step {int8_run['median_ms']:.2f} ms vs "
        f"{bf16_run['median_ms']:.2f} ms; max_memory_allocated {int8_run['max_memory_gib']:.2f} "
        f"vs {bf16_run['max_memory_gib']:.2f} GiB")
    if not all(np.isfinite(ratios)) or max(ratios) >= GRAD_NORM_RATIO:
        raise AssertionError("int8 gradient norms left 2x the bf16 run's (BASELINE config 4)")
    gqa_launches = phase_train_gqa(dev, GQA_CFG)
    int8_gqa_launches = phase_train_gqa(dev, INT8_GQA_CFG)
    fused_err = phase_int8_fused(dev, gen)
    phase_int8_infer_oracle(dev, gen)
    fused, infer_launches = phase_int8_infer_timing(dev, gen)
    weights = phase_weight_kernels(dev, gen)
    quant_runs = phase_serving_quantized(dev, smi, serve_tokens, serve_launches)
    jvp_err = phase_jvp_kernels(dev, gen)
    oracle_launches = phase_jvp_oracle(dev, gen)
    jvp_timing = phase_jvp_timing(dev, gen)
    dit_launches, dit_jvp_launches, _ = phase_dit(dev, smi)

    def at_train(name):
        return {f"train_{k}": v for k, v in timing[name].items()}

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "quantizedattention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "quantizedattention_tpu/ops/flash_fwd.py:47",
         "launches_by_path": {"serve": serve_launches["flash_fwd"],
                              "train": train_launches["flash_fwd"],
                              "train_gqa": gqa_launches["flash_fwd"]},
         **flash, "max_abs_err": max(flash["max_abs_err"], train_err["flash_fwd"]),
         **at_train("flash_fwd")},
        {"name": "decode", "route": "cuda",
         "source": "quantizedattention_tpu_torch/csrc/decode.cu",
         "replaces": "quantizedattention_tpu/parallel/kv_cache.py:172",
         "launches_by_path": {"serve": serve_launches["decode"]}, **decode},
    ]
    for kname, replaces in (("flash_bwd_dkv", "quantizedattention_tpu/ops/flash_bwd.py:66"),
                            ("flash_bwd_dq", "quantizedattention_tpu/ops/flash_bwd.py:132")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": "quantizedattention_tpu_torch/csrc/flash_bwd.cu",
                        "replaces": replaces,
                        "launches_by_path": {"train": train_launches[kname],
                                             "train_gqa": gqa_launches[kname],
                                             "jvp_oracle": oracle_launches[kname]},
                        "max_abs_err": max(bwd_err[kname], train_err[kname]),
                        **timing[kname]})
    for kname, source, replaces in (
            ("quant_int8", "quant_int8.cu", "quantizedattention_tpu/quantize/int8.py:66"),
            ("int8_fwd", "int8_fwd.cu", "quantizedattention_tpu/ops/int8_fwd.py:68"),
            ("int8_bwd_dkv", "int8_bwd.cu", "quantizedattention_tpu/ops/int8_bwd.py:62"),
            ("int8_bwd_dq", "int8_bwd.cu", "quantizedattention_tpu/ops/int8_bwd.py:123")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"quantizedattention_tpu_torch/csrc/{source}",
                        "replaces": replaces,
                        "launches_by_path": {"train_int8": int8_launches[kname],
                                             "train_gqa_int8": int8_gqa_launches[kname]},
                        "max_abs_err": int8_err[kname], **int8_timing[kname]})
    kernels[-4]["also_replaces"] = ["quantizedattention_tpu/quantize/int8.py:74",
                                    "quantizedattention_tpu/quantize/int8.py:85"]
    kernels.append({"name": "int8_fused", "route": "cuda",
                    "source": "quantizedattention_tpu_torch/csrc/int8_fwd.cu",
                    "also_runs": "quantizedattention_tpu_torch/csrc/quant_int8.cu (absmax pass "
                                 "only: the scale tables)",
                    "replaces": "quantizedattention_tpu/ops/int8_fwd.py:197",
                    "launches_by_path": {"infer_int8": infer_launches["int8_fused"]},
                    "max_abs_err": fused_err, **fused})
    for kname, replaces in (("int8_linear", "quantizedattention_tpu/ops/int8_linear.py:42"),
                            ("int4_linear", "quantizedattention_tpu/ops/int4_linear.py:64")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"quantizedattention_tpu_torch/csrc/{kname}.cu",
                        "replaces": replaces, "launches_by_path": {}, **weights[kname]})
    for kname, source, replaces in (
            ("flash_fwd_fp32", "flash_fwd.cu", "quantizedattention_tpu/ops/flash_fwd.py:47"),
            ("jvp_fwd", "jvp.cu", "quantizedattention_tpu/ops/jvp_fwd.py:39"),
            ("jvp_tangent", "jvp.cu", "quantizedattention_tpu/ops/jvp_tangent.py:44"),
            ("jvp_bwd_dkv", "jvp.cu", "quantizedattention_tpu/ops/jvp_bwd.py:105"),
            ("jvp_bwd_dq", "jvp.cu", "quantizedattention_tpu/ops/jvp_bwd.py:155")):
        by_path = {"dit_rcm": dit_launches[kname], "jvp_oracle": oracle_launches[kname]}
        if dit_jvp_launches[kname]:
            by_path["dit_jvp"] = dit_jvp_launches[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"quantizedattention_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches_by_path": by_path,
                        "max_abs_err": jvp_err[kname], **jvp_timing[kname]})
    kernels[-5]["mode_of"] = "precision='fp32' of the B1 kernel"
    for k in kernels:  # the quantized serving runs' launches of each kernel they ran
        for path, counts in quant_runs.items():
            if k["name"] in counts:
                k["launches_by_path"][path] = counts[k["name"]]
    for k in kernels:  # launches: every path's run together
        k["launches"] = sum(k["launches_by_path"].values())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
