"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the CUDA kernels and the native scheduler from this
     checkout's sources (quantizedattention_tpu_torch/_build.py);
  3. flash_fwd kernel vs its plain PyTorch version (O and lse);
  4. decode kernel vs its plain version, with stale non-finite scales and
     junk payloads written past every row's length;
  5. serving at full width: the bench LM (vocab 8192, d_model 1024, 16 heads,
     head_dim 64, 4 layers, max_seq 1280, bf16) serves 8 requests of 256
     random tokens x 96 new tokens through ServingEngine (8 slots, decode
     horizon 32), after a warm-up run. The timed run must launch both
     kernels, repeat the warm-up's tokens, and match `generate` on the same
     8 prompts as one batch; prefill logits must agree with the plain path
     on the CPU.
Then one JSON line with per-kernel launches, errors and times, and, last,
{"ok": true, "device": {...}}. Weights and inputs are random from fixed
seeds. Kernel times are device times per call (wrapper included: casts and
allocation), from CUDA events around CUDA-graph replays; serving times are
host wall clock around synchronised work. They are records, not claims.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from quantizedattention_tpu_torch import _build
from quantizedattention_tpu_torch.models import TransformerConfig, generate, init_transformer
from quantizedattention_tpu_torch.models import transformer_forward
from quantizedattention_tpu_torch.ops.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from quantizedattention_tpu_torch.parallel.kv_cache import (
    QuantizedKVCache,
    decode_attention,
    decode_attention_plain,
)
from quantizedattention_tpu_torch.serve import ServingEngine

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

BENCH_CFG = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=16,
                              head_dim=64, n_layers=4, max_seq=1280)
N_SLOTS, PROMPT_LEN, NEW_TOKENS, HORIZON = 8, 256, 96, 32


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


def phase_flash(dev, gen) -> dict:
    cases = [  # (b, h, h_kv, t, s, causal)
        (2, 16, 16, 256, 256, True),
        (2, 16, 4, 1000, 1000, True),
        (1, 4, 2, 77, 201, False),
    ]
    worst = 0.0
    for b, h, h_kv, t, s, causal in cases:
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
    log(f"[flash_fwd] (8,16,256,64) causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    q, cache = _decode_case(dev, gen, 16, 16, [PROMPT_LEN + NEW_TOKENS // 2] * N_SLOTS,
                            stale=False)
    ms = device_ms(lambda: decode_attention(q, cache))
    plain_ms = device_ms(lambda: decode_attention_plain(q, cache))
    log(f"[decode] 8 slots x 16 heads, length {PROMPT_LEN + NEW_TOKENS // 2} of "
        f"{BENCH_CFG.max_seq}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_serving(dev, smi) -> dict:
    cfg = BENCH_CFG
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                              torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=PROMPT_LEN).tolist() for _ in range(N_SLOTS)]
    eng = ServingEngine(params, cfg, dev, n_slots=N_SLOTS, scheduler="native",
                        param_dtype=torch.bfloat16, decode_horizon=HORIZON)

    def serve():
        rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return [out[r] for r in rids], time.perf_counter() - t0

    warm, _ = serve()
    flash_attention_fwd.launches = 0
    decode_attention.launches = 0
    results, wall = serve()
    launches = {"flash_fwd": flash_attention_fwd.launches, "decode": decode_attention.launches}

    for r in results:
        if r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS:
            raise AssertionError(f"request {r.request_id}: {r.finish_reason}, {len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: token out of vocab")
    if not all(launches.values()):
        raise AssertionError(f"the served run skipped a kernel: launches {launches}")
    if [r.tokens for r in results] != [r.tokens for r in warm]:
        raise AssertionError("a second run gave different tokens")
    want = generate(eng.params, torch.tensor(prompts, device=dev), cfg, NEW_TOKENS)
    want = want[:, PROMPT_LEN:].tolist()
    same = sum(r.tokens == w for r, w in zip(results, want))
    if same != N_SLOTS:
        raise AssertionError(f"engine tokens equal generate's for only {same}/{N_SLOTS} requests")

    # the full model on the card vs the plain path on the CPU, same weights
    probe = torch.tensor([prompts[0][:64]], device=dev)
    logits = transformer_forward(eng.params, probe, cfg).float().cpu()
    cpu_params = {k: v.cpu() for k, v in eng.params.items() if k != "layers"}
    cpu_params["layers"] = [{k: v.cpu() for k, v in lay.items()} for lay in eng.params["layers"]]
    ref = transformer_forward(cpu_params, probe.cpu(), cfg).float()
    rel = ((logits - ref).norm() / ref.norm()).item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[serve] prefill logits vs CPU plain path ({probe.shape[1]} tokens): rel L2 {rel:.3e} "
        f"(tol {LOGITS_REL_TOL}), argmax agreement {agree:.3f}")
    if not (torch.isfinite(logits).all() and rel <= LOGITS_REL_TOL):
        raise AssertionError("prefill logits disagree with the plain CPU path")

    n_tok = sum(len(r.tokens) for r in results)
    ttft_ms = statistics.median(r.ttft_s for r in results) * 1e3
    led = eng.ledger()
    log(f"[serve] {N_SLOTS} requests x {NEW_TOKENS} tokens (prompt {PROMPT_LEN}, horizon "
        f"{HORIZON}) on {smi}: {n_tok / wall:.1f} tokens/s, wall {wall:.3f} s, median TTFT "
        f"{ttft_ms:.2f} ms, launches {launches}, dispatches {led['dispatches']}, "
        f"fetch_s {led['fetch_s']:.3f}; tokens == generate for {same}/{N_SLOTS}; "
        f"repeat run identical")
    return launches


def main() -> None:
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    flash = phase_flash(dev, gen)
    decode = phase_decode(dev, gen)
    launches = phase_serving(dev, smi)
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "quantizedattention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "quantizedattention_tpu/ops/flash_fwd.py:47",
         "launches": launches["flash_fwd"], **flash},
        {"name": "decode", "route": "cuda",
         "source": "quantizedattention_tpu_torch/csrc/decode.cu",
         "replaces": "quantizedattention_tpu/parallel/kv_cache.py:172",
         "launches": launches["decode"], **decode},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
