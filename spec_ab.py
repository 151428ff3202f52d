"""Time greedy speculative serving of two checkouts of the PyTorch port on
one GPU, in turns, and count where each form of the verify pass's MLP down
projection rounds apart from the decode step's product.

    python3 spec_ab.py OLD_CHECKOUT NEW_CHECKOUT [REPEATS]
    python3 spec_ab.py --forms CHECKOUT

The serving runs are chip_smoke.py phase 24's: the bench LM (vocab 8192,
d_model 1024, 16/16 heads of 64, 4 layers, max_seq 512, bf16, random
weights from seed 0), 8 slots, 8 periodic 256-token prompts x 96 new
tokens, the native scheduler, `spec_decode=4` beside the plain engine at
decode horizon 32, on the four cache kinds (slotted and paged, bf16 and
int4). Each run is a process of its own (its own package and kernel
build), in the order old, new, new:whole, new:copies, new:copies,
new:whole, new, old. "whole" runs NEW with its verify pass's down
projection as one [n * s, d_ff] product (the form before it ran a position
at a time), "copies" with one copy and one product a position and a
concatenation. Each engine serves once to warm up, then REPEATS timed runs
(default 5) alternate plain and spec; a run's tokens/s is 768 over its
wall seconds. A process prints one JSON line: per cache kind the median
and every tokens/s of plain and spec, spec's tokens per model pass, and
how many of the 8 requests have spec tokens equal to plain's. The first
NEW process also counts, on the verify pass's shape (8 x 5 bf16 rows of
4096 against layer 0's [4096, 1024] down projection), the outputs of each
form that differ from the decode step's [8, 1, 4096] product. The summary
gives each label's mean of its two processes' medians.

`--forms` holds the verify pass's MLP residual in each form (whole, one
copy, copies) at the bench LM's verify shape (x [8, 5, 1024] bf16, layer 0
of the seed-0 weights): the launches a call (torch.profiler's count of
device events over 20 calls), the eager wall a call (host dispatch
included: the median of 7 spans of 200 calls, each closed by a
synchronize), and the outputs that differ from the decode steps' (each
position's MLP run alone on [8, 1, 1024], as a decode step runs it); the
logits and cache fields of a whole verify pass, with each form in it,
that differ from its decode steps' (chip_smoke.py's
`verify_vs_decode_steps`, slotted int8 and int4 caches, phase 24's
prompts); and the product-level counts above. Exits non-zero without a
GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N_SLOTS, PROMPT_LEN, NEW_TOKENS, HORIZON, SPEC_K = 8, 256, 96, 32, 4
KINDS = {"bf16": {}, "paged": {"cache": "paged"}, "int4": {"kv_quant": "int4"},
         "paged4": {"cache": "paged", "kv_quant": "int4"}}
ORDER = ("old", "new", "new:whole", "new:copies", "new:copies", "new:whole", "new", "old")


def _prompts():
    return [(list(range(100 + 16 * i, 116 + 16 * i)) * (PROMPT_LEN // 16 + 1))[:PROMPT_LEN]
            for i in range(N_SLOTS)]


def _mlp_forms(transformer) -> dict:
    """The verify pass's MLP residual forms of NEW's transformer module."""
    import torch
    import torch.nn.functional as F

    def copies(layer, x):
        h = F.gelu(transformer.mm(transformer.rmsnorm(x, layer["ln2"]), layer["w1"]),
                   approximate="tanh")
        return x + torch.cat([transformer.mm(h[:, i:i + 1].contiguous(), layer["w2"])
                              for i in range(h.shape[1])], dim=1)

    return {"whole": transformer._mlp_residual,
            "one_copy": transformer._mlp_residual_per_position, "copies": copies}


def _patch_mlp(transformer, variant: str) -> None:
    """Give NEW's verify pass another down projection form."""
    if variant in ("whole", "copies"):
        transformer._mlp_residual_per_position = _mlp_forms(transformer)[variant]


def _form_mismatches(torch, w2, dev) -> dict:
    """Outputs (of 8 x 5 x 1024) of each down projection form that differ
    from the decode step's product of the same position."""
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((N_SLOTS, SPEC_K + 1, w2.shape[0]), generator=g, device=dev).to(w2.dtype)
    steps = torch.cat([torch.matmul(h[:, i:i + 1].contiguous(), w2) for i in range(h.shape[1])],
                      dim=1)
    by_position = h.transpose(0, 1).contiguous()
    forms = {
        "whole": torch.matmul(h, w2),
        "strided_rows": torch.stack([torch.matmul(h[:, i], w2) for i in range(h.shape[1])], 1),
        "copies": torch.cat([torch.matmul(h[:, i:i + 1].contiguous(), w2)
                             for i in range(h.shape[1])], dim=1),
        "one_copy": torch.stack([torch.matmul(r, w2) for r in by_position], dim=1),
        "bmm": torch.bmm(by_position, w2.expand(h.shape[1], -1, -1)).transpose(0, 1),
    }
    return {name: int((out != steps).sum().item()) for name, out in forms.items()}


def run_one(tree: str, variant: str, probe: bool, repeats: int) -> None:
    """Serve with `tree`'s engine; print one JSON object."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from quantizedattention_tpu_torch import _build
    from quantizedattention_tpu_torch.models import TransformerConfig, init_transformer
    from quantizedattention_tpu_torch.models import transformer
    from quantizedattention_tpu_torch.serve import ServingEngine

    _build.build_all()
    _patch_mlp(transformer, variant)
    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=16,
                            head_dim=64, n_layers=4, max_seq=512)
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                              torch.bfloat16)
    prompts = _prompts()
    rows = {}
    for kind, kw in KINDS.items():
        engines = {
            "plain": ServingEngine(params, cfg, dev, n_slots=N_SLOTS, scheduler="native",
                                   param_dtype=torch.bfloat16, decode_horizon=HORIZON, **kw),
            "spec": ServingEngine(params, cfg, dev, n_slots=N_SLOTS, scheduler="native",
                                  param_dtype=torch.bfloat16, spec_decode=SPEC_K, **kw)}

        def serve(eng):
            rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.run()
            torch.cuda.synchronize()
            return [out[r].tokens for r in rids], time.perf_counter() - t0

        tokens = {name: serve(eng)[0] for name, eng in engines.items()}  # warm-up
        rates = {name: [] for name in engines}
        for _ in range(repeats):
            for name, eng in engines.items():
                got, wall = serve(eng)
                if got != tokens[name]:
                    raise SystemExit(f"spec_ab: {kind} {name}: a run gave other tokens")
                rates[name].append(N_SLOTS * NEW_TOKENS / wall)
        st = engines["spec"].stats()["spec"]
        rows[kind] = {
            "plain_tokens_per_s": statistics.median(rates["plain"]),
            "spec_tokens_per_s": statistics.median(rates["spec"]),
            "plain_runs": rates["plain"], "spec_runs": rates["spec"],
            "tokens_per_pass": st["tokens_per_pass"],
            "requests_token_equal": sum(a == b for a, b in zip(tokens["spec"], tokens["plain"]))}
        del engines
    out = {"tree": tree, "variant": variant, "device": torch.cuda.get_device_name(0),
           "rows": rows}
    if probe:
        out["form_mismatches"] = _form_mismatches(torch, params["layers"][0]["w2"], dev)
    print(json.dumps(out))


def run_forms(tree: str) -> None:
    """`--forms`: print one JSON object."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quantizedattention_tpu_torch.models import TransformerConfig, init_transformer
    from quantizedattention_tpu_torch.models import transformer

    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=16,
                            head_dim=64, n_layers=4, max_seq=512)
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                              torch.bfloat16)
    layer = params["layers"][0]
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((N_SLOTS, SPEC_K + 1, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    steps = torch.cat([transformer._mlp_residual(layer, x[:, i:i + 1].contiguous())
                       for i in range(x.shape[1])], dim=1)
    rows = {}
    forms = _mlp_forms(transformer)
    with torch.no_grad():
        for name, fn in forms.items():
            out = fn(layer, x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn(layer, x)
                torch.cuda.synchronize()
            launches = sum(e.count for e in prof.key_averages()
                           if e.device_type.name == "CUDA") / 20
            spans = []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn(layer, x)
                torch.cuda.synchronize()
                spans.append((time.perf_counter() - t0) / 200 * 1e3)
            rows[name] = {"launches": launches, "wall_ms": statistics.median(spans),
                          "wall_spans_ms": spans,
                          "differ_from_decode_steps": int((out != steps).sum().item())}
    import chip_smoke

    for name, fn in forms.items():
        transformer._mlp_residual_per_position = fn
        for kv_quant in (None, "int4"):
            off, total, fields_off = chip_smoke.verify_vs_decode_steps(
                params, chip_smoke._spec_prompts(), kv_quant)
            rows[name][f"verify_pass_{kv_quant or 'int8'}"] = {
                "logits_differ": off, "logits": total, "cache_fields_differ": len(fields_off)}
    transformer._mlp_residual_per_position = forms["one_copy"]
    print(json.dumps({"tree": tree, "device": torch.cuda.get_device_name(0), "forms": rows,
                      "product_mismatches": _form_mismatches(torch, layer["w2"], dev)}))


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--forms":
        run_forms(sys.argv[2])
        return
    if len(sys.argv) >= 4 and sys.argv[1] == "--one":
        run_one(sys.argv[2], sys.argv[3], sys.argv[4] == "probe", int(sys.argv[5]))
        return
    if len(sys.argv) not in (3, 4):
        sys.exit(__doc__)
    trees = {"old": sys.argv[1], "new": sys.argv[2]}
    repeats = int(sys.argv[3]) if len(sys.argv) == 4 else 5
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for label in ORDER:
        tree, _, variant = label.partition(":")
        probe = "probe" if label == "new" and "new" not in [r["label"] for r in runs] else "-"
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", trees[tree],
                              variant or "as_is", probe, str(repeats)],
                             capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"serving {label} failed:\n{out.stderr[-3000:]}")
        runs.append(dict(json.loads(out.stdout.strip().splitlines()[-1]), label=label))
        print(json.dumps(runs[-1]), flush=True)
    for kind in KINDS:
        parts = []
        for label in dict.fromkeys(ORDER):
            mine = [r["rows"][kind] for r in runs if r["label"] == label]
            plain = statistics.mean(r["plain_tokens_per_s"] for r in mine)
            spec = statistics.mean(r["spec_tokens_per_s"] for r in mine)
            equal = [r["requests_token_equal"] for r in mine]
            parts.append(f"{label} spec {spec:.1f} plain {plain:.1f} tokens/s "
                         f"({spec / plain:.3f}x, {equal} of {N_SLOTS} token-equal)")
        print(f"[spec_ab] {kind}: " + "; ".join(parts) + f" ({smi})", flush=True)


if __name__ == "__main__":
    main()
