"""Calls a parallel.launch.RankPool runs on every rank to drive mesh serving.

Each takes FULL inputs (params, caches, q/k/v; the same on every rank),
builds or reuses its (data, model, context) mesh over the pool's ranks,
cuts the inputs to this rank's shard (models/sharded_train.py), runs one
mesh entry point and returns this rank's outputs. tests/test_torch_mesh*.py
hold them against the JAX package's shard_map steps and the one-device
engine on the CPU; chip_smoke.py runs `serve` and `context_decode` on the
card. They live in the package so that spawned ranks import nothing but
torch and this package.
"""

from __future__ import annotations

import re
import time

import torch

from quantizedattention_tpu_torch.models.sharded_train import (
    local_config,
    shard_params,
    shard_tree,
)
from quantizedattention_tpu_torch.models.transformer import (
    TransformerConfig,
    _decode_logits,
    init_transformer,
)
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu_torch.ops.int8_fwd import int8_attention_fwd_from_quantized
from quantizedattention_tpu_torch.ops.int8_linear import int8_weight_matmul
from quantizedattention_tpu_torch.parallel.kv4_cache import (
    decode_attention_int4,
    verify_decode_attention_int4,
)
from quantizedattention_tpu_torch.parallel.kv_cache import (
    QuantizedKVCache,
    context_sharded_decode,
    decode_attention,
    verify_decode_attention,
)
from quantizedattention_tpu_torch.parallel.mesh import make_attention_mesh, shard_tensor
from quantizedattention_tpu_torch.parallel.multihost import local_device
from quantizedattention_tpu_torch.parallel.paged4_cache import (
    paged4_decode_attention,
    paged4_verify_attention,
)
from quantizedattention_tpu_torch.parallel.paged_cache import (
    paged_decode_attention,
    paged_verify_attention,
)
from quantizedattention_tpu_torch.parallel.sharded import make_sharded_attention
from quantizedattention_tpu_torch.quantize.int8 import quant_int8
from quantizedattention_tpu_torch.quantize.weights import QuantizedWeight
from quantizedattention_tpu_torch.serve.engine import (
    ServingEngine,
    _gather_rows,
    _local_rows,
    _mesh_psum,
    make_sharded_decode_step,
    make_sharded_prefill_chunk,
    make_sharded_prefill_slot,
    make_sharded_verify_step,
    serving_shardings,
)

# the wrappers mesh serving may launch, by chip_smoke.py's kernel names;
# each counts its launches in `.launches`
SERVING_KERNELS = {
    "flash_fwd": flash_attention_fwd, "quant_int8": quant_int8,
    "int8_fwd": int8_attention_fwd_from_quantized, "int8_linear": int8_weight_matmul,
    "decode": decode_attention, "paged_decode": paged_decode_attention,
    "decode4": decode_attention_int4, "paged4_decode": paged4_decode_attention,
    "verify": verify_decode_attention, "paged_verify": paged_verify_attention,
    "verify4": verify_decode_attention_int4, "paged4_verify": paged4_verify_attention,
}

_MESHES: dict = {}


def mesh(shape, device_type: str = "cuda"):
    """This rank's (data, model, context) mesh of `shape`, made once a shape
    (making one is a collective: every rank must ask in the same order)."""
    shape = tuple(shape) + (1,) * (3 - len(shape))
    key = (shape, device_type)
    if key not in _MESHES:
        _MESHES[key] = make_attention_mesh(*shape, device_type=device_type)
    return _MESHES[key]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(x.to(device) for x in tree))
    if isinstance(tree, (torch.Tensor, QuantizedWeight)):
        return tree.to(device)
    return tree


def mesh_steps(kind: str, cfg: TransformerConfig, shape, params, caches, calls, cache="slotted",
               kv_quant=None, weight_quant=None, temperature=0.0, horizon: int = 1,
               device_type: str = "cuda"):
    """Run one mesh step maker of serve/engine.py on this rank's shards of
    the full `params` and per-layer `caches`, once for each argument tuple
    of `calls` (after params and caches), the caches carried from call to
    call. kind: "decode" (make_sharded_decode_step with `horizon`),
    "decode_logits" (one step's logits, gathered to [n_slots, vocab]),
    "verify", "prefill" or "chunk". Returns (each call's outputs but the
    caches, this rank's final caches)."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    p = _to(shard_params(params, cfg, m, weight_quant), dev)
    c = _to(shard_tree(caches, serving_shardings(cfg, cache, weight_quant, kv_quant)[1], m), dev)
    if kind == "decode_logits":
        def fn(params, caches, last_tok, pos, active):
            n = last_tok.shape[0]
            lo, hi = _local_rows(m, n)
            logits, caches = _decode_logits(params, caches, last_tok[lo:hi], pos[lo:hi],
                                            active[lo:hi], local_config(cfg, m), _mesh_psum(m))
            return _gather_rows(logits, m, n, lo), caches
    else:
        fn = {"decode": lambda: make_sharded_decode_step(m, cfg, temperature, horizon),
              "verify": lambda: make_sharded_verify_step(m, cfg, temperature),
              "prefill": lambda: make_sharded_prefill_slot(m, cfg, temperature),
              "chunk": lambda: make_sharded_prefill_chunk(m, cfg, temperature)}[kind]()
    outs = []
    for args in calls:
        out = fn(p, c, *_to(list(args), dev))
        c = out[1]
        outs.append((out[0], *out[2:]))
    return outs, c


def context_decode(q, cache: QuantizedKVCache, context: int, device_type: str = "cuda"):
    """parallel/kv_cache.py:context_sharded_decode of q [b, n_q, d] against
    this rank's token slice of the full int8 `cache`, on a (world / context,
    1, context) mesh (the data replicas compute alike); returns the merged O
    [b, n_q, d]."""
    import torch.distributed as dist

    m = mesh((dist.get_world_size() // context, 1, context), device_type)
    dev = local_device(device_type)
    payload, scales = (None, None, "context", None), (None, None, "context")
    local = shard_tree(cache, QuantizedKVCache(payload, scales, payload, scales, ()), m)
    return context_sharded_decode(q.to(dev), _to(local, dev), m)


def sharded_attention(kind: str, q, k, v, causal: bool, do=None, shape=(2, 2, 1),
                      device_type: str = "cuda"):
    """parallel/sharded.py:make_sharded_attention on this rank's (batch,
    head) block of the full q, k, v. With `do`, also the gradients of
    sum(O * dO) over the block: returns (O, dq, dk, dv), else O."""
    m = mesh(shape, device_type)
    fn = make_sharded_attention(m, kind, causal)
    q, k, v = (shard_tensor(x, fn.spec, m).to(local_device(device_type)) for x in (q, k, v))
    if do is None:
        with torch.no_grad():
            return fn(q, k, v)
    for x in (q, k, v):
        x.requires_grad_(True)
    o = fn(q, k, v)
    (o * shard_tensor(do, fn.spec, m).to(o.device)).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def sharded_params(params, cfg: TransformerConfig, shape, weight_quant=None,
                   device_type: str = "cuda"):
    """models/sharded_train.py:shard_params on this rank."""
    return shard_params(params, cfg, mesh(shape, device_type), weight_quant)


def engine_error(params, cfg: TransformerConfig, shape, device_type: str = "cuda", **kw):
    """The ValueError message of ServingEngine(mesh=...) with `kw`, or None
    when it builds."""
    try:
        ServingEngine(params, cfg, local_device(device_type), mesh=mesh(shape, device_type),
                      scheduler="python", **kw)
    except ValueError as e:
        return str(e)
    return None


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in SERVING_KERNELS.items()}


def dryrun_serving(device_type: str = "cuda") -> dict:
    """The serving half of the JAX package's dryrun_multichip
    (__graft_entry__.py:136-224) on a (world / 2, 2) mesh: a small
    LM's prompts prefilled on one device (every rank alike), then two
    sharded decode steps, two with int8 weights over the int4 cache, and one
    sharded verify of 3 drafts a slot. Returns the tokens and n_emit."""
    import torch.distributed as dist

    from quantizedattention_tpu_torch.models.transformer import prefill_batched
    from quantizedattention_tpu_torch.parallel.kv4_cache import init_kv4_cache
    from quantizedattention_tpu_torch.parallel.kv_cache import init_kv_cache
    from quantizedattention_tpu_torch.quantize.weights import quantize_lm_weights

    model = 2
    data = dist.get_world_size() // model
    m = mesh((data, model), device_type)
    dev = local_device(device_type)
    cfg = TransformerConfig(vocab_size=128, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                            n_layers=2, max_seq=256)
    params = init_transformer(cfg, torch.Generator().manual_seed(10), dev)
    n_slots = 2 * data
    prompt = torch.randint(0, cfg.vocab_size, (n_slots, 16),
                           generator=torch.Generator().manual_seed(11)).to(dev)
    pos = torch.full((n_slots,), 16, device=dev)
    active = torch.ones((n_slots,), dtype=torch.bool, device=dev)
    out = {}
    for name, wq, init in (("decode", None, init_kv_cache), ("quantized", "int8", init_kv4_cache)):
        p = quantize_lm_weights(params) if wq else params
        caches = [init(n_slots, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim, dev)
                  for _ in range(cfg.n_layers)]
        tok, caches = prefill_batched(p, caches, prompt, cfg)
        specs = serving_shardings(cfg, "slotted", wq, "int4" if wq else None)[1]
        local = shard_tree(caches, specs, m)
        p = shard_params(p, cfg, m)
        step = make_sharded_decode_step(m, cfg)
        toks, step_pos = [], pos
        for _ in range(2):
            tok, local = step(p, local, tok, step_pos, active)
            toks.append(tok)
            step_pos = step_pos + 1
        out[name] = torch.stack(toks)
        if name == "decode":
            draft = torch.arange(3, device=dev).repeat(n_slots, 1)
            packed, _, _, _ = make_sharded_verify_step(m, cfg)(p, local, tok, draft, step_pos,
                                                                active)
            out["verify"] = packed
    out["shape"] = (data, model)
    return out


def serve(cfg: TransformerConfig, shape, prompts, budgets, params=None, init_seed: int = 0,
          device_type: str = "cuda", runs: int = 1, profile: bool = False, **engine_kw) -> dict:
    """Serve `prompts` with `budgets` through ServingEngine(mesh=...) on this
    rank, `runs` times on one engine (the last timed). params: the full
    tree, or None to draw init_transformer's from `init_seed` on the CPU
    (the same on every rank). Returns the tokens of each run, the last run's
    wall seconds and tokens/s, its kernel launches on this rank (the counts
    set to 0 just before it), the engine's stats(), and with `profile` one
    decode step's profile (`_profile_decode_step`)."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    if params is None:
        params = init_transformer(cfg, torch.Generator().manual_seed(init_seed), "cpu")
    eng = ServingEngine(params, cfg, dev, mesh=m, **engine_kw)
    tokens = []
    for i in range(runs):
        if i == runs - 1:
            for fn in SERVING_KERNELS.values():
                fn.launches = 0
        rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        tokens.append([out[r].tokens for r in rids])
    n_tok = sum(len(t) for t in tokens[-1])
    out = {"tokens": tokens, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "launches": launch_counts(), "stats": eng.stats()}
    if profile:
        out["profile"] = _profile_decode_step(eng, m, prompts, budgets)
    return out


def _profile_decode_step(eng, m, prompts, budgets) -> dict:
    """torch.profiler over one decode step while slots are live: `prompts`
    submitted again and admitted (the engine stepped until none waits),
    then one step of every live slot on copies of the caches, then the run
    drained. Returns the step's wall time, its device time, the device time
    of NCCL's collective kernels, of host-device copies (gloo's on CUDA
    tensors), the host time of the all_reduce calls by name, the live slots
    and the top device events."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    for p, b in zip(prompts, budgets):
        eng.submit(p, b)
    while eng.sched.num_waiting > 0 or eng._pending is not None:
        eng.step()
    step = make_sharded_decode_step(m, eng.cfg)
    caches = [type(c)(*(x.clone() for x in c)) for c in eng.caches]
    cuda = eng.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    step(eng.params, caches, eng.last_tok, eng.pos, eng.active)  # warm
    if cuda:
        torch.cuda.synchronize(eng.device)
    with profile(activities=acts) as prof:
        # the ranks start their profilers at different times: meet on the
        # host first, or the step's first collective waits for the last rank
        dist.barrier(group=eng._host_group)
        t0 = time.perf_counter()
        step(eng.params, caches, eng.last_tok, eng.pos, eng.active)
        if cuda:
            torch.cuda.synchronize(eng.device)
        wall = time.perf_counter() - t0
    live = int(eng.active.sum())
    eng.run()
    events = prof.key_averages()
    # device events, less the profiler's annotations of host calls (such as
    # "nccl:all_reduce", spanning the kernels they launched)
    dev_events = [e for e in events if e.device_type.name == "CUDA"
                  and not getattr(e, "is_user_annotation", False)
                  and not re.fullmatch(r"[a-z]+:[a-z_]+", e.key)]

    def dev_us(pred):
        return sum(e.self_device_time_total for e in dev_events if pred(e.key.lower()))

    return {
        "live_slots": live,
        "wall_ms": wall * 1e3,
        "device_ms": dev_us(lambda k: True) / 1e3,
        "collective_kernel_ms": dev_us(lambda k: k.startswith("nccl")) / 1e3,
        "memcpy_ms": dev_us(lambda k: "memcpy" in k) / 1e3,
        "all_reduce_host": [(e.key, e.count, e.cpu_time_total / 1e3) for e in events
                            if e.device_type.name == "CPU"
                            and ("all_reduce" in e.key.lower() or "allreduce" in e.key.lower())],
        "top_device": sorted(((e.key[:60], e.self_device_time_total / 1e3, e.count)
                              for e in dev_events), key=lambda x: -x[1])[:8],
    }
