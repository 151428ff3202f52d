"""Calls a parallel.launch.RankPool runs on every rank to drive sequence-
parallel attention, the sharded train step, the pipeline train step and the
sharded rCM step.

Each takes FULL inputs (the same on every rank), builds or reuses its
(data, model, context) mesh over the pool's ranks (serve/mesh_jobs.py:mesh),
cuts the inputs to this rank's block, runs one entry point and returns this
rank's outputs (tensors on the CPU). tests/test_torch_sp_attention.py and
tests/test_torch_sharded_train.py hold them against the JAX package on the
CPU (tests/test_torch_sp_jvp.py the JVP ring and the rCM step,
tests/test_torch_pipeline.py the pipeline, tests/test_torch_checkpoint.py
a checkpoint and resume of both train steps); chip_smoke.py phases 27-29
run them on the card. The pipeline jobs take the pool's ranks as one
("pipe",) mesh, stage s on rank s. They live in the package
so that spawned ranks import nothing but torch and this package; they run on
the card unless given device_type="cpu".
"""

from __future__ import annotations

import hashlib
import statistics
import time

import torch
import torch.distributed as dist

from quantizedattention_tpu_torch.models.sharded_train import (
    _attend,
    make_sharded_train_step,
    param_specs,
    shard_params,
)
from quantizedattention_tpu_torch.models.dit import (
    DiTConfig,
    dit_param_leaves,
    init_dit,
    make_dit_rcm_step,
)
from quantizedattention_tpu_torch.models.pipeline import (
    REPLICATED,
    make_pipeline_train_step,
    pipeline_named_params,
    pipeline_stage_params,
)
from quantizedattention_tpu_torch.models.transformer import TransformerConfig, init_transformer
from quantizedattention_tpu_torch.ops.flash_bwd import bwd_prep, flash_bwd_dkv, flash_bwd_dq
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu_torch.ops.int8_bwd import int8_bwd_dkv, int8_bwd_dq
from quantizedattention_tpu_torch.ops.int8_fwd import int8_attention_fwd_from_quantized
from quantizedattention_tpu_torch.ops.jvp_bwd import jvp_bwd_dkv, jvp_bwd_dq, jvp_bwd_prep
from quantizedattention_tpu_torch.ops.jvp_fwd import attention_jvp_fwd, jvp_fwd_prep
from quantizedattention_tpu_torch.parallel.collective import (
    kv_sharded_attention,
    kv_sharded_attention_int8,
    make_allgather_attention,
)
from quantizedattention_tpu_torch.parallel.mesh import (
    all_gather,
    all_to_all,
    axis_size,
    make_pipeline_mesh,
    ppermute_start,
    psum_scatter,
    shard_tensor,
)
from quantizedattention_tpu_torch.parallel.ring import ring_attention_jvp
from quantizedattention_tpu_torch.parallel.multihost import local_device
from quantizedattention_tpu_torch.parallel.zigzag import zigzag_perm
from quantizedattention_tpu_torch.quantize.int8 import quant_int8
from quantizedattention_tpu_torch.serve.mesh_jobs import mesh
from quantizedattention_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
    train_state,
)

# the wrappers the sharded train and rCM steps may launch, by chip_smoke.py's
# kernel names; each counts its launches in `.launches`
TRAIN_KERNELS = {
    "flash_fwd": flash_attention_fwd, "flash_bwd_dkv": flash_bwd_dkv,
    "flash_bwd_dq": flash_bwd_dq, "flash_bwd_prep": bwd_prep, "quant_int8": quant_int8,
    "int8_fwd": int8_attention_fwd_from_quantized, "int8_bwd_dkv": int8_bwd_dkv,
    "int8_bwd_dq": int8_bwd_dq, "jvp_fwd": attention_jvp_fwd, "jvp_fwd_prep": jvp_fwd_prep,
    "jvp_bwd_dkv": jvp_bwd_dkv, "jvp_bwd_dq": jvp_bwd_dq, "jvp_bwd_prep": jvp_bwd_prep,
}
BLOCK = ("data", "model", "context", None)  # q, k, v, dO: batch, heads, tokens
# the device functions of the SP steps' attention (B1-B3 and the fast
# backward's prep; B4, B5, B7, B8), by the names the profiler gives them
ATTENTION_KERNELS = ("flash_fwd_kernel", "dkv_kernel_bf16", "dq_kernel_bf16", "bwd_prep_kernel",
                     "quant_int8_kernel", "int8_attn_kernel", "int8_dkv_kernel", "int8_dq_kernel")


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in TRAIN_KERNELS.items()}


def reset_counts() -> None:
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _zigzag_order(x, m):
    """x [..., T] with its token axis (dim 2 of q/k/v, dim 1 of tokens)
    reordered by zigzag_perm: contiguous context blocks then hold each
    rank's (lo, hi) chunk pair."""
    n = axis_size(m, "context")
    dim = 2 if x.ndim == 4 else 1
    return x.index_select(dim, zigzag_perm(n, x.shape[dim]).to(x.device))


def sp_attention(strategy: str, kind: str, q, k, v, do, shape, device_type: str = "cuda"):
    """One causal sequence-parallel attention of the full q [B, H, T, d], k/v
    [B, H_kv, T, d] on this rank's (batch, head, sequence) block of a `shape`
    mesh, as the train step runs it (models/sharded_train.py:_attend), and
    its gradients of sum(O * dO): strategy "ring", "allgather", "ulysses"
    or "zigzag" (the blocks are of the zigzag-permuted sequence),
    kind "bf16" or "int8". Returns this rank's (O, dq, dk, dv) blocks."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    if strategy == "zigzag":
        q, k, v, do = (_zigzag_order(x, m) for x in (q, k, v, do))
    q, k, v, do = (shard_tensor(x, BLOCK, m).to(dev) for x in (q, k, v, do))
    for x in (q, k, v):
        x.requires_grad_(True)
    o = _attend(q, k, v, m, kind, strategy)
    (o * do).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def allgather(kind: str, q, k, v, do, shape, causal: bool = True, device_type: str = "cuda"):
    """`make_allgather_attention(kind=)` of the full q [B, H, T, d], k/v [B,
    H_kv, T, d] on this rank's (batch, head, sequence) block of a `shape`
    mesh, and its gradients of sum(O * dO). Returns this rank's (O, dq, dk,
    dv) blocks."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    q, k, v, do = (shard_tensor(x, BLOCK, m).to(dev) for x in (q, k, v, do))
    for x in (q, k, v):
        x.requires_grad_(True)
    o = make_allgather_attention(m, causal=causal, kind=kind)(q, k, v)
    (o * do).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def kv_sharded(q, k, v, shape, causal: bool = True, device_type: str = "cuda",
               kind: str = "bf16"):
    """`kv_sharded_attention` (kind "bf16") or `kv_sharded_attention_int8`
    ("int8") of q [B, H, t, d] (replicated over context) to the full k/v [B,
    H_kv, T, d] sharded over context; returns this rank's merged O block [B
    / data, H / model, t, d]."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    q = shard_tensor(q, ("data", "model", None, None), m).to(dev)
    k, v = (shard_tensor(x, BLOCK, m).to(dev) for x in (k, v))
    fn = kv_sharded_attention_int8 if kind == "int8" else kv_sharded_attention
    return fn(q, k, v, m, "context", causal=causal)


def ring_jvp(q, k, v, tq, tk, tv, do, dto, shape, causal: bool = False, fast: bool = False,
             device_type: str = "cuda"):
    """`ring_attention_jvp` of the full [B, H, T, d] primals and tangents on
    this rank's (batch, head, sequence) block of a `shape` mesh, and the
    gradients of sum(O * dO + tO * dtO) in all six inputs. Returns this
    rank's (O, tO, dq, dk, dv, dtq, dtk, dtv) blocks."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    ins = [shard_tensor(x, BLOCK, m).to(dev).requires_grad_(True) for x in (q, k, v, tq, tk, tv)]
    do, dto = (shard_tensor(x, BLOCK, m).to(dev) for x in (do, dto))
    o, to = ring_attention_jvp(*ins, m, "context", causal=causal, fast=fast)
    ((o * do).sum() + (to * dto).sum()).backward()
    return (o.detach(), to.detach(), *(x.grad for x in ins))


def rcm(cfg: DiTConfig, shape, params, x, t, steps: int = 1, fast: bool = True,
        device_type: str = "cuda") -> dict:
    """`steps` steps of make_dit_rcm_step(mesh=) on the whole `params` (None:
    init_dit's from seed 0 on the CPU) with this rank's (data, context)
    block of the full latents x [B, N, D] and its data block of t [B].
    Returns the losses, the step times (ms, synchronised; the first
    includes set-up), this rank's kernel launches over the steps (the counts
    set to 0 just before them), and the first step's gradients (summed over
    the ranks) and the params after it (rank 0, by dit_param_leaves' order;
    others None)."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    if params is None:
        params = init_dit(cfg, torch.Generator().manual_seed(0), "cpu")
    local = _to(params, dev)
    xb = shard_tensor(x, ("data", "context"), m).to(dev)
    tb = shard_tensor(t, ("data",), m).to(dev)
    _, step = make_dit_rcm_step(cfg, local, fast=fast, mesh=m)
    losses, times, grads, first = [], [], None, None
    _sync(dev)
    reset_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(xb, tb))
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0 and dist.get_rank() == 0:
            leaves = dit_param_leaves(local)
            grads = [p.grad.detach().cpu() for p in leaves]
            first = [p.detach().cpu() for p in leaves]
    return {"losses": [float(x) for x in losses], "step_ms": times,
            "launches": launch_counts(), "grads": grads, "params": first}


def _flat(tree) -> dict:
    """The params tree's tensors by name (embed, ..., layers.i.name)."""
    out = {key: tree[key] for key in ("embed", "unembed", "final_norm")}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{name}": t for name, t in layer.items()})
    return out


def _full_grads(params, cfg: TransformerConfig, m) -> dict | None:
    """Every parameter's gradient gathered over model (the sharded ones) to
    the whole tensor; rank 0 returns them (the gradients are the same on
    every data and context rank after the step's sum), the others None."""
    specs = _flat(param_specs(cfg))
    out = {}
    for name, t in _flat(params).items():
        g = t.grad
        if "model" in specs[name]:
            g = all_gather(g.contiguous(), m, "model", specs[name].index("model"))
        out[name] = g
    return out if dist.get_rank() == 0 else None


def train(cfg: TransformerConfig, shape, params, tokens, targets, steps: int = 1,
          attention: str = "bf16", attention_sp: str = "auto", device_type: str = "cuda",
          grads: bool = True, profile: bool = False, resume_dir: str | None = None) -> dict:
    """`steps` steps of make_sharded_train_step on this rank's shards of the
    full `params` (None: init_transformer's from seed 0 on the CPU, the same
    on every rank) and its (data, context) block of the full tokens/targets
    [B, T]. Returns the losses, the step times (ms, each synchronised; the
    first includes the first call's set-up), this rank's kernel launches
    over the steps (the counts set to 0 just before them), the step's
    strategy (`attention_sp`: "auto"'s pick) and the one each step ran
    (`ran`: the ring where a step's length does not shard), with `grads` the
    first step's gradients (rank 0: whole tensors by name; others None), and
    with `profile` one more step under torch.profiler on rank 0 (wall, device
    time, its busy share and the top device kernels). With `resume_dir` (and
    steps >= 2), the train state after step 1 is checkpointed there (the
    model-sharded params and moments as DTensors) and, after the steps,
    restored into fresh params and a fresh optimizer that take step 2 again
    (`_resume`)."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    if params is None:
        params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = shard_tensor(tokens, ("data", "context"), m).to(dev)
    tgt = shard_tensor(targets, ("data", "context"), m).to(dev)
    specs = _flat(param_specs(cfg))

    def build(full):
        local = _to(shard_params(full, cfg, m), dev)
        opt, step = make_sharded_train_step(m, cfg, local, attention=attention,
                                            attention_sp=attention_sp)
        return local, _flat(local), opt, step

    local, named, opt, step = build(params)
    losses, times, ran, first, snap = [], [], [], None, None
    _sync(dev)
    reset_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(tok, tgt))
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        ran.append(step.last_attention_sp)
        if i == 0 and grads:
            first = _full_grads(local, cfg, m)
        if i == 0 and resume_dir is not None:
            save_checkpoint(resume_dir, train_state(named, opt, m, specs))
            snap = _snapshot(named, opt)
    out = {"losses": [float(x) for x in losses], "step_ms": times, "launches": launch_counts(),
           "grads": first, "backend": dist.get_backend(), "attention_sp": step.attention_sp,
           "ran": ran}
    if profile:
        out["profile"] = _profile_step(step, tok, tgt, dev)
    if resume_dir is not None:
        fresh = init_transformer(cfg, torch.Generator().manual_seed(1), "cpu")
        _, named2, opt2, step2 = build(fresh)
        out.update(_resume(resume_dir, snap, named2, opt2, step2, tok, tgt, m, specs))
    return out


def _elapsed_ms(dev, fn, calls: int = 1) -> float:
    """ms per call of `calls` calls of fn(): CUDA events around them on the
    card (then a synchronise), the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / calls


def steady_train(cfg: TransformerConfig, shape, tokens, targets, attention: str,
                 attention_sp: str, warmup: int, steps: int,
                 device_type: str = "cuda") -> dict | None:
    """The steady step of make_sharded_train_step on init_transformer's
    params (seed 0) and this rank's block of the full tokens/targets: `warmup`
    steps, a barrier, then `steps` steps each timed on rank 0 by CUDA events
    around it (host clock on the CPU), then one step under torch.profiler on
    the last rank, the last context shard: the contiguous ring's and the
    all-gather's busiest (`_profile_step`). Rank 0 returns the step times,
    their median, the losses, the strategy picked and the ones the steps
    ran; the last rank {"profile": ...}; the others None."""
    m = mesh(shape, device_type)
    dev = local_device(device_type)
    params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    local = _to(shard_params(params, cfg, m), dev)
    del params
    tok = shard_tensor(tokens, ("data", "context"), m).to(dev)
    tgt = shard_tensor(targets, ("data", "context"), m).to(dev)
    _, step = make_sharded_train_step(m, cfg, local, attention=attention,
                                      attention_sp=attention_sp)
    losses, ran = [], []
    for _ in range(warmup):
        losses.append(step(tok, tgt))
    _sync(dev)
    dist.barrier()
    times = []
    for _ in range(steps):
        times.append(_elapsed_ms(dev, lambda: losses.append(step(tok, tgt))))
        ran.append(step.last_attention_sp)
    last = dist.get_world_size() - 1
    prof = _profile_step(step, tok, tgt, dev, rank=last)
    if dist.get_rank() == last:
        return {"profile": prof}
    if dist.get_rank() != 0:
        return None
    return {"step_ms": times, "median_ms": statistics.median(times),
            "losses": [float(x) for x in losses], "attention_sp": step.attention_sp,
            "ran": ran, "backend": dist.get_backend()}


def link_bench(shards, calls: int = 20, reps: int = 5, device_type: str = "cuda") -> dict | None:
    """The port's collectives over the context axis of a (1, 1, world) mesh:
    the ring's hop (`ppermute_start(...).wait()` of a K and a V shard, one
    batch_isend_irecv), `all_gather`, `psum_scatter` and `all_to_all`, each
    on the payload of a K/V pair of each shard (b, h_kv, t_local, d) of
    `shards` in bf16 (labelled "t{t_local}") and on 1 KB of bf16
    ("latency"). Every rank runs `reps` spans of `calls` calls after a
    barrier; rank 0 returns, per "{op}_{label}", the median ms a call (CUDA
    events) and the bytes a device sends a call (hop: the pair; all_gather
    and psum_scatter, as a ring moves them: (n - 1) / n of the gathered or
    the summed tensor; all_to_all: (n - 1) / n of its input), the others
    None."""
    n = dist.get_world_size()
    m = mesh((1, 1, n), device_type)
    dev = local_device(device_type)
    g = torch.Generator(device=dev).manual_seed(dist.get_rank())
    out = {}
    payloads = [(f"t{s[2]}", 2 * int(torch.Size(s).numel())) for s in shards]
    for label, numel in payloads + [("latency", 512)]:
        x = torch.randn((n, numel // n), generator=g, device=dev).to(torch.bfloat16)
        k, v = x.reshape(-1).chunk(2)
        pair = x.numel() * x.element_size()
        ops = {
            "hop": (lambda: ppermute_start([k, v], m, "context").wait(), pair),
            "all_gather": (lambda: all_gather(x, m, "context", 0), (n - 1) * pair),
            "psum_scatter": (lambda: psum_scatter(x, m, "context", 0), (n - 1) * pair / n),
            "all_to_all": (lambda: all_to_all(x, m, "context", 0, 0), (n - 1) * pair / n),
        }
        for op, (fn, sent) in ops.items():
            fn()
            _sync(dev)
            dist.barrier()
            ms = statistics.median(_elapsed_ms(dev, fn, calls) for _ in range(reps))
            out[f"{op}_{label}"] = {"ms": ms, "bytes": sent, "payload_bytes": pair,
                                    "bytes_per_s": sent / (ms / 1e3)}
    return out if dist.get_rank() == 0 else None


def _snapshot(named: dict, optimizer) -> dict:
    """Copies of this rank's params and optimizer state by name: what a
    checkpoint of them holds."""
    state = optimizer.state_dict()["state"]
    return {n: [named[n].detach().clone()] + [v.detach().clone() for v in state[i].values()]
            for i, n in enumerate(named)}


def _resume(path, snap, named, optimizer, step, tok, tgt, m=None, specs=None) -> dict:
    """Restore the checkpoint at `path` into the fresh `named` params and
    `optimizer`, then take one step. Returns its loss, whether the restored
    params and optimizer state equal the snapshot taken at the save bit for
    bit, and each saved param's sum (ranks that hold other shards show other
    sums)."""
    restore_train_state(load_checkpoint(path, train_state(named, optimizer, m, specs)), named,
                        optimizer)
    now = _snapshot(named, optimizer)
    equal = all(len(now[n]) == len(v) and all(torch.equal(a, b) for a, b in zip(now[n], v))
                for n, v in snap.items())
    loss = float(step(tok, tgt))
    return {"resumed_loss": loss, "restored_equal": equal,
            "saved_sums": {n: float(v[0].double().sum()) for n, v in snap.items()}}


def _to(tree, dev):
    """A copy of the tree on `dev`: the ranks' arguments may share one
    storage (tensors pass between processes in shared memory), and the
    optimizer updates the copy in place."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev, copy=True)


def _profile_step(step, tok, tgt, dev, rank: int = 0) -> dict | None:
    """One step with torch.profiler on `rank` (every rank runs it, after a
    barrier): its wall time, the device time summed over kernels, their
    share of the wall, the device time covered by the attention kernels, by
    NCCL's and by both at once (a hop running under a kernel), and the top
    device events. The other ranks return None."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    if dist.get_rank() != rank:
        dist.barrier()
        step(tok, tgt)
        _sync(dev)
        return None
    with profile(activities=acts) as prof:
        dist.barrier()
        t0 = time.perf_counter()
        step(tok, tgt)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
    device = sum(e.self_device_time_total for e in events) / 1e3
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    attn = [(a, b) for name, a, b in spans if any(k in name for k in ATTENTION_KERNELS)]
    nccl = [(a, b) for name, a, b in spans if "nccl" in name.lower()]
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "attention_ms": _covered(attn) / 1e3, "nccl_ms": _covered(nccl) / 1e3,
            "nccl_under_attention_ms": _covered(attn, nccl) / 1e3,
            "top_device": sorted(((e.key[:60], e.self_device_time_total / 1e3, e.count)
                                  for e in events), key=lambda x: -x[1])[:8]}


def _union(spans) -> list:
    """The spans (start, end) merged where they touch or overlap, in order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(spans, other=None) -> float:
    """The time covered by `spans` (the union of their (start, end)), or,
    with `other`, the time covered by both a span of each."""
    u = _union(spans)
    if other is None:
        return float(sum(b - a for a, b in u))
    total, v = 0.0, _union(other)
    for a, b in u:
        for c, d in v:
            total += max(0.0, min(b, d) - max(a, c))
    return total


_PIPE_MESHES: dict = {}


def pipe_mesh(device_type: str = "cuda"):
    """The pool's ranks as one ("pipe",) mesh, made once a device type
    (making one is a collective: every rank must ask in the same order)."""
    if device_type not in _PIPE_MESHES:
        _PIPE_MESHES[device_type] = make_pipeline_mesh(dist.get_world_size(), device_type)
    return _PIPE_MESHES[device_type]


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()).hexdigest()


def pipeline_train(cfg: TransformerConfig, params, tokens, targets, n_microbatches: int,
                   steps: int = 1, device_type: str = "cuda", grads: bool = True,
                   resume_dir: str | None = None, profile: bool = False) -> dict:
    """`steps` steps of make_pipeline_train_step, one stage a rank, from the
    full `params` (None: init_transformer's from seed 0 on the CPU) and the
    whole batch tokens/targets [B, T] on every rank. Returns the losses, the
    step times (ms, each synchronised; the first includes set-up), this
    rank's kernel launches over the steps (the counts set to 0 just before
    them), with `grads` the first step's gradients of this stage's leaves by
    name (`pipeline_named_params`: blocks under their global index), and the
    SHA-256 of each replicated leaf after the steps; with `profile` one more
    step under torch.profiler on rank 0 (as `train`'s). With `resume_dir` (and
    steps >= 2), the train state after step 1 is checkpointed there (each
    stage's blocks under their global names) and, after the steps, restored
    into fresh params and a fresh optimizer that take step 2 again
    (`_resume`)."""
    m = pipe_mesh(device_type)
    dev = local_device(device_type)
    if params is None:
        params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    tok, tgt = tokens.to(dev), targets.to(dev)

    def build(full):
        local = _to(pipeline_stage_params(full, cfg, m), dev)
        opt, step = make_pipeline_train_step(m, cfg, local, n_microbatches)
        return local, pipeline_named_params(local, cfg, m), opt, step

    local, named, opt, step = build(params)
    losses, times, first, snap = [], [], None, None
    _sync(dev)
    reset_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(tok, tgt))
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0 and grads:
            first = {n: t.grad.detach().cpu() for n, t in named.items()}
        if i == 0 and resume_dir is not None:
            save_checkpoint(resume_dir, train_state(named, opt))
            snap = _snapshot(named, opt)
    out = {"losses": [float(x) for x in losses], "step_ms": times, "launches": launch_counts(),
           "grads": first, "backend": dist.get_backend(),
           "replicated": {k: _digest(local[k]) for k in REPLICATED}}
    if profile:
        out["profile"] = _profile_step(step, tok, tgt, dev)
    if resume_dir is not None:
        fresh = init_transformer(cfg, torch.Generator().manual_seed(1), "cpu")
        _, named2, opt2, step2 = build(fresh)
        out.update(_resume(resume_dir, snap, named2, opt2, step2, tok, tgt))
    return out


def dryrun_training(device_type: str = "cuda") -> dict:
    """The training half of the JAX package's dryrun_multichip
    (__graft_entry__.py:48-135) on the pool's ranks, at its own shapes: the
    mesh from its `_factor_mesh` (4 ranks: data 1, model 2, context 2); a
    bf16 step and the int8 + GQA step with the default attention_sp="auto",
    as the dryrun's (`make_sharded_train_step(mesh, cfg)`), a Ulysses
    step on (data x model, 1, context), a zigzag step, an all-gather step
    and the int8 all-gather step (of the JAX package's strategies, the one
    that also quantizes); then the rCM half (__graft_entry__.py:226-240):
    one make_dit_rcm_step(mesh=) step on (data x model, 1, context), exact
    mode, as the dryrun's fast=False; then the pipeline half
    (__graft_entry__.py:242-260): one make_pipeline_train_step step over the
    ranks as a pipe mesh (n_layers = stages, d_model 128, 2 heads x 64,
    max_seq 128, batch 4, 2 microbatches). The Ulysses arm runs head_dim 64
    where the dryrun takes 32: no kernel takes head_dim 32 (queue B, B-f3).
    Returns each step's loss."""
    n = dist.get_world_size()
    data, model, context = n, 1, 1
    if data % 2 == 0:
        data, context = data // 2, 2
    if data % 2 == 0:
        data, model = data // 2, 2
    shape = (data, model, context)
    n_heads = max(2, model)
    seq = 256 * context
    cfg = TransformerConfig(vocab_size=128, d_model=128, n_heads=n_heads, n_kv_heads=n_heads,
                            head_dim=64, n_layers=2, max_seq=seq)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2 * data, seq), generator=g)
    targets = torch.roll(tokens, -1, 1)
    out = {"shape": shape}

    def loss(c, sp, attention="bf16", shape=shape, toks=tokens, tgts=targets, seed=0):
        params = init_transformer(c, torch.Generator().manual_seed(seed), "cpu")
        return train(c, shape, params, toks, tgts, 1, attention, sp, device_type,
                     grads=False)["losses"][0]

    out["auto"] = loss(cfg, "auto")
    gcfg = TransformerConfig(vocab_size=128, d_model=128, n_heads=2 * max(2, model),
                             n_kv_heads=max(2, model), head_dim=64, n_layers=1, max_seq=seq,
                             attention="int8")
    out["int8_gqa_auto"] = loss(gcfg, "auto", "int8", seed=4)
    if context > 1:
        ucfg = TransformerConfig(vocab_size=128, d_model=128, n_heads=context,
                                 n_kv_heads=context, head_dim=64, n_layers=1, max_seq=seq)
        utok = torch.randint(0, ucfg.vocab_size, (2 * data * model, seq), generator=g)
        out["ulysses"] = loss(ucfg, "ulysses", shape=(data * model, 1, context), toks=utok,
                              tgts=torch.roll(utok, -1, 1), seed=8)
        out["zigzag"] = loss(cfg, "zigzag")
        out["allgather"] = loss(cfg, "allgather")
        out["allgather_int8"] = loss(cfg, "allgather", "int8")
    dcfg = DiTConfig(d_model=128, n_heads=2, head_dim=64, n_layers=1, seq_len=128 * context)
    dshape = (data * model, 1, context)
    dx = torch.randn((2 * data * model, dcfg.seq_len, dcfg.d_model), generator=g)
    dt = torch.rand((2 * data * model,), generator=g)
    out["rcm"] = rcm(dcfg, dshape, init_dit(dcfg, torch.Generator().manual_seed(5), "cpu"), dx,
                     dt, 1, False, device_type)["losses"][0]
    pcfg = TransformerConfig(vocab_size=128, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                             n_layers=n, max_seq=128)
    ptok = torch.randint(0, pcfg.vocab_size, (4, pcfg.max_seq), generator=g)
    out["pipe"] = pipeline_train(pcfg, init_transformer(pcfg, torch.Generator().manual_seed(2),
                                                        "cpu"), ptok, torch.roll(ptok, -1, 1),
                                 2, 1, device_type, grads=False)["losses"][0]
    return out
