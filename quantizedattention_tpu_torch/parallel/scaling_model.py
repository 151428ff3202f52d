"""Analytic link-bytes / FLOPs model of the sequence-parallel attention
strategies, and the pick `make_sharded_train_step(attention_sp="auto")`
takes from it.

Counterpart of quantizedattention_tpu/parallel/scaling_model.py: the same
closed-form per-device byte and FLOP counts, as functions of (b, h, h_kv,
t_local, d, n), for every SP strategy the train step has, combined with
kernel rates and link constants into a predicted step time. Only the
constants differ: the JAX module's are a TPU v5e's (ICI, its kernels'
rates); these were measured on four NVIDIA H100s over NCCL by
`python3 chip_smoke.py sp_model` (each constant names its run below). Every
function takes every constant as an argument, so a caller can plug in other
cards' values (the tests plug in the JAX module's and get its numbers back
exactly).

Byte counts follow the collectives each strategy issues (cited per function);
FLOP counts are matmul FLOPs (2*M*N*K per dot). The model captures two
first-order effects:

  * CAUSAL LOAD IMBALANCE: ring and all-gather SP keep each rank's q shard
    fixed, so rank i computes ~(i + 1/2) live hops of work — the step is
    bound by the LAST rank (~n - 1/2 hops). Ulysses re-shards by head (full
    sequence per rank) and the zigzag ring stripes chunk pairs
    (parallel/zigzag.py): both keep causal work balanced.
  * OVERLAP STRUCTURE: the ring posts each hop before the step's kernel
    (parallel/ring.py:ring_steps), so exposed time is max(compute, comm);
    all-gather and Ulysses block on their collectives (comm + compute).

What the port's implementations do that the model does not count is in
PERF.md (§6, PR 24) and ROADMAP.md (A item 4): the formulas and the
`overlapped` flags are the JAX module's, unchanged.
"""

from __future__ import annotations

import dataclasses

# -- NVIDIA H100 constants, measured (see the module docstring) -------------
# Every value below is what `python3 chip_smoke.py sp_model` printed on four
# "NVIDIA H100 80GB HBM3, 700.00 W" cards (nvidia-smi), one rank a card over
# NCCL, 18 NVLinks a card, every pair peer-accessible (PR 24, chip run 3).
#
# The ring's hop (parallel/mesh.py:ppermute_start, then wait) of a K/V shard
# pair at TRAIN_CFG's t_local 2048 (32 MiB of bf16): 0.5038 ms a hop, so
# 6.6603e10 B/s sent a device. It is host-bound: 8 MiB took 0.6670 ms.
LINK_BYTES_PER_S = 6.6603e10
# The same hop of 1 KB: 0.55321 ms a hop, eager, host-issued.
HOP_LATENCY_S = 5.5321e-4
# The mean of all_gather (0.30207 ms), psum_scatter (0.29983 ms) and
# all_to_all (0.20129 ms) of 1 KB (parallel/mesh.py).
COLLECTIVE_LATENCY_S = 2.6773e-4
# attention_flops over the time of each kernel call at (4, 16, 4096, 64)
# causal, by utils/profiling.py (CUDA-graph replays): bf16 fwd = B1 (f32 q,
# bf16 K/V), 0.458 ms; bf16 bwd = the fast backward's prep + B2 + B3,
# 1.2107 ms; int8 fwd = sage_attention_int8 (K mean, B4, B5), 0.721 ms;
# int8 bwd = B7 + B8, 1.3665 ms. The backward rates are 2.5 x the forward
# FLOPs over the backward's time, as the JAX module's.
MEASURED_RATES = {
    ("bf16", "fwd"): 2.9979e14,
    ("bf16", "bwd"): 2.8379e14,
    ("int8", "fwd"): 1.9062e14,
    ("int8", "bwd"): 2.5144e14,
}


@dataclasses.dataclass(frozen=True)
class SPWorkload:
    """One attention layer's sequence-parallel training step, per device."""

    b: int                 # global batch on this device's data slice
    h: int                 # q heads on this device's model slice
    h_kv: int              # kv heads (GQA: h_kv <= h rides the wire)
    t_local: int           # tokens per context shard
    d: int                 # head dim
    n: int                 # context shards
    causal: bool = True
    kind: str = "bf16"     # "bf16" | "int8" — wire format of the KV payload
    train: bool = True     # include the backward

    @property
    def kv_elt_bytes(self) -> float:
        # int8 payload + one f32 scale per 1024-token quantization block
        return 1.0 + 4.0 / (1024 * self.d) if self.kind == "int8" else 2.0

    @property
    def t_global(self) -> int:
        return self.t_local * self.n


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Per-device cost of one step: FLOPs of the SLOWEST rank, exact link
    bytes sent per device (`ici_*`: the JAX module's names), and the
    hop/collective count for latency."""

    flops_fwd: float
    flops_bwd: float
    ici_fwd: float
    ici_bwd: float
    hops_fwd: int
    hops_bwd: int
    overlapped: bool  # comm issued before compute it can hide behind


def _hop_flops(w: SPWorkload) -> float:
    """Matmul FLOPs of one full (non-causal) t_local x t_local attention
    hop: QK^T + PV, 2*2*b*h*t_local^2*d."""
    return 4.0 * w.b * w.h * w.t_local * w.t_local * w.d


def _live_hops(w: SPWorkload) -> float:
    """Causal: the slowest rank (idx n-1) runs n-1 full hops plus the
    half-masked diagonal hop; non-causal: n full hops."""
    return (w.n - 0.5) if w.causal else float(w.n)


_BWD_FLOPS_FACTOR = 2.5  # FA2 backward ~2.5x the forward matmul FLOPs


def ring_cost(w: SPWorkload) -> StepCost:
    """parallel/ring.py (`_Ring`): the forward rotates the (k, v) payload
    n-1 times (`ring_steps`; int8: payloads and scale tables); the backward
    rotates it n-1 times again AND the f32 (dk, dv) accumulators n times.
    GQA rotates the unrepeated h_kv heads."""
    shard = w.b * w.h_kv * w.t_local * w.d
    ici_fwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes
    ici_bwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes + w.n * 2 * shard * 4.0
    return StepCost(
        flops_fwd=_hop_flops(w) * _live_hops(w),
        flops_bwd=_BWD_FLOPS_FACTOR * _hop_flops(w) * _live_hops(w) if w.train else 0.0,
        ici_fwd=ici_fwd,
        ici_bwd=ici_bwd if w.train else 0.0,
        hops_fwd=w.n - 1,
        hops_bwd=2 * w.n - 1 if w.train else 0,
        overlapped=True,
    )


def allgather_cost(w: SPWorkload) -> StepCost:
    """parallel/collective.py (`_AllGatherKV`, `_AllGatherKVInt8`): the
    forward all-gathers the n-1 remote K/V shards (int8: the payloads and
    scale tables); the backward reduce-scatters the f32 dK/dV home
    (`psum_scatter`; a ring reduce moves ~(n-1) shard-sizes per device)."""
    shard = w.b * w.h_kv * w.t_local * w.d
    ici_fwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes
    ici_bwd = (w.n - 1) * 2 * shard * 4.0
    return StepCost(
        flops_fwd=_hop_flops(w) * _live_hops(w),
        flops_bwd=_BWD_FLOPS_FACTOR * _hop_flops(w) * _live_hops(w) if w.train else 0.0,
        ici_fwd=ici_fwd,
        ici_bwd=ici_bwd if w.train else 0.0,
        hops_fwd=2,       # two all-gathers
        hops_bwd=2 if w.train else 0,  # two reduce-scatters
        overlapped=False,
    )


def ulysses_cost(w: SPWorkload) -> StepCost:
    """parallel/ulysses.py: three input all_to_alls (q, k, v re-shard
    seq->head) + one output all_to_all (o, f32) forward (`_AllToAll`); the
    backward repeats them reversed. Each all_to_all moves (n-1)/n of the
    local tensor. Requires n <= h_kv; causal work is BALANCED (every rank
    holds the full sequence for its heads)."""
    frac = (w.n - 1) / w.n
    qkv_bytes = (w.b * w.h * w.t_local * w.d          # q at input dtype (2B)
                 + 2 * w.b * w.h_kv * w.t_local * w.d) * 2.0
    o_bytes = w.b * w.h * w.t_local * w.d * 4.0       # o / do are f32
    ici_fwd = frac * (qkv_bytes + o_bytes)
    ici_bwd = frac * (qkv_bytes + o_bytes)            # transposed a2a set
    causal_factor = 0.5 if w.causal else 1.0
    flops_fwd = _hop_flops(w) * w.n * causal_factor   # balanced: true halving
    return StepCost(
        flops_fwd=flops_fwd,
        flops_bwd=_BWD_FLOPS_FACTOR * flops_fwd if w.train else 0.0,
        ici_fwd=ici_fwd,
        ici_bwd=ici_bwd if w.train else 0.0,
        hops_fwd=4,
        hops_bwd=4 if w.train else 0,
        overlapped=False,
    )


def zigzag_cost(w: SPWorkload) -> StepCost:
    """parallel/zigzag.py: the striped causal ring. Same wire traffic as the
    contiguous ring (the two-chunk kv pair totals t_local tokens per hop;
    bwd adds the f32 dk/dv pair rotations), but causal work is BALANCED:
    every rank computes exactly 2n+1 half-hop [c x c] pieces, i.e.
    (2n+1)/(2n) of the ideal balanced causal FLOPs. Non-causal degenerates
    to the plain ring."""
    if not w.causal:
        return ring_cost(w)
    shard = w.b * w.h_kv * w.t_local * w.d
    ici_fwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes
    ici_bwd = (w.n - 1) * 2 * shard * w.kv_elt_bytes + w.n * 2 * shard * 4.0
    # exactly the ideal balanced causal work (2 diagonal halves + 2n-1 full
    # [c x c] pieces = 2n*c^2 pair units) — expressed with the same
    # (1 + 1/n) diagonal convention predict_step's ideal uses, so the
    # efficiency reflects only communication exposure
    flops_fwd = _hop_flops(w) * w.n * 0.5 * (1.0 + 1.0 / w.n)
    return StepCost(
        flops_fwd=flops_fwd,
        flops_bwd=_BWD_FLOPS_FACTOR * flops_fwd if w.train else 0.0,
        ici_fwd=ici_fwd,
        ici_bwd=ici_bwd if w.train else 0.0,
        hops_fwd=w.n - 1,
        hops_bwd=2 * w.n - 1 if w.train else 0,
        overlapped=True,
    )


COSTS = {"ring": ring_cost, "allgather": allgather_cost, "ulysses": ulysses_cost,
         "zigzag": zigzag_cost}


@dataclasses.dataclass(frozen=True)
class Prediction:
    t_comp_s: float
    t_comm_s: float
    t_step_s: float
    efficiency: float   # ideal balanced compute time / predicted step time


def predict_step(
    w: SPWorkload,
    variant: str,
    rates: dict | None = None,
    link_bytes_per_s: float = LINK_BYTES_PER_S,
    hop_latency_s: float = HOP_LATENCY_S,
    collective_latency_s: float = COLLECTIVE_LATENCY_S,
) -> Prediction:
    """Predicted per-step wall time of one attention layer and its weak-
    scaling efficiency.

    efficiency = T_ideal / T_pred, where T_ideal is the perfectly balanced
    causal compute time (total FLOPs / n / rate) — so both exposed
    communication AND causal load imbalance count against the strategy.
    """
    rates = rates or MEASURED_RATES
    cost = COSTS[variant](w)
    r_fwd = rates[(w.kind, "fwd")]
    r_bwd = rates[(w.kind, "bwd")]
    t_comp = cost.flops_fwd / r_fwd + (cost.flops_bwd / r_bwd if w.train else 0.0)
    t_comm = (cost.ici_fwd + cost.ici_bwd) / link_bytes_per_s
    latency = (cost.hops_fwd + cost.hops_bwd) * (
        hop_latency_s if cost.overlapped else collective_latency_s
    )
    if cost.overlapped:
        t_step = max(t_comp, t_comm) + latency
    else:
        t_step = t_comp + t_comm + latency
    # ideal: causal work perfectly balanced over ranks
    causal_factor = 0.5 * (1.0 + 1.0 / w.n) if w.causal else 1.0
    ideal_fwd = _hop_flops(w) * w.n * causal_factor / r_fwd
    ideal = ideal_fwd * (1.0 + (_BWD_FLOPS_FACTOR * r_fwd / r_bwd if w.train else 0.0))
    return Prediction(
        t_comp_s=t_comp,
        t_comm_s=t_comm,
        t_step_s=t_step,
        efficiency=min(1.0, ideal / t_step),
    )


def predict_all(w: SPWorkload, **kw) -> dict:
    out = {}
    for variant in COSTS:
        if variant == "ulysses" and w.n > w.h_kv:
            continue  # head-divisibility constraint
        out[variant] = predict_step(w, variant, **kw)
    return out


def best_sp_variant(
    h: int,
    h_kv: int,
    t_local: int,
    d: int,
    n: int,
    kind: str = "bf16",
    causal: bool = True,
    allow_ulysses: bool = True,
    allow_zigzag: bool = True,
    rates: dict | None = None,
    link_bytes_per_s: float = LINK_BYTES_PER_S,
    hop_latency_s: float = HOP_LATENCY_S,
    collective_latency_s: float = COLLECTIVE_LATENCY_S,
) -> str:
    """Predicted-best TRAIN-STEP strategy among those the train step can use
    ("ring" | "allgather" | "ulysses" | "zigzag" — models/sharded_train.py's
    attention_sp knob; zigzag is considered only when `allow_zigzag` and the
    workload is causal, since the striped layout exists to balance causal
    work). Batch cancels (comm and comp both scale linearly), so it is not
    needed: JAX's rule, kept, though the latencies do not scale with the
    batch, and under the H100's the pick at b = 1 can differ from the one at
    a step's batch (PERF.md §7). The constants are predict_step's.
    """
    w = SPWorkload(b=1, h=h, h_kv=h_kv, t_local=t_local, d=d, n=n,
                   causal=causal, kind=kind)
    cands = ["ring", "allgather"]
    if allow_ulysses and n <= h_kv and h % n == 0 and h_kv % n == 0:
        cands.append("ulysses")
    if allow_zigzag and causal:
        cands.append("zigzag")
    preds = {v: predict_step(w, v, rates, link_bytes_per_s, hop_latency_s,
                             collective_latency_s) for v in cands}
    return min(preds, key=lambda v: preds[v].t_step_s)
