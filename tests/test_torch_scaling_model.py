"""PyTorch port vs the JAX package: the SP cost model
(parallel/scaling_model.py).

The port keeps the JAX module's formulas and changes only its constants
(H100 ones, measured on four cards by `chip_smoke.py sp_model`). With the
JAX module's v5e constants passed in, every StepCost, Prediction and
best_sp_variant pick must equal the JAX module's exactly, over a grid of
workloads (heads and GQA kv heads, t_local 128-8192, head dims 32/64/128,
2-16 context shards, bf16/int8, causal or not, train or forward only, every
allow flag). Then JAX's structural tests (tests/test_scaling_model.py)
under JAX's constants, and the ones that hold for any constants under the
port's own as well.
"""

import dataclasses
import itertools

import pytest

from quantizedattention_tpu.parallel import scaling_model as J
from quantizedattention_tpu_torch.parallel import scaling_model as S

JAX_CONSTANTS = dict(rates=J.MEASURED_RATES, link_bytes_per_s=J.ICI_BYTES_PER_S,
                     hop_latency_s=J.HOP_LATENCY_S, collective_latency_s=J.COLLECTIVE_LATENCY_S)
PORT_CONSTANTS = dict(rates=S.MEASURED_RATES, link_bytes_per_s=S.LINK_BYTES_PER_S,
                      hop_latency_s=S.HOP_LATENCY_S, collective_latency_s=S.COLLECTIVE_LATENCY_S)
CONSTANTS = {"jax": JAX_CONSTANTS, "port": PORT_CONSTANTS}

HEADS = [(16, 16), (16, 4), (8, 2), (4, 4), (32, 8)]  # (h, h_kv)
T_LOCALS, HEAD_DIMS, NS = (128, 512, 2048, 8192), (32, 64, 128), (2, 4, 8, 16)


def _workloads(h, h_kv, n, kind):
    for t_local, d, causal, train in itertools.product(T_LOCALS, HEAD_DIMS, (True, False),
                                                       (True, False)):
        yield dict(b=2, h=h, h_kv=h_kv, t_local=t_local, d=d, n=n, causal=causal, kind=kind,
                   train=train)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("h,h_kv", HEADS)
def test_model_matches_jax_with_jax_constants(h, h_kv, n, kind):
    """40 cases of 48 workloads each: the costs, the predictions of every
    variant (and predict_all's) and every pick, field for field."""
    for kw in _workloads(h, h_kv, n, kind):
        w, jw = S.SPWorkload(**kw), J.SPWorkload(**kw)
        assert w.kv_elt_bytes == jw.kv_elt_bytes and w.t_global == jw.t_global
        for variant in S.COSTS:
            assert (dataclasses.asdict(S.COSTS[variant](w))
                    == dataclasses.asdict(J.COSTS[variant](jw))), (kw, variant)
            assert (dataclasses.asdict(S.predict_step(w, variant, **JAX_CONSTANTS))
                    == dataclasses.asdict(J.predict_step(jw, variant))), (kw, variant)
        got, want = S.predict_all(w, **JAX_CONSTANTS), J.predict_all(jw)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
            {k: dataclasses.asdict(v) for k, v in want.items()}
        args = {k: kw[k] for k in ("h", "h_kv", "t_local", "d", "n", "kind", "causal")}
        for allow_ulysses, allow_zigzag in itertools.product((True, False), repeat=2):
            assert (S.best_sp_variant(**args, allow_ulysses=allow_ulysses,
                                      allow_zigzag=allow_zigzag, **JAX_CONSTANTS)
                    == J.best_sp_variant(**args, allow_ulysses=allow_ulysses,
                                         allow_zigzag=allow_zigzag)), (args, allow_ulysses,
                                                                       allow_zigzag)


def test_port_defaults_are_its_constants_not_the_tpus():
    w = S.SPWorkload(b=2, h=16, h_kv=16, t_local=2048, d=64, n=8)
    for variant in S.COSTS:
        assert S.predict_step(w, variant) == S.predict_step(w, variant, **PORT_CONSTANTS)
    assert S.best_sp_variant(16, 4, 2048, 64, 8) == S.best_sp_variant(16, 4, 2048, 64, 8,
                                                                      **PORT_CONSTANTS)
    for name in ("link_bytes_per_s", "hop_latency_s", "collective_latency_s"):
        assert PORT_CONSTANTS[name] != JAX_CONSTANTS[name], name
    assert PORT_CONSTANTS["rates"].keys() == JAX_CONSTANTS["rates"].keys()
    assert all(PORT_CONSTANTS["rates"][k] != JAX_CONSTANTS["rates"][k] for k in J.MEASURED_RATES)


# --------------------------------------------------------------------------
# JAX's tests/test_scaling_model.py
# --------------------------------------------------------------------------

def w(**kw):
    base = dict(b=2, h=16, h_kv=16, t_local=2048, d=64, n=8, causal=True,
                kind="bf16", train=True)
    base.update(kw)
    return S.SPWorkload(**base)


def test_ring_bytes_exact():
    # fwd: (n-1) hops x (k, v) bf16; bwd adds n rotations of f32 (dk, dv)
    ww = w(n=4, causal=False)
    shard = ww.b * ww.h_kv * ww.t_local * ww.d
    c = S.ring_cost(ww)
    assert c.ici_fwd == 3 * 2 * shard * 2.0
    assert c.ici_bwd == 3 * 2 * shard * 2.0 + 4 * 2 * shard * 4.0
    # non-causal fwd flops: n full hops of 4*b*h*t_loc^2*d
    assert c.flops_fwd == 4 * 4.0 * ww.b * ww.h * ww.t_local**2 * ww.d


def test_int8_ring_moves_fewer_bytes():
    bf = S.ring_cost(w())
    i8 = S.ring_cost(w(kind="int8"))
    assert i8.ici_fwd < 0.55 * bf.ici_fwd  # ~1/2 of bf16 payload + scales


def test_gqa_rides_unrepeated_heads():
    full = S.ring_cost(w())
    gqa = S.ring_cost(w(h_kv=4))
    assert gqa.ici_fwd == full.ici_fwd / 4
    assert gqa.flops_fwd == full.flops_fwd  # compute unchanged


def test_allgather_fwd_bytes_match_ring_fwd():
    # same KV payload must cross the wire either way (fwd)
    assert S.allgather_cost(w()).ici_fwd == S.ring_cost(w()).ici_fwd


def test_causal_imbalance_caps_ring_efficiency():
    # the last rank's ~n-1/2 live hops bound causal ring efficiency near
    # 0.5*(n+1)/(n-1/2) even with infinite bandwidth
    p = S.predict_step(w(n=32), "ring", **{**JAX_CONSTANTS, "link_bytes_per_s": 1e18})
    assert p.efficiency == pytest.approx(0.5 * 33 / 31.5, rel=1e-3)


def test_ulysses_balanced_causal():
    preds = S.predict_all(w(n=8), **JAX_CONSTANTS)
    assert preds["ulysses"].efficiency > preds["ring"].efficiency
    assert preds["ulysses"].efficiency > 0.9


def test_best_variant_respects_divisibility():
    assert S.best_sp_variant(16, 16, 2048, 64, n=8, **JAX_CONSTANTS) == "ulysses"
    # n > h_kv: ulysses impossible -> zigzag/ring/allgather fallback
    got = S.best_sp_variant(16, 4, 2048, 64, n=8, **JAX_CONSTANTS)
    assert got in ("ring", "allgather", "zigzag")
    assert S.best_sp_variant(16, 16, 2048, 64, n=8, allow_ulysses=False,
                             allow_zigzag=False, **JAX_CONSTANTS) in ("ring", "allgather")


@pytest.mark.parametrize("constants", ["jax", "port"])
def test_efficiency_decreases_with_n_for_ring(constants):
    effs = [S.predict_step(w(n=n), "ring", **CONSTANTS[constants]).efficiency
            for n in (2, 4, 8, 16)]
    assert all(a >= b for a, b in zip(effs, effs[1:]))


def test_zigzag_balanced_and_ring_bytes():
    ww = w(n=16)
    zz, rr = S.zigzag_cost(ww), S.ring_cost(ww)
    assert zz.ici_fwd == rr.ici_fwd and zz.ici_bwd == rr.ici_bwd
    # balanced: way below the contiguous ring's last-rank-bound flops
    assert zz.flops_fwd < 0.6 * rr.flops_fwd
    p = S.predict_step(ww, "zigzag", **{**JAX_CONSTANTS, "link_bytes_per_s": 1e18})
    assert p.efficiency > 0.99  # no imbalance penalty at infinite bandwidth


@pytest.mark.parametrize("constants", ["jax", "port"])
def test_zigzag_bytes_equal_ring_bytes(constants):
    """For any constants: the striped ring moves the contiguous ring's bytes
    in as many hops, so with its balanced FLOPs it is never predicted
    slower."""
    for n in NS:
        ww = w(n=n)
        zz, rr = S.zigzag_cost(ww), S.ring_cost(ww)
        assert (zz.ici_fwd, zz.ici_bwd, zz.hops_fwd, zz.hops_bwd) == \
            (rr.ici_fwd, rr.ici_bwd, rr.hops_fwd, rr.hops_bwd)
        assert (S.predict_step(ww, "zigzag", **CONSTANTS[constants]).t_step_s
                <= S.predict_step(ww, "ring", **CONSTANTS[constants]).t_step_s)


def test_best_variant_prefers_balanced_causal():
    # with ulysses disallowed (e.g. too few heads), causal training should
    # pick zigzag over the imbalanced contiguous ring
    got = S.best_sp_variant(16, 4, 2048, 64, n=8, allow_ulysses=False, **JAX_CONSTANTS)
    assert got == "zigzag"
