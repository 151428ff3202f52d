"""PyTorch port vs the JAX package: utils/profiling.py.

The FLOP count and the KernelTiming record are the JAX module's; its chained
TPU timer becomes `graph_seconds` (CUDA-graph replays between CUDA events on
the card, which only a chip run exercises: chip_smoke.py sp_model times the
SP kernels' rates with it). On the CPU the timer takes host-clock medians,
which is what these tests can call.
"""

import itertools

import pytest
import torch

from quantizedattention_tpu.utils import profiling as J
from quantizedattention_tpu_torch import utils
from quantizedattention_tpu_torch.ops import flash_attention_bf16
from quantizedattention_tpu_torch.utils import profiling as P

torch.set_num_threads(2)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_flops_matches_jax(causal):
    for b, h, t, s, d in itertools.product((1, 4), (1, 16), (1, 77, 4096), (1, 201, 8192),
                                           (32, 64, 128)):
        assert P.attention_flops(b, h, t, s, d, causal) == J.attention_flops(b, h, t, s, d,
                                                                             causal)


@pytest.mark.parametrize("util", [None, 0.42])
def test_kernel_timing_reads_as_jax(util):
    assert str(P.KernelTiming(1.25e-3, 310.5, util)) == str(J.KernelTiming(1.25e-3, 310.5, util))


def test_graph_seconds_on_the_cpu_is_a_positive_median():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    sec = P.graph_seconds(fn, torch.ones(8), calls=3, reps=4)
    assert sec > 0 and len(calls) == 1 + 3 * 4  # one warm-up call, then reps x calls


def test_time_attention_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 64, 64), generator=g) for _ in range(3))
    got = P.time_attention(lambda q, k, v: flash_attention_bf16(q, k, v, causal=True), q, k, v,
                           causal=True, calls=2)
    assert isinstance(got, P.KernelTiming) and got.seconds > 0
    assert got.tflops == pytest.approx(P.attention_flops(1, 2, 64, 64, 64, True)
                                       / got.seconds / 1e12)
    assert got.utilization is None  # no card's peak on the CPU


def test_peaks_and_exports():
    """The H100's dense peaks (PERF.md's bounds use the same) and the
    package's exports, as the JAX package's utils exports its module."""
    assert P._PEAKS_TFLOPS["NVIDIA H100 80GB HBM3"] == {"bf16": 989.0, "int8": 1979.0}
    for name in ("KernelTiming", "attention_flops", "graph_seconds", "time_attention"):
        assert getattr(utils, name) is getattr(P, name)
