"""PyTorch port vs the JAX package: B1's "beta" and "none" corrections.

The same numpy inputs go to the JAX forward (its Pallas kernel in interpret
mode on the CPU, as the JAX package's own tests run it) and to the port's
`flash_attention_fwd` / `flash_attention_fwd_fp32`, which on CPU tensors run
the plain version. The CUDA kernel is held against that plain version on the
card by chip_smoke.py (phase 31).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu import flash_attention_bf16 as jax_flash_bf16
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd as jax_flash_fwd
from quantizedattention_tpu.quantize.bf16_correction import amplify_tied_max as jax_amplify
from quantizedattention_tpu.tune.config import default_block_config
from quantizedattention_tpu_torch.ops import (
    flash_attention_bf16,
    flash_attention_fwd,
    flash_attention_fwd_fp32,
)
from quantizedattention_tpu_torch.quantize import APPROX_MAX_TOL, BETA, amplify_tied_max
from quantizedattention_tpu_torch.tune.config import correction_grain

torch.set_num_threads(2)

# bf16: the eps parity tolerances of tests/test_torch_kernels.py (the tiled
# JAX kernel and the plain version round P against maxima taken over other
# key ranges: O moves by a few 1e-3, lse by far less). A tie decision that
# flips at the tol edge changes m, and with it only where P is rounded.
O_TOL, LSE_TOL = 5e-3, 1e-3
# fp32: tests/test_torch_jvp.py's EXACT_TOL (summation order only), as
# max|diff| / max|want| for O and max|diff| for lse.
FP32_TOL = 1e-4
# exact-mode gradients: tests/test_torch_train.py's EXACT_TOL, of max|JAX| (the
# backward is fp32 on both sides; only the forward's O and lse carry the rule)
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_correction_grain_matches_jax(precision):
    kind = "bf16" if precision == "bf16" else "fp32"
    for t in (1, 77, 128, 300, 1000, 2048, 4096):
        for s in (1, 100, 128, 384, 640, 1152, 1280, 2048, 4096, 8192, 9000):
            for rep in (1, 2, 3, 4, 8, 16):
                cfg = default_block_config(kind, t, s).clamp_rep(rep)
                want = min(cfg.kv_compute, cfg.block_kv)
                got = correction_grain(t, s, rep, precision)
                assert got == want and got % 128 == 0, (t, s, rep)
    with pytest.raises(ValueError):
        correction_grain(128, 128, 1, "fp16")


def test_amplify_tied_max_matches_jax():
    rng = np.random.default_rng(5)
    s = rng.standard_normal((3, 16, 40), np.float32)
    s[0, :, 7] = s[0, :, 3] = 4.0  # tied positive maxima
    s[1, :, :] = -2.0  # a row of equal negative logits: amplified to 0
    m = s.max(-1, keepdims=True)
    got = amplify_tied_max(_t(s), _t(m))
    want = np.asarray(jax_amplify(jnp.asarray(s), jnp.asarray(m), beta=BETA, tol=APPROX_MAX_TOL))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[0] == 8.0).all() and (got.numpy()[1] == 0.0).all()


def _tied_inputs(b, h, h_kv, t, s, d, seed):
    """Unit-normal q, k, v with duplicated large keys, so that many rows'
    maxima tie (the rule fires) in the first and the last key group."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, d), np.float32)
    k = rng.standard_normal((b, h_kv, s, d), np.float32)
    v = rng.standard_normal((b, h_kv, s, d), np.float32)
    u = rng.standard_normal((b, h_kv, 2, d), np.float32) * 2.0
    k[:, :, 3] = k[:, :, 9] = u[:, :, 0]
    k[:, :, s - 5] = k[:, :, s - 2] = u[:, :, 1] * 1.2
    return q, k, v


def _fired(fwd, q, k, v, causal):
    """Rows where the rule fired: the output differs from the same grouped
    forward with a tolerance no logit meets (tol = -inf)."""
    o, _ = fwd(q, k, v, causal, "beta", np.inf)
    o_off, _ = fwd(q, k, v, causal, "beta", -np.inf)
    return (np.asarray(o) != np.asarray(o_off)).any(-1)


def _jax(precision):
    def fwd(q, k, v, causal, correction, tol=APPROX_MAX_TOL):
        tol = APPROX_MAX_TOL if tol == np.inf else tol
        return jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             precision=precision, correction=correction, tol=tol)
    return fwd


def _port(precision):
    def fwd(q, k, v, causal, correction, tol=APPROX_MAX_TOL):
        tol = APPROX_MAX_TOL if tol == np.inf else tol
        if precision == "fp32":
            return flash_attention_fwd_fp32(_t(q), _t(k), _t(v), causal, correction=correction,
                                            tol=tol)
        return flash_attention_fwd(_t(q), _t(k), _t(v), causal, correction=correction, tol=tol)
    return fwd


RULE_CASES = [  # (precision, head_dim, causal): s = 1152 keys, three groups in both modes' grain
    ("bf16", 64, True), ("bf16", 64, False), ("bf16", 128, True), ("bf16", 128, False),
    ("fp32", 64, True), ("fp32", 64, False), ("fp32", 128, True),
]


@pytest.mark.parametrize("correction", ["beta", "none"])
@pytest.mark.parametrize("precision,d,causal", RULE_CASES,
                         ids=[f"{p}-d{d}-{'causal' if c else 'full'}" for p, d, c in RULE_CASES])
def test_rules_plain_match_jax(correction, precision, d, causal):
    """GQA rep 2 on 1152 keys (three groups of 384 keys in bf16 mode, 512 +
    512 + 128 in fp32 mode) with tied maxima in the first and last group."""
    b, h, h_kv, t, s = 1, 2, 1, 128, 1152
    assert s // correction_grain(t, s, h // h_kv, precision) >= 2
    q, k, v = _tied_inputs(b, h, h_kv, t, s, d, seed=d + 7 * causal)
    o_j, lse_j = _jax(precision)(q, k, v, causal, correction)
    o_t, lse_t = _port(precision)(q, k, v, causal, correction)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    assert o_t.shape == (b, h, t, d) and lse_t.shape == (b, h, t)
    if precision == "bf16":
        assert np.abs(o_t.numpy() - o_j).max() <= O_TOL
        assert np.abs(lse_t.numpy() - lse_j).max() <= LSE_TOL
    else:
        assert np.abs(o_t.numpy() - o_j).max() <= FP32_TOL * np.abs(o_j).max()
        assert np.abs(lse_t.numpy() - lse_j).max() <= FP32_TOL


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_beta_fires_on_the_same_rows(precision):
    """The duplicated keys make the rule fire, in both packages, on the same
    rows: those whose maximum is a duplicated key."""
    q, k, v = _tied_inputs(1, 2, 1, 128, 1152, 64, seed=3)
    fired_j = _fired(_jax(precision), q, k, v, True)
    fired_t = _fired(_port(precision), q, k, v, True)
    assert 0.1 < fired_t.mean() < 1.0
    np.testing.assert_array_equal(fired_t, fired_j)


def test_beta_extreme_logits_collapse_as_in_jax():
    """JAX's tests/test_bf16_attention.py:101-127 on the port: a row whose
    8 exactly tied keys sit at exp2-domain logit ~200. "eps" and "none"
    recover the tie average; "beta" amplifies the max to ~400, every P of
    the row underflows, O is 0 and the lse is finite and ~200 above eps's."""
    rng = np.random.default_rng(42)
    d, t = 64, 128
    q, k, v = (rng.standard_normal((1, 1, t, d), np.float32) for _ in range(3))
    u = np.ones(d, np.float32) / np.sqrt(d)
    amp = np.sqrt(200.0 * np.sqrt(d) / 1.4426950408889634)
    q[0, 0, -1] = u * amp
    k[0, 0, :8] = u * amp
    want_row = v[0, 0, :8].mean(0)
    outs = {c: [x.numpy() for x in flash_attention_fwd(_t(q), _t(k), _t(v), correction=c)]
            for c in ("eps", "none", "beta")}
    assert np.abs(outs["eps"][0][0, 0, -1] - want_row).max() < 2e-2
    assert np.abs(outs["none"][0][0, 0, -1] - want_row).max() < 2e-2
    assert np.abs(outs["beta"][0][0, 0, -1] - want_row).max() > 0.5
    assert (outs["beta"][0][0, 0, -1] == 0).all() and np.isfinite(outs["beta"][1]).all()
    assert outs["beta"][1][0, 0, -1] - outs["eps"][1][0, 0, -1] > 50.0
    o_j, lse_j = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), correction="beta")
    np.testing.assert_allclose(outs["beta"][0], np.asarray(o_j), atol=O_TOL)
    np.testing.assert_allclose(outs["beta"][1], np.asarray(lse_j), atol=LSE_TOL)


def test_beta_gradients_match_jax():
    """flash_attention_bf16(correction="beta", bwd_exact=True): the backward
    recomputes P from the saved lse, so the rule reaches the gradients through
    lse and O."""
    rng = np.random.default_rng(11)
    q, k, v = _tied_inputs(1, 2, 1, 96, 200, 64, seed=11)
    do = rng.standard_normal(q.shape, np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash_bf16(q_, k_, v_, causal=True, correction="beta",
                                      bwd_exact=True) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    o = flash_attention_bf16(qt, kt, vt, causal=True, correction="beta", bwd_exact=True)
    (o * _t(do)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= GRAD_TOL * np.abs(w).max()


def test_unknown_rule_is_refused():
    q = torch.zeros((1, 1, 4, 64))
    for fwd in (flash_attention_fwd, flash_attention_fwd_fp32):
        with pytest.raises(ValueError, match="correction"):
            fwd(q, q, q, correction="gamma")
