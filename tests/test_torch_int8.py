"""PyTorch port vs the JAX package: the int8 (SageAttention) fine-tuning slice.

The same numpy inputs go to the JAX package (Pallas kernels in interpret
mode on the CPU, as its own tests run them) and to the port, which on CPU
tensors runs its kernels' plain versions. The CUDA kernels themselves are
held against those plain versions on the card by chip_smoke.py.

Covered: the int8 scale grain (`tune.config.int8_grain`), the quantizers
(B4's plain version byte for byte), the int8 forward (B5) and backward (B7,
B8) on the same residuals, autograd through `sage_attention_int8` against
jax.grad, the JAX package's own oracle criteria (tests/test_int8_attention.py)
on the port, the wrappers' CPU behaviour, and the LM with attention="int8":
loss, gradients and AdamW steps against the JAX `make_train_step`, and
BASELINE config 4's gradient-norm stability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu import sage_attention_int8 as jax_sage_int8
from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd as jax_int8_bwd
from quantizedattention_tpu.ops.int8_fwd import (
    int8_attention_fwd_from_quantized as jax_int8_fwd_from_quantized,
)
from quantizedattention_tpu.ops.int8_fwd import quantize_qkv as jax_quantize_qkv
from quantizedattention_tpu.quantize import int8 as jq
from quantizedattention_tpu.quantize.smoothing import k_smooth as jax_k_smooth
from quantizedattention_tpu.tune.config import default_block_config
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    init_transformer,
    lm_loss,
    make_train_step,
    param_leaves,
    params_from_jax,
)
from quantizedattention_tpu_torch.ops import (
    int8_attention_bwd,
    int8_attention_bwd_plain,
    int8_attention_fwd,
    int8_attention_fwd_from_quantized,
    int8_attention_fwd_from_quantized_plain,
    int8_bwd_dkv,
    int8_bwd_dq,
    int8_bwd_operands,
    quantize_qkv,
    quantize_qkv_plain,
    sage_attention_int8,
)
from quantizedattention_tpu_torch.ops import int8_bwd as tbwd
from quantizedattention_tpu_torch.ops import int8_fwd as tfwd
from quantizedattention_tpu_torch.quantize import int8 as tq
from quantizedattention_tpu_torch.quantize.smoothing import k_smooth
from quantizedattention_tpu_torch.reference import reference_attention, reference_attention_vjp
from quantizedattention_tpu_torch.tune.config import int8_grain
from quantizedattention_tpu_torch.utils.testing import mismatch_report

torch.set_num_threads(2)

# B5 plain vs the JAX kernel on the same residuals: the tolerances of the B1
# parity tests (test_torch_kernels.py). Only the summation order and where P
# is rounded to bf16 differ (per kv grain in JAX, per row here); measured
# max |dO| 5.8e-4, max |dlse| 5.3e-4 on these cases (the 1100-token one).
O_TOL, LSE_TOL = 5e-3, 1e-3
# B7/B8 plain vs the JAX kernels on the same residuals, k_mean, O, lse and
# dO, as max |diff| / max |JAX| per tensor: both round P, dO and dS to bf16
# at the same points, so only the f32 summation order differs, which can tip
# one bf16 rounding of a P or dS entry. Measured at most 1.9e-4 (dv).
BWD_REL = 1e-3
# Autograd against jax.grad: the two sides take k_mean with different
# summation orders (trap 3), so a few K payload entries can land one
# quantization step apart; measured relative L2 at most 5.8e-5.
GRAD_REL_L2 = 1e-3
# The JAX package's oracle criteria for int8 attention
# (tests/test_int8_attention.py): forward mismatch rate at atol 5e-2, and
# the gradients' relative L2 against the fp32 oracle.
ORACLE_ATOL, ORACLE_RATE, ORACLE_GRAD_REL_L2 = 5e-2, 2e-3, 0.06


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(b, h, h_kv, t, s, seed=None):
    rng = np.random.default_rng(1000 * t + s + h if seed is None else seed)
    q = rng.standard_normal((b, h, t, 64), np.float32)
    k = rng.standard_normal((b, h_kv, s, 64), np.float32)
    v = rng.standard_normal((b, h_kv, s, 64), np.float32)
    do = rng.standard_normal((b, h, t, 64), np.float32)
    return q, k, v, do


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _residuals_to_torch(res):
    return tuple((_t(x), _t(s)) for x, s in res)


# --------------------------------------------------------------------------
# The scale grain
# --------------------------------------------------------------------------

GRAIN_LENGTHS = (96, 128, 200, 256, 512, 1000, 2048)


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_int8_grain_matches_jax_block_config(rep):
    """Q gets one scale per block_q tokens and is padded to block_q; K/V one
    per kv_compute tokens, padded to block_kv, as the JAX quantizer takes
    them from default_block_config("int8", ...).clamp_rep(rep)."""
    for t in GRAIN_LENGTHS:
        for s in GRAIN_LENGTHS:
            cfg = default_block_config("int8", t, s, 64).clamp_rep(rep)
            q_pad = -(-t // cfg.block_q) * cfg.block_q
            kv_pad = -(-s // cfg.block_kv) * cfg.block_kv
            want = (cfg.block_q, min(cfg.kv_compute, kv_pad), q_pad, kv_pad)
            assert int8_grain(t, s, rep) == want, (t, s, rep)


@pytest.mark.parametrize("t,rep,want", [
    (2048, 1, (1024, 1024, 2048, 2048)),
    (2048, 2, (1024, 1024, 2048, 2048)),
    (2048, 4, (512, 1024, 2048, 2048)),
    (1000, 4, (512, 1024, 1024, 1024)),
    (1000, 1, (1024, 1024, 1024, 1024)),
    (512, 4, (512, 512, 512, 512)),
    (1100, 4, (512, 384, 1536, 1152)),
])
def test_int8_grain_table(t, rep, want):
    assert int8_grain(t, t, rep) == want


# --------------------------------------------------------------------------
# B4: the quantizers, byte for byte
# --------------------------------------------------------------------------

def _half_step_blocks():
    """[3, 256, 64]: an all-zero block (the 1e-12 scale floor), a block whose
    scale is exactly 1 (absmax 127) holding values at exact half steps
    (round half to even), and unit-normal blocks around a large mean."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 256, 64)).astype(np.float32) + 4.0
    x[0, :128] = 0.0
    x[1, :128] = rng.integers(-126, 126, (128, 64)).astype(np.float32) + 0.5
    x[1, 0, 0] = 127.0
    x[1, 1, :6] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    return x


@pytest.mark.parametrize("with_sub", [False, True])
def test_quant_plain_matches_jax_fused_quantizer(with_sub):
    x = _half_step_blocks()
    sub = x.mean(axis=1, keepdims=True) if with_sub else None
    xi_j, s_j = jq.quantize_int8_blocks_fused(
        jnp.asarray(x), 128, sub=None if sub is None else jnp.asarray(sub), interpret=True)
    job = tq.QuantJob(_t(x), 256, 128, None if sub is None else _t(sub[:, 0]))
    ((xi_t, s_t),) = tq.quant_int8_plain([job])
    assert xi_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert np.array_equal(xi_t.numpy(), np.asarray(xi_j))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    if not with_sub:
        assert s_t[0, 0] == np.float32(1e-12) * np.float32(1 / 127) and xi_t[0, :128].abs().max() == 0
        assert s_t[1, 0] == 1.0
        assert xi_t[1, 1, :6].tolist() == [0, 2, 2, 0, -2, -2]


def test_pure_quantize_functions_match_jax():
    """Against the JAX functions as jitted code computes them, where XLA
    turns absmax / 127 into a product with f32(1/127); eager JAX divides, and
    can land one ulp away."""
    x = _half_step_blocks()
    s_j = jax.jit(lambda a: jq.absmax_scale(a, axis=(-2, -1), keepdims=True))(jnp.asarray(x))
    s_t = tq.absmax_scale(_t(x), dim=(-2, -1), keepdim=True)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(tq.quantize_int8(_t(x), s_t).numpy(),
                                  np.asarray(jax.jit(jq.quantize_int8)(jnp.asarray(x), s_j)))
    xi, s = tq.quantize_int8_blocks(_t(x), 64)
    xi_j, s_jb = jax.jit(jq.quantize_int8_blocks, static_argnums=1)(jnp.asarray(x), 64)
    np.testing.assert_array_equal(xi.numpy(), np.asarray(xi_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_jb))
    np.testing.assert_array_equal(
        tq.dequantize_int8(xi, s.repeat_interleave(64, -1)[..., None]).numpy(),
        np.asarray(jq.dequantize_int8(xi_j, jnp.repeat(s_jb, 64, -1)[..., None])))
    with pytest.raises(ValueError, match="divisible"):
        tq.quantize_int8_blocks(_t(x), 100)


def test_k_smooth_matches_jax():
    _, k, _, _ = _inputs(2, 2, 2, 40, 40)
    k = k + 3.0
    ks_t, mean_t = k_smooth(_t(k))
    ks_j, mean_j = jax_k_smooth(jnp.asarray(k))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-6)
    np.testing.assert_allclose(ks_t.numpy(), np.asarray(ks_j), atol=1e-5)
    assert mean_t.shape == (2, 2, 1, 64) and mean_t.dtype == torch.float32


# --------------------------------------------------------------------------
# B4, B5, B7 and B8 on the same inputs as the JAX kernels
# --------------------------------------------------------------------------

CASES = [  # (b, h, h_kv, t, s, causal, K mean)
    (1, 2, 2, 128, 128, True, 0.0),     # rep 1
    (1, 2, 2, 128, 128, False, 0.0),    # rep 1, not causal
    (1, 4, 2, 128, 128, True, 0.0),     # GQA rep 2
    (2, 4, 1, 96, 96, True, 0.0),       # GQA rep 4, ragged t
    (2, 4, 1, 96, 96, False, 0.0),      # GQA rep 4, not causal
    (1, 4, 2, 77, 201, False, 4.0),     # odd cross length, large K mean
    (1, 2, 2, 200, 200, True, 4.0),     # ragged, large K mean: padded K rows set the last K scale
    (1, 4, 1, 1100, 1100, True, 0.0),   # rep 4, three grains each: Q 512, K/V 384
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "b{}h{}kv{}t{}s{}{}{}".format(
    *c[:5], "c" if c[5] else "", "m" if c[6] else ""))
def int8_case(request):
    """Inputs, k_mean (numpy f32, handed to both sides), and the JAX side's
    residuals, O, lse and (dq, dk, dv)."""
    b, h, h_kv, t, s, causal, shift = request.param
    q, k, v, do = _inputs(b, h, h_kv, t, s)
    k = k + np.float32(shift)
    k_mean = k.mean(axis=2, keepdims=True)
    cfg = default_block_config("int8", t, s, 64)
    res = jax_quantize_qkv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg,
                           k_sub=jnp.asarray(k_mean))
    dims = (b, h, t, s, 64)
    o, lse = jax_int8_fwd_from_quantized(res, dims, causal=causal, config=cfg)
    grads = jax_int8_bwd(res, jnp.asarray(k_mean), o, lse, jnp.asarray(do), dims, causal=causal)
    return {"inputs": (q, k, v, do), "k_mean": k_mean, "dims": dims, "causal": causal,
            "res": [(np.asarray(x), np.asarray(sc)) for x, sc in res],
            "o": np.asarray(o), "lse": np.asarray(lse), "grads": [np.asarray(g) for g in grads]}


def test_quantize_qkv_plain_is_byte_equal_to_jax(int8_case):
    q, k, v, _ = int8_case["inputs"]
    got = quantize_qkv(_t(q), _t(k), _t(v), k_sub=_t(int8_case["k_mean"]))
    for (x_t, s_t), (x_j, s_j) in zip(got, int8_case["res"]):
        assert x_t.dtype == torch.int8 and s_t.dtype == torch.float32
        assert x_t.shape == x_j.shape and s_t.shape == s_j.shape
        assert np.array_equal(x_t.numpy(), x_j)
        assert np.array_equal(s_t.numpy(), s_j)


def test_padded_k_rows_set_the_last_k_scale():
    """Trap 1 of the reference, reproduced: K is zero-padded to block_kv and
    then smoothed, so at a ragged length the padded rows hold -k_mean and
    join the absmax of the last K grain. With a K mean of 16 they, not the
    real rows, set its scale."""
    q, k, v, _ = _inputs(1, 2, 2, 200, 200)
    k = k + 16.0
    k_mean = k.mean(axis=2, keepdims=True)
    (_, _), (k_i8, sk), (_, _) = quantize_qkv(_t(q), _t(k), _t(v), k_sub=_t(k_mean))
    real = np.abs(k - k_mean).reshape(2, 200, 64).max(axis=(1, 2)) / 127
    pads = np.abs(k_mean).reshape(2, 64).max(axis=1) / 127
    assert k_i8.shape == (2, 256, 64) and sk.shape == (2, 1)
    np.testing.assert_allclose(sk[:, 0].numpy(), np.maximum(real, pads), rtol=1e-6)
    assert (pads > 2 * real).all()
    assert (k_i8[:, 200:].abs().max(-1).values >= 100).all()


def test_int8_fwd_plain_matches_jax(int8_case):
    res = _residuals_to_torch(int8_case["res"])
    o, lse = int8_attention_fwd_from_quantized(res, int8_case["dims"],
                                               causal=int8_case["causal"])
    b, h, t, _, d = int8_case["dims"]
    assert o.shape == (b, h, t, d) and lse.shape == (b, h, t) and o.dtype == torch.float32
    assert np.abs(o.numpy() - int8_case["o"]).max() <= O_TOL
    assert np.abs(lse.numpy() - int8_case["lse"]).max() <= LSE_TOL


def test_int8_bwd_plain_matches_jax(int8_case):
    res = _residuals_to_torch(int8_case["res"])
    do = int8_case["inputs"][3]
    got = int8_attention_bwd(res, _t(int8_case["k_mean"]), _t(int8_case["o"]),
                             _t(int8_case["lse"]), _t(do), int8_case["dims"],
                             causal=int8_case["causal"])
    for g, w in zip(got, int8_case["grads"]):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= BWD_REL * np.abs(w).max()


@pytest.mark.parametrize("b,h,h_kv,t,s,causal", [
    (1, 4, 2, 128, 128, True), (2, 4, 1, 96, 96, True), (1, 4, 2, 77, 201, False)])
def test_autograd_matches_jax_grad(b, h, h_kv, t, s, causal):
    q, k, v, do = _inputs(b, h, h_kv, t, s)
    k = k + 2.0

    def jax_loss(q_, k_, v_):
        return jnp.sum(jax_sage_int8(q_, k_, v_, causal=causal) * do)

    o_j = jax_sage_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o = sage_attention_int8(*leaves, causal=causal)
    assert np.abs(o.detach().numpy() - np.asarray(o_j)).max() <= O_TOL
    got = torch.autograd.grad((o * _t(do)).sum(), leaves)
    for g, w, x in zip(got, want, leaves):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _rel_l2(g.numpy(), w) <= GRAD_REL_L2


# --------------------------------------------------------------------------
# The JAX package's oracle criteria, on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_forward_int8_vs_oracle(causal):
    q, k, v, _ = (_t(x) for x in _inputs(2, 2, 2, 256, 256, seed=42))
    o, lse, residuals = int8_attention_fwd(q, k, v, causal=causal)
    rep = mismatch_report("int8 fwd", o, reference_attention(q, k, v, causal=causal),
                          ORACLE_ATOL)
    assert rep.mismatch_rate <= ORACLE_RATE, rep
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert all(x.dtype == torch.int8 for x, _ in residuals)


def test_causal_mask_holds_for_tiny_magnitude_inputs():
    """q, k ~ N(0, 0.01^2): the dequant scale c is ~1e-9, and the masked
    logits' sentinel 30000 / -c must still underflow."""
    q, k, v, _ = (_t(x) for x in _inputs(1, 2, 2, 256, 256, seed=43))
    q, k = q * 0.01, k * 0.01
    o, _, _ = int8_attention_fwd(q, k, v, causal=True)
    rep = mismatch_report("tiny-scale causal int8", o,
                          reference_attention(q, k, v, causal=True), ORACLE_ATOL)
    assert rep.mismatch_rate <= ORACLE_RATE, rep


def test_k_smoothing_helps():
    """With a large common K component the smoothed path (the public API)
    beats the raw int8 path."""
    q, k, v, _ = (_t(x) for x in _inputs(1, 2, 2, 256, 256, seed=44))
    k = k + 6.0
    want = reference_attention(q, k, v)
    mse_smoothed = (sage_attention_int8(q, k, v) - want).square().mean().item()
    mse_raw = (int8_attention_fwd(q, k, v)[0] - want).square().mean().item()
    assert mse_smoothed < mse_raw, (mse_smoothed, mse_raw)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_int8_vs_autodiff_oracle(causal):
    q, k, v, do = (_t(x) for x in _inputs(1, 2, 2, 256, 256, seed=45))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(sage_attention_int8(*leaves, causal=causal), leaves, do)
    want = reference_attention_vjp(q, k, v, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g.numpy(), w.numpy()) <= ORACLE_GRAD_REL_L2, name


def test_int8_cross_lengths_vs_oracle():
    q, k, v, _ = (_t(x) for x in _inputs(1, 2, 2, 128, 384, seed=46))
    o, _, _ = int8_attention_fwd(q, k, v)
    rep = mismatch_report("int8 cross", o, reference_attention(q, k, v), ORACLE_ATOL)
    assert rep.mismatch_rate <= ORACLE_RATE, rep


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def _launches():
    return (tq.quant_int8.launches, int8_attention_fwd_from_quantized.launches,
            int8_bwd_dkv.launches, int8_bwd_dq.launches)


def test_cpu_wrappers_use_plain_and_count_nothing():
    q, k, v, do = (_t(x) for x in _inputs(1, 4, 2, 70, 70))
    k_mean = k.mean(-2, keepdim=True)
    before = _launches()
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    res_p = quantize_qkv_plain(q, k, v, k_sub=k_mean)
    assert all(torch.equal(a, b) for pair, pair_p in zip(res, res_p)
               for a, b in zip(pair, pair_p))
    dims = (1, 4, 70, 70, 64)
    o, lse = int8_attention_fwd_from_quantized(res, dims, causal=True)
    o_p, lse_p = int8_attention_fwd_from_quantized_plain(res, dims, causal=True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    got = int8_attention_bwd(res, k_mean, o, lse, do, dims, causal=True)
    want = int8_attention_bwd_plain(res, k_mean, o, lse, do, dims, causal=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _launches() == before


def test_kernel_paths_check_their_arguments_and_never_fall_back():
    """On the kernel path the checks come first: head_dim 64 only, then CUDA
    tensors; a CPU tensor that reaches it raises instead of running plain."""
    q, k, v, do = (_t(x) for x in _inputs(1, 4, 2, 64, 64))
    k_mean = k.mean(-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    dims = (1, 4, 64, 64, 64)
    o, lse = int8_attention_fwd_from_quantized(res, dims)
    ops = int8_bwd_operands(res, k_mean, o, lse, do, dims)
    jobs = tfwd._qkv_jobs(q, k, v, k_mean)
    for check in (lambda: tq._launch_args(jobs), lambda: tfwd._launch_args(res, dims),
                  lambda: tbwd._launch_args(ops)):
        with pytest.raises(ValueError, match="CUDA"):
            check()
    nq, nk, nv = (x[..., :32].contiguous() for x in (q, k, v))
    narrow_res = quantize_qkv(nq, nk, nv)
    narrow_dims = (1, 4, 64, 64, 32)
    narrow_o, narrow_lse = int8_attention_fwd_from_quantized(narrow_res, narrow_dims)
    narrow_ops = int8_bwd_operands(narrow_res, k_mean[..., :32], narrow_o, narrow_lse,
                                   do[..., :32], narrow_dims)
    for check in (lambda: tq._launch_args(tfwd._qkv_jobs(nq, nk, nv, None)),
                  lambda: tfwd._launch_args(narrow_res, narrow_dims),
                  lambda: tbwd._launch_args(narrow_ops)):
        with pytest.raises(ValueError, match="head_dim"):
            check()
    with pytest.raises(ValueError, match="multiple"):
        quantize_qkv(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1))


def test_autograd_saves_int8_residuals_and_no_f32_inputs():
    """The saved tensors are exactly the JAX package's residuals
    (ops/api.py:124-130): int8 payloads and their scales, k_mean, O and lse;
    q, k and v themselves are not kept."""
    q, k, v, _ = (_t(x).requires_grad_(True) for x in _inputs(1, 4, 2, 96, 96))
    o = sage_attention_int8(q, k, v, causal=True)
    saved = o.grad_fn.saved_tensors
    assert [x.dtype for x in saved] == [torch.int8, torch.float32] * 3 + [torch.float32] * 3
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = zip(saved[0:6:2], saved[1:6:2])
    assert q_i8.shape == (4, 128, 64) and sq.shape == (4, 1)
    assert k_i8.shape == v_i8.shape == (2, 128, 64) and sk.shape == sv.shape == (2, 1)
    k_mean, o_saved, lse = saved[6:]
    assert k_mean.shape == (1, 2, 1, 64) and lse.shape == (1, 4, 96)
    assert torch.equal(o_saved, o.detach())
    inputs = {x.data_ptr() for x in (q, k, v)}
    assert not any(x.data_ptr() in inputs for x in saved)


# --------------------------------------------------------------------------
# The LM with attention="int8"
# --------------------------------------------------------------------------

# BASELINE config 4's size (tests/test_baseline_configs.py:73-76), and the
# GQA rep-2 config of test_torch_train.py
LM_CFGS = {
    "mha": dict(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                n_layers=2, max_seq=128, attention="int8"),
    "gqa": dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
                n_layers=2, max_seq=128, attention="int8"),
}
# Both sides run the same int8 forward and backward rounding, the JAX side
# in interpret mode; they differ in summation order and in k_mean's, which
# can move a K payload entry by one step. Measured on the same params: loss
# within 4e-7 relative, each param's gradient within 1.3e-3 relative L2.
LOSS_REL = 1e-4
LM_GRAD_REL_L2 = 1e-2
# AdamW moves each entry by at most lr = 3e-4 per step; the two sides can
# differ by at most 2 * 3 * lr, and do so only where a near-zero gradient
# flips sign (test_torch_train.py). Once the params differ so, the
# quantizers' rounding decisions part too: the losses of the second and
# third step agree within 1.05e-4 relative (measured), the updates within
# relative L2 2.1e-2, and at most 0.22% of entries differ by more than 1e-4.
STEP_LOSS_REL = 1e-3
LR, STEPS = 3e-4, 3
UPDATE_REL_L2 = 0.1
FAR, FAR_SHARE = 1e-4, 1e-2


def _flat_jax(tree):
    top = [tree[key] for key in ("embed", "unembed", "final_norm")]
    keys = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")
    return [np.asarray(x) for x in top + [layer[k] for layer in tree["layers"] for k in keys]]


@pytest.fixture(scope="module", params=sorted(LM_CFGS))
def lm(request):
    kw = LM_CFGS[request.param]
    jcfg = jtr.TransformerConfig(**kw)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, kw["vocab_size"], (2, 128)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    return jcfg, jparams, TransformerConfig(**kw), tokens, targets


def test_int8_lm_loss_and_grads_match_jax(lm):
    jcfg, jparams, cfg, tokens, targets = lm
    loss_j, grads_j = jax.value_and_grad(jtr.lm_loss)(jparams, jnp.asarray(tokens),
                                                      jnp.asarray(targets), jcfg)
    params = params_from_jax(jparams, "cpu")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm_loss(params, _t(tokens), _t(targets), cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(loss_j)) <= LOSS_REL * float(loss_j)
    for g, w in zip(grads, _flat_jax(grads_j)):
        assert g.shape == w.shape
        assert _rel_l2(g.numpy(), w) <= LM_GRAD_REL_L2


def test_int8_train_steps_match_jax(lm):
    jcfg, jparams, cfg, tokens, targets = lm
    optimizer, jstep = jtr.make_train_step(jcfg)
    opt_state = optimizer.init(jparams)
    params = params_from_jax(jparams, "cpu")
    _, step = make_train_step(cfg, params)
    tok, tgt = _t(tokens), _t(targets)
    jp = jparams
    for i in range(STEPS):
        jp, opt_state, loss_j = jstep(jp, opt_state, jnp.asarray(tokens), jnp.asarray(targets))
        loss = step(tok, tgt)
        tol = LOSS_REL if i == 0 else STEP_LOSS_REL
        assert abs(loss.item() - float(loss_j)) <= tol * float(loss_j)
    for got, want, start in zip(param_leaves(params), _flat_jax(jp), _flat_jax(jparams)):
        got = got.detach().numpy()
        assert 0 < np.abs(want - start).max() <= STEPS * LR * 1.01
        diff = np.abs(got - want)
        assert diff.max() <= 2 * STEPS * LR * 1.01
        assert (diff > FAR).mean() <= FAR_SHARE
        assert _rel_l2(got - start, want - start) <= UPDATE_REL_L2


def test_config4_int8_finetune_grad_stability():
    """BASELINE config 4 on the port (tests/test_baseline_configs.py:62-98):
    10 AdamW steps from one init, int8 against bf16 attention; the int8 loss
    falls and its global gradient norm stays within 2x of the bf16 run's at
    every step."""

    def run(attention):
        cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                                n_layers=2, max_seq=128, attention=attention)
        params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
        targets = torch.roll(tokens, -1, dims=1)
        _, step = make_train_step(cfg, params)
        leaves = param_leaves(params)
        norms, losses = [], []
        for _ in range(10):
            losses.append(step(tokens, targets).item())
            norms.append(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(t.grad) for t in leaves])).item())
        return norms, losses

    n_bf16, _ = run("bf16")
    n_int8, l_int8 = run("int8")
    assert l_int8[-1] < l_int8[0], l_int8
    for a, b in zip(n_int8, n_bf16):
        assert a == a and a < 2.0 * b + 1e-3, (n_int8, n_bf16)
