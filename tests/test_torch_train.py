"""PyTorch port vs the JAX package: the training slice.

The same numpy inputs go to the JAX package (Pallas kernels in interpret
mode on the CPU, as its own tests run them) and to the port, which on CPU
tensors runs its kernels' plain versions. The CUDA kernels themselves are
held against those plain versions on the card by chip_smoke.py.

Covered: the flash-attention backward (B2 + B3 arithmetic) in exact and fast
mode, autograd through `flash_attention_bf16` against jax.grad, the fp32
oracle and its report, and the LM's loss, gradients and AdamW steps against
the JAX `lm_loss` / `make_train_step`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu import flash_attention_bf16 as jax_flash_bf16
from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd as jax_flash_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd as jax_flash_fwd
from quantizedattention_tpu.reference import reference_attention_vjp as jax_reference_vjp
from quantizedattention_tpu.utils.testing import mismatch_report as jax_mismatch_report
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    lm_loss,
    make_train_step,
    param_leaves,
    params_from_jax,
)
from quantizedattention_tpu_torch.ops import (
    bwd_operands,
    flash_attention_bf16,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from quantizedattention_tpu_torch.ops.flash_bwd import _launch_args, bwd_prep_plain
from quantizedattention_tpu_torch.reference import reference_attention_vjp
from quantizedattention_tpu_torch.utils.testing import mismatch_report

torch.set_num_threads(2)

# Exact mode: both sides compute in f32 from the same residuals and differ
# only in summation order; measured max |diff| is ~1e-7 relative to the
# largest gradient, so 1e-4 of it leaves three orders of slack.
EXACT_TOL = 1e-4
# Fast mode rounds every product's operands to bf16 (2^-8 relative) while
# the JAX side on the CPU computes in f32 (its fast and exact backwards agree
# there exactly): measured relative L2 4.7e-3 at most on these cases.
FAST_REL_L2 = 1e-2

CASES = [  # (b, h, h_kv, t, s, causal): test_torch_kernels.py's forward cases
    (1, 2, 2, 128, 128, True),    # rep 1
    (1, 4, 2, 128, 128, True),    # GQA rep 2
    (2, 4, 1, 96, 96, True),      # GQA rep 4, ragged t
    (1, 4, 2, 77, 201, False),    # odd cross length
    (1, 2, 1, 77, 77, True),      # ragged causal
]
# (b, h, h_kv, t, s, causal, head_dim): CASES at 64, and at head dim 128 rep
# 1, GQA rep 4 with a ragged t and the odd cross length; head dims the
# kernels do not take (96: 12 partials of 8 dims, 80: 10) on the plain path
BWD_CASES = ([c + (64,) for c in CASES] + [c + (128,) for c in (CASES[0], CASES[2], CASES[3])]
             + [CASES[3] + (96,), CASES[2] + (80,)])


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(b, h, h_kv, t, s, d=64):
    rng = np.random.default_rng(1000 * t + s + h)
    q = rng.standard_normal((b, h, t, d), np.float32)
    k = rng.standard_normal((b, h_kv, s, d), np.float32)
    v = rng.standard_normal((b, h_kv, s, d), np.float32)
    do = rng.standard_normal((b, h, t, d), np.float32)
    return q, k, v, do


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module", params=BWD_CASES, ids=lambda c: "b{}h{}kv{}t{}s{}{}{}".format(
    *c[:5], "c" if c[5] else "", "" if c[6] == 64 else f"d{c[6]}"))
def bwd_case(request):
    """Inputs, the JAX forward's (O, lse) and the JAX backward's grads."""
    b, h, h_kv, t, s, causal, d = request.param
    q, k, v, do = _inputs(b, h, h_kv, t, s, d)
    o, lse = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    grads = jax_flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                          jnp.asarray(do), causal=causal)
    args = tuple(_t(x) for x in (q, k, v, o, lse, do))
    return args, causal, [np.asarray(g) for g in grads]


def test_flash_bwd_plain_exact_matches_jax(bwd_case):
    args, causal, want = bwd_case
    got = flash_attention_bwd(*args, causal=causal, fast=False)
    for g, w, x in zip(got, want, args[:3]):
        assert g.dtype == torch.float32 and g.shape == x.shape
        assert np.abs(g.numpy() - w).max() <= EXACT_TOL * np.abs(w).max()


def test_flash_bwd_plain_fast_matches_jax(bwd_case):
    args, causal, want = bwd_case
    got = flash_attention_bwd(*args, causal=causal, fast=True)
    for g, w in zip(got, want):
        assert _rel_l2(g.numpy(), w) <= FAST_REL_L2
    # the fast path really rounds: it is not the exact path
    exact = flash_attention_bwd(*args, causal=causal, fast=False)
    assert (got[0] - exact[0]).abs().max() > 0


AUTOGRAD_CASES = [CASES[1] + (64,), CASES[3] + (64,), CASES[4] + (64,), CASES[1] + (128,)]


@pytest.mark.parametrize("b,h,h_kv,t,s,causal,d", AUTOGRAD_CASES,
                         ids=["-".join(map(str, c[:6])) + ("" if c[6] == 64 else f"-d{c[6]}")
                              for c in AUTOGRAD_CASES])
def test_autograd_matches_jax_grad(b, h, h_kv, t, s, causal, d):
    q, k, v, do = _inputs(b, h, h_kv, t, s, d)

    def jax_loss(q_, k_, v_):
        return jnp.sum(jax_flash_bf16(q_, k_, v_, causal=causal, bwd_exact=True) * do)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o = flash_attention_bf16(*leaves, causal=causal, bwd_exact=True)
    got = torch.autograd.grad((o * _t(do)).sum(), leaves)
    for g, w, x in zip(got, want, leaves):
        assert g.dtype == x.dtype and g.shape == x.shape
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= EXACT_TOL * np.abs(w).max()


def test_flash_bf16_fast_grads_within_oracle_envelope():
    """The JAX package's test_backward_vs_autodiff_oracle, fast mode (the
    default), on the port: atol 1e-2 mismatch rate <= 3.5e-4."""
    q, k, v, do = _inputs(1, 2, 2, 256, 256)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(flash_attention_bf16(*leaves, causal=True), leaves, _t(do))
    want = reference_attention_vjp(_t(q), _t(k), _t(v), _t(do), causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        rep = mismatch_report(name, g, w)
        assert rep.mismatch_rate <= 3.5e-4, rep


@pytest.mark.parametrize("causal", [True, False])
def test_reference_vjp_matches_jax_oracle(causal):
    q, k, v, do = _inputs(1, 4, 2, 64, 96 if not causal else 64)
    rep = 2
    want = jax_reference_vjp(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
                             jnp.asarray(np.repeat(v, rep, 1)), jnp.asarray(do), causal=causal)
    got = reference_attention_vjp(_t(q), _t(k), _t(v), _t(do), causal=causal)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    for g, w in zip(got[1:], want[1:]):  # GQA: the oracle sums the group
        w = np.asarray(w).reshape(1, 2, rep, *w.shape[2:]).sum(2)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def test_mismatch_report_matches_jax():
    rng = np.random.default_rng(5)
    want = rng.standard_normal((4, 300)).astype(np.float32)
    got = want + rng.normal(0, 6e-3, want.shape).astype(np.float32)
    r_t, r_j = mismatch_report("x", _t(got), _t(want)), jax_mismatch_report("x", got, want)
    assert (r_t.mismatches, r_t.total) == (r_j.mismatches, r_j.total) and r_t.mismatches > 0
    assert r_t.max_abs_err == pytest.approx(r_j.max_abs_err)
    assert r_t.mse == pytest.approx(r_j.mse, rel=1e-5)
    assert r_t.mismatch_rate == pytest.approx(r_j.mismatch_rate)


def test_cpu_wrappers_use_plain_and_count_nothing():
    q, k, v, do = (_t(x) for x in _inputs(1, 4, 2, 40, 40))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    before = (flash_bwd_dkv.launches, flash_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True, fast=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, fast=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (flash_bwd_dkv.launches, flash_bwd_dq.launches) == before
    # the kernel path checks shapes, then wants CUDA tensors: it never falls back
    ops = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True)
    with pytest.raises(ValueError, match="CUDA"):
        _launch_args(ops)
    narrow = bwd_operands(q[..., :32], k[..., :32], v[..., :32], o[..., :32], lse,
                          do[..., :32], fast=True)
    with pytest.raises(ValueError, match="head_dim"):
        _launch_args(narrow)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_bwd(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1),
                            o, lse, do)


def test_bwd_operands_layout_and_rounding():
    q, k, v, do = (_t(x) for x in _inputs(2, 4, 2, 24, 24))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    fast = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True)
    exact = bwd_operands(q, k, v, o, lse, do, causal=True, fast=False)
    assert fast.q.dtype == fast.k.dtype == fast.v.dtype == fast.do.dtype == torch.bfloat16
    assert exact.q.dtype == exact.do.dtype == torch.float32
    assert fast.q.shape == (4, 2, 24, 64) and fast.k.shape == (4, 24, 64)
    assert fast.lse.shape == fast.di.shape == (4, 2, 24)
    # q head h = kv_head * rep + g; q carries qk_scale, dO carries sm_scale
    torch.testing.assert_close(exact.q[1, 1], q[0, 3] * exact.qk_scale)
    torch.testing.assert_close(exact.do[3, 0], do[1, 2] * exact.sm_scale)
    torch.testing.assert_close(fast.q.float(), exact.q.to(torch.bfloat16).float())
    # D = rowsum(dO * sm_scale * O), from the unrounded dO
    torch.testing.assert_close(exact.di[2, 1], (do[1, 1] * exact.sm_scale * o[1, 1]).sum(-1))
    torch.testing.assert_close(fast.di, exact.di)


@pytest.mark.parametrize("d", [24, 64, 80, 96, 128])
def test_bwd_prep_plain_row_term_matches_float64(d):
    """The fast prep's D (summed in the kernel's order, padded where d is
    not 8 times a power of two) against a float64 rowsum, within the
    worst-case bound of an f32 sum of d terms: d * 2^-24 * rowsum |terms|."""
    q, _, _, do = _inputs(2, 3, 3, 37, 37, d)
    o = np.random.default_rng(d).standard_normal(q.shape, np.float32)
    lse = np.zeros(q.shape[:3], np.float32)
    sm_scale = d ** -0.5
    di = bwd_prep_plain(_t(q), _t(o), _t(do), _t(lse), 1.0, sm_scale)[3]
    terms = (do.astype(np.float64) * np.float32(sm_scale)).astype(np.float32).astype(
        np.float64) * o
    assert di.dtype == torch.float32 and di.shape == q.shape[:3]
    err = np.abs(di.numpy() - terms.sum(-1))
    assert (err <= d * 2.0 ** -24 * np.abs(terms).sum(-1)).all()


def test_noncontiguous_v_and_do_are_accepted():
    """The model hands in a transposed-view v and gets a non-contiguous dO back."""
    q, k, v, do = (_t(x) for x in _inputs(1, 4, 2, 48, 48))
    v_view = v.transpose(1, 2).contiguous().transpose(1, 2)
    do_view = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not v_view.is_contiguous() and not do_view.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v_view, causal=True)
    got = flash_attention_bwd(q, k, v_view, o, lse, do_view, causal=True, fast=True)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=True, fast=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    ops = bwd_operands(q, k, v_view, o, lse, do_view, causal=True, fast=True)
    assert all(x.is_contiguous() for x in (ops.q, ops.k, ops.v, ops.do, ops.lse, ops.di))


def test_rows_and_keys_past_the_end_contribute_nothing():
    """A prefix of the queries sees exactly what the full run gives it; for
    causal attention the keys past a prefix get no gradient from it."""
    q, k, v, do = (_t(x) for x in _inputs(1, 2, 1, 70, 70))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=True, fast=True)
    n = 37
    dq_p, dk_p, dv_p = flash_attention_bwd(
        q[:, :, :n], k[:, :, :n], v[:, :, :n], o[:, :, :n], lse[:, :, :n], do[:, :, :n],
        causal=True, fast=True)
    torch.testing.assert_close(dq_p, dq[:, :, :n], rtol=1e-6, atol=1e-6)
    dq0, dk0, dv0 = flash_attention_bwd(q, k, v, o, lse, torch.cat(
        [do[:, :, :n], torch.zeros_like(do[:, :, n:])], 2), causal=True, fast=True)
    assert dk0[:, :, n:].abs().max() == 0 and dv0[:, :, n:].abs().max() == 0
    torch.testing.assert_close(dk_p, dk0[:, :, :n], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv_p, dv0[:, :, :n], rtol=1e-5, atol=1e-5)


# The exact backward at one token (1, 3 q / 1 kv heads, t = s = 1, causal):
# O is V rounded to bf16, so dP - D = dO . (V - bf16(V)) is about 2^-9 of
# dP, and an f32 sum of dP would decide dS (its rounding amplified ~500x).
# With dP summed in float64 and D subtracted there, the plain exact version
# stays within f32 rounding of a float64 evaluation of the same operands.
ONE_TOKEN_F64_TOL = 1e-5


def _bwd_f64(ops):
    """(dq, dk, dv) of the exact backward on `ops`, evaluated in float64 (the
    plain versions' formulas; the same f32 D)."""
    q, k, v, do = (x.double() for x in (ops.q, ops.k[:, None], ops.v[:, None], ops.do))
    t, s = q.shape[2], k.shape[2]
    scores = q @ k.transpose(-1, -2)
    if ops.causal:
        scores = torch.where(torch.ones((t, s), dtype=torch.bool).tril(), scores, -30000.0)
    p = torch.exp2(scores - ops.lse.double()[..., None])
    ds = p * (do @ v.transpose(-1, -2) - ops.di.double()[..., None])
    return (ds @ k, (ds.transpose(-1, -2) @ q).sum(1) / ops.qk_scale,
            (p.transpose(-1, -2) @ do).sum(1) / ops.sm_scale)


@pytest.mark.parametrize("seed", range(32))
def test_exact_bwd_one_token_matches_float64(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_t(rng.standard_normal(shape, np.float32))
                   for shape in ((1, 3, 1, 64), (1, 1, 1, 64), (1, 1, 1, 64), (1, 3, 1, 64)))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ops = bwd_operands(q, k, v, o, lse, do, causal=True, fast=False)
    got = (flash_bwd_dq(ops), *flash_bwd_dkv(ops))
    for name, g, w in zip(("dq", "dk", "dv"), got, _bwd_f64(ops)):
        rel = ((g.double() - w).abs().max() / w.abs().max()).item()
        assert rel <= ONE_TOKEN_F64_TOL, (name, rel)


# --------------------------------------------------------------------------
# The LM: lm_loss, its gradients and AdamW steps against the JAX package
# --------------------------------------------------------------------------

LM_CFG = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
              n_layers=2, max_seq=128)
# a head-dim-128 LM at the same depth: 2 heads x 128
LM128_CFG = dict(vocab_size=64, d_model=256, n_heads=2, n_kv_heads=2, head_dim=128,
                 n_layers=2, max_seq=128)
# The loss is a mean of O(4) cross entropies; both sides run the same bf16
# forward rounding and the backward in fast mode, the JAX side in f32 on the
# CPU: the loss agrees to ~1e-6 relative, each param's gradient to ~1e-2
# relative L2 (the attention backward's bf16 operands, as above).
LOSS_REL = 1e-4
GRAD_REL_L2 = 3e-2
# AdamW moves each entry by at most lr = 3e-4 per step (plus 3e-8 of decay),
# so after 3 steps the two sides can differ by at most 2 * 3 * lr. They get
# that far only where a near-zero gradient differs in sign and Adam's
# normalised step m/sqrt(v) flips: measured, at most 0.26% of a tensor's
# entries differ by more than 1e-4, and the updates (p - p0) agree within
# relative L2 3.5e-2.
LR, STEPS = 3e-4, 3
UPDATE_REL_L2 = 0.1
FAR, FAR_SHARE = 1e-4, 1e-2


@pytest.fixture(scope="module", params=[LM_CFG, LM128_CFG],
                ids=lambda c: f"d{c['head_dim']}")
def lm(request):
    cfg = request.param
    jcfg = jtr.TransformerConfig(**cfg)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg["vocab_size"], (2, 128)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    return jcfg, jparams, TransformerConfig(**cfg), tokens, targets


def _flat_jax(tree):
    top = [tree[key] for key in ("embed", "unembed", "final_norm")]
    keys = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")
    return [np.asarray(x) for x in top + [layer[k] for layer in tree["layers"] for k in keys]]


def test_lm_loss_and_grads_match_jax(lm):
    jcfg, jparams, cfg, tokens, targets = lm
    loss_j, grads_j = jax.value_and_grad(jtr.lm_loss)(jparams, jnp.asarray(tokens),
                                                      jnp.asarray(targets), jcfg)
    params = params_from_jax(jparams, "cpu")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm_loss(params, _t(tokens), _t(targets), cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.ndim == 0 and loss.dtype == torch.float32
    assert abs(loss.item() - float(loss_j)) <= LOSS_REL * float(loss_j)
    for g, w in zip(grads, _flat_jax(grads_j)):
        assert g.shape == w.shape
        assert _rel_l2(g.numpy(), w) <= GRAD_REL_L2


def test_train_steps_match_jax(lm):
    jcfg, jparams, cfg, tokens, targets = lm
    optimizer, jstep = jtr.make_train_step(jcfg)
    opt_state = optimizer.init(jparams)
    params = params_from_jax(jparams, "cpu")
    topt, step = make_train_step(cfg, params)
    tok, tgt = _t(tokens), _t(targets)
    jp = jparams
    for _ in range(STEPS):
        jp, opt_state, loss_j = jstep(jp, opt_state, jnp.asarray(tokens), jnp.asarray(targets))
        loss = step(tok, tgt)
        assert loss.ndim == 0 and not loss.requires_grad
        assert abs(loss.item() - float(loss_j)) <= LOSS_REL * float(loss_j)
    for got, want, start in zip(param_leaves(params), _flat_jax(jp), _flat_jax(jparams)):
        got = got.detach().numpy()
        assert 0 < np.abs(want - start).max() <= STEPS * LR * 1.01
        diff = np.abs(got - want)
        assert diff.max() <= 2 * STEPS * LR * 1.01
        assert (diff > FAR).mean() <= FAR_SHARE
        assert _rel_l2(got - start, want - start) <= UPDATE_REL_L2
    group = topt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == \
        (3e-4, (0.9, 0.999), 1e-8, 1e-4)
