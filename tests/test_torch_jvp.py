"""PyTorch port vs the JAX package: the JVP attention family.

The same numpy inputs go to the JAX package (Pallas kernels in interpret
mode on the CPU, as its own tests run them) and to the port, which on CPU
tensors runs its kernels' plain versions. The CUDA kernels themselves are
held against those plain versions on the card by chip_smoke.py.

Covered: B1's fp32 mode, B9 (O, tO, lse, mu), B10 (tO given O and lse) and
B11/B12 (the second-order backward, on JAX's own residuals) in exact and
fast mode; `attention_jvp` under torch.func.jvp and torch.autograd.forward_ad
and its gradients; `attention_value_and_jvp`'s gradients against jax.grad;
the tangent oracle; GQA refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from quantizedattention_tpu import attention_jvp as jax_attention_jvp
from quantizedattention_tpu import attention_value_and_jvp as jax_value_and_jvp
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd as jax_flash_fwd
from quantizedattention_tpu.ops.jvp_bwd import attention_jvp_bwd as jax_jvp_bwd
from quantizedattention_tpu.ops.jvp_fwd import attention_jvp_fwd as jax_jvp_fwd
from quantizedattention_tpu.ops.jvp_tangent import attention_tangent_fwd as jax_tangent_fwd
from quantizedattention_tpu.reference import reference_attention_jvp as jax_reference_jvp
from quantizedattention_tpu_torch.ops import (
    attention_jvp,
    attention_jvp_bwd,
    attention_jvp_fwd,
    attention_tangent_fwd,
    attention_value_and_jvp,
    flash_attention_fwd,
    flash_attention_fwd_fp32,
    jvp_bwd_dkv,
    jvp_bwd_dq,
    jvp_bwd_operands,
)
from quantizedattention_tpu_torch.ops.jvp_bwd import _launch_args
from quantizedattention_tpu_torch.ops.jvp_fwd import kernel_args
from quantizedattention_tpu_torch.reference import reference_attention_jvp

torch.set_num_threads(2)

# Exact mode: both sides compute in f32 from the same inputs and differ only
# in summation order and where the scales multiply (measured max|diff| about
# 1e-6 of the largest entry), so 1e-4 of max|want| leaves two orders of slack.
EXACT_TOL = 1e-4
# Autograd and AD-transform parity: the JAX package's own tight envelope for
# the JVP family (tests/test_jvp_grad.py), rtol and atol 5e-4.
AD_TOL = 5e-4
# Fast mode rounds every product's operands to bf16 (2^-8 relative) while
# the JAX side on the CPU computes in f32 (DEFAULT precision is f32 there):
# the JAX package's own fast-vs-exact envelope (tests/test_jvp_grad.py:
# 118-136), O 2e-2 and tO / gradients 5e-2 (measured at most 1.5e-2).
FAST_O_TOL, FAST_TOL = 2e-2, 5e-2

CASES = [  # (b, h, t, s, causal)
    (1, 2, 128, 128, True),
    (1, 2, 128, 128, False),
    (1, 1, 77, 201, False),   # odd cross lengths: ragged q and kv tiles
    (2, 1, 96, 96, True),     # ragged causal, two batches
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(b, h, t, s, seed=0):
    """q, k, v, tq, tk, tv, do, dto as f32 numpy arrays."""
    rng = np.random.default_rng(1000 * t + s + 10 * h + seed)
    q_side = [rng.standard_normal((b, h, t, 64), np.float32) for _ in range(4)]
    kv_side = [rng.standard_normal((b, h, s, 64), np.float32) for _ in range(4)]
    q, tq, do, dto = q_side
    k, v, tk, tv = kv_side
    return q, k, v, tq, tk, tv, do, dto


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _ids(c):
    return "b{}h{}t{}s{}{}".format(*c[:4], "c" if c[4] else "")


@pytest.fixture(scope="module", params=CASES, ids=_ids)
def jvp_case(request):
    """Inputs and the JAX kernels' outputs on them: B9 (O, tO, lse, mu), the
    fp32 flash forward (O, lse), B10's tO and B11/B12's six gradients."""
    b, h, t, s, causal = request.param
    arrays = _inputs(b, h, t, s)
    q, k, v, tq, tk, tv, do, dto = (jnp.asarray(x) for x in arrays)
    fwd = jax_jvp_fwd(q, k, v, tq, tk, tv, causal=causal)
    o32, lse32 = jax_flash_fwd(q, k, v, causal=causal, precision="fp32")
    tangent = jax_tangent_fwd(q, k, v, o32, lse32, tq, tk, tv, causal=causal)
    grads = jax_jvp_bwd(q, k, v, tq, tk, tv, *fwd, do, dto, causal=causal)
    as_np = [np.asarray(x) for x in (*fwd, o32, lse32, tangent, *grads)]
    return arrays, causal, as_np[:4], as_np[4:6], as_np[6], as_np[7:]


def test_flash_fwd_fp32_plain_matches_jax(jvp_case):
    arrays, causal, _, (o_w, lse_w), _, _ = jvp_case
    q, k, v = (_t(x) for x in arrays[:3])
    o, lse = flash_attention_fwd_fp32(q, k, v, causal=causal)
    assert o.dtype == lse.dtype == torch.float32
    assert _max_rel(o, o_w) <= EXACT_TOL
    assert np.abs(lse.numpy() - lse_w).max() <= EXACT_TOL
    # the fp32 mode rounds nothing; the bf16 mode does
    o_bf16, _ = flash_attention_fwd(q, k, v, causal=causal)
    assert _max_rel(o_bf16, o_w) > 10 * EXACT_TOL


def test_flash_fwd_fp32_gqa_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 4, 70, 64), np.float32)
    k, v = (rng.standard_normal((1, 2, 90, 64), np.float32) for _ in range(2))
    o_w, lse_w = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               precision="fp32")
    o, lse = flash_attention_fwd_fp32(_t(q), _t(k), _t(v), causal=True)
    assert _max_rel(o, o_w) <= EXACT_TOL
    assert np.abs(lse.numpy() - np.asarray(lse_w)).max() <= EXACT_TOL


def test_jvp_fwd_plain_exact_matches_jax(jvp_case):
    arrays, causal, want, _, _, _ = jvp_case
    got = attention_jvp_fwd(*(_t(x) for x in arrays[:6]), causal=causal)
    for g, w, name in zip(got, want, ("o", "to", "lse", "mu")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _max_rel(g, w) <= EXACT_TOL, name


def test_jvp_fwd_plain_fast_matches_jax(jvp_case):
    arrays, causal, want, _, _, _ = jvp_case
    inputs = [_t(x) for x in arrays[:6]]
    got = attention_jvp_fwd(*inputs, causal=causal, fast=True)
    for g, w, tol in zip(got, want, (FAST_O_TOL, FAST_TOL, FAST_TOL, FAST_TOL)):
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)
    # the fast path really rounds: it is not the exact path
    exact = attention_jvp_fwd(*inputs, causal=causal)
    assert (got[1] - exact[1]).abs().max() > 0


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_tangent_plain_matches_jax(jvp_case, fast):
    arrays, causal, _, (o32, lse32), want, _ = jvp_case
    q, k, v, tq, tk, tv = (_t(x) for x in arrays[:6])
    got = attention_tangent_fwd(q, k, v, _t(o32), _t(lse32), tq, tk, tv, causal=causal, fast=fast)
    assert got.dtype == torch.float32 and got.shape == q.shape
    if fast:
        np.testing.assert_allclose(got.numpy(), want, rtol=FAST_TOL, atol=FAST_TOL)
    else:
        assert _max_rel(got, want) <= EXACT_TOL


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_jvp_bwd_plain_matches_jax(jvp_case, fast):
    """B11/B12's plain versions on JAX's own residuals (O, tO, lse, mu)."""
    arrays, causal, fwd, _, _, want = jvp_case
    got = attention_jvp_bwd(*(_t(x) for x in arrays[:6]), *(_t(x) for x in fwd),
                            _t(arrays[6]), _t(arrays[7]), causal=causal, fast=fast)
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "dtq", "dtk", "dtv")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if fast:
            assert _max_rel(g, w) <= FAST_TOL, name
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=AD_TOL, atol=AD_TOL, err_msg=name)
            assert _max_rel(g, w) <= EXACT_TOL, name


def test_jvp_bwd_operands_row_terms():
    q, k, v, tq, tk, tv, do, dto = (_t(x) for x in _inputs(2, 2, 24, 40))
    o, to, lse, mu = attention_jvp_fwd(q, k, v, tq, tk, tv)
    ops = jvp_bwd_operands(q, k, v, tq, tk, tv, o, to, lse, mu, do, dto)
    assert ops.q.shape == (4, 24, 64) and ops.k.shape == (4, 40, 64)
    assert ops.c.shape == ops.dhat.shape == ops.lse.shape == (4, 24)
    assert all(x.is_contiguous() and x.dtype == torch.float32 for x in ops[:12])
    c = (dto * o).sum(-1)
    dhat = (do * o).sum(-1) + (dto * to).sum(-1) - c * mu
    torch.testing.assert_close(ops.c, c.reshape(4, 24))
    torch.testing.assert_close(ops.dhat, dhat.reshape(4, 24))
    torch.testing.assert_close(ops.tk[3], tk[1, 1])


# --------------------------------------------------------------------------
# The entry points: AD transforms against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["func_jvp", "forward_ad"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_jvp_forward_mode_matches_jax(mode, causal):
    """(O, tO) of attention_jvp under both torch forward-mode APIs (the
    Function's jvp rule: B10) against jax.jvp of the JAX attention_jvp."""
    q, k, v, tq, tk, tv, _, _ = _inputs(1, 2, 96, 96)
    o_w, to_w = jax.jvp(lambda q_, k_, v_: jax_attention_jvp(q_, k_, v_, causal=causal),
                        tuple(map(jnp.asarray, (q, k, v))), tuple(map(jnp.asarray, (tq, tk, tv))))
    primals, tangents = tuple(map(_t, (q, k, v))), tuple(map(_t, (tq, tk, tv)))
    if mode == "func_jvp":
        o, to = torch.func.jvp(lambda q_, k_, v_: attention_jvp(q_, k_, v_, causal=causal),
                               primals, tangents)
    else:
        with forward_ad.dual_level():
            duals = [forward_ad.make_dual(p, t) for p, t in zip(primals, tangents)]
            o, to = forward_ad.unpack_dual(attention_jvp(*duals, causal=causal))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_w), rtol=AD_TOL, atol=AD_TOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(to_w), rtol=AD_TOL, atol=AD_TOL)


def test_attention_jvp_partial_tangents():
    """A tangent on q alone: the missing tangents count as zeros."""
    q, k, v, tq, _, _, _, _ = _inputs(1, 1, 64, 80)
    qt, kt, vt = _t(q), _t(k), _t(v)
    _, to = torch.func.jvp(lambda q_: attention_jvp(q_, kt, vt), (qt,), (_t(tq),))
    _, to_all = torch.func.jvp(attention_jvp, (qt, kt, vt),
                               (_t(tq), torch.zeros_like(kt), torch.zeros_like(vt)))
    torch.testing.assert_close(to, to_all, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_jvp_grads_match_jax(causal):
    q, k, v, _, _, _, do, _ = _inputs(1, 2, 128, 128)
    want = jax.grad(lambda *a: jnp.sum(jax_attention_jvp(*a, causal=causal) * do),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(attention_jvp(*leaves, causal=causal), leaves, _t(do))
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=AD_TOL, atol=AD_TOL,
                                   err_msg=f"d{name}")


def _pair_loss_grads(arrays, causal, loss_kind, port_fast=False):
    """jax.grad and torch.autograd of one loss over attention_value_and_jvp's
    (O, tO), with respect to all six inputs."""
    q, k, v, tq, tk, tv, wo, wt = arrays

    def jax_loss(*a):
        o, to = jax_value_and_jvp(*a, causal=causal)
        if loss_kind == "linear":
            return jnp.sum(o * wo) + jnp.sum(to * wt)
        if loss_kind == "tangent":
            return jnp.sum(to ** 2)
        return jnp.sum(jnp.sin(o) + to ** 2)

    want = jax.grad(jax_loss, argnums=tuple(range(6)))(*map(jnp.asarray, arrays[:6]))
    leaves = [_t(x).requires_grad_(True) for x in arrays[:6]]
    o, to = attention_value_and_jvp(*leaves, causal=causal, fast=port_fast)
    if loss_kind == "linear":
        loss = (o * _t(wo)).sum() + (to * _t(wt)).sum()
    elif loss_kind == "tangent":
        loss = to.square().sum()
    else:
        loss = (torch.sin(o) + to.square()).sum()
    return torch.autograd.grad(loss, leaves), want


@pytest.mark.parametrize("t,s,causal,loss_kind", [
    (128, 128, False, "linear"), (128, 128, True, "linear"),
    (77, 201, False, "mixed"), (77, 201, True, "mixed"),
    (128, 128, False, "tangent"),   # dO = 0: the pure Hessian-vector terms (the rCM case)
])
def test_value_and_jvp_grads_match_jax(t, s, causal, loss_kind):
    arrays = _inputs(1, 1 if t != s else 2, t, s, seed=3)
    got, want = _pair_loss_grads(arrays, causal, loss_kind)
    for g, w, name in zip(got, want, ("q", "k", "v", "tq", "tk", "tv")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        w = np.asarray(w)
        assert np.abs(g.numpy()).max() > 0, f"d{name} vanished"
        np.testing.assert_allclose(g.numpy(), w, rtol=AD_TOL, atol=AD_TOL, err_msg=f"d{name}")


def test_value_and_jvp_fast_grads_within_loose_envelope():
    """fast=True, forward and second-order backward, within the JAX
    package's fast-vs-exact envelope of its (f32 on the CPU) gradients."""
    arrays = _inputs(1, 2, 128, 128, seed=9)
    got, want = _pair_loss_grads(arrays, False, "mixed", port_fast=True)
    for g, w, name in zip(got, want, ("q", "k", "v", "tq", "tk", "tv")):
        assert _max_rel(g, w) <= FAST_TOL, name


def test_value_and_jvp_bf16_inputs_give_input_dtype_grads():
    q, k, v, tq, tk, tv, _, _ = _inputs(1, 1, 40, 40)
    leaves = [_t(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v, tq, tk, tv)]
    o, to = attention_value_and_jvp(*leaves)
    assert o.dtype == to.dtype == torch.float32
    grads = torch.autograd.grad((o.sum() + to.square().sum()), leaves)
    assert all(g.dtype == torch.bfloat16 for g in grads)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_jvp_matches_jax_oracle(causal):
    q, k, v, tq, tk, tv, _, _ = _inputs(1, 2, 64, 64 if causal else 96)
    o_w, to_w = jax_reference_jvp(tuple(map(jnp.asarray, (q, k, v))),
                                  tuple(map(jnp.asarray, (tq, tk, tv))), causal=causal)
    o, to = reference_attention_jvp(tuple(map(_t, (q, k, v))), tuple(map(_t, (tq, tk, tv))),
                                    causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_w), atol=1e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(to_w), atol=1e-5)


def test_gqa_raises_value_error():
    q, k, v, tq, tk, tv, _, _ = (_t(x) for x in _inputs(1, 4, 32, 32))
    k2, v2, tk2, tv2 = (x[:, :2] for x in (k, v, tk, tv))
    with pytest.raises(ValueError, match="single-head-count"):
        attention_jvp(q, k2, v2)
    with pytest.raises(ValueError, match="single-head-count"):
        attention_value_and_jvp(q, k2, v2, tq, tk2, tv2)
    with pytest.raises(ValueError, match="single-head-count"):
        attention_jvp_fwd(q, k2, v2, tq, tk2, tv2)
    with pytest.raises(ValueError, match="single-head-count"):
        attention_tangent_fwd(q, k2, v2, q, q[..., 0], tq, tk2, tv2)


def test_cpu_wrappers_use_plain_and_count_nothing():
    q, k, v, tq, tk, tv, do, dto = (_t(x) for x in _inputs(1, 2, 40, 40))
    counted = (flash_attention_fwd_fp32, attention_jvp_fwd, attention_tangent_fwd, jvp_bwd_dkv,
               jvp_bwd_dq)
    before = [fn.launches for fn in counted]
    o, to, lse, mu = attention_jvp_fwd(q, k, v, tq, tk, tv)
    flash_attention_fwd_fp32(q, k, v)
    attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv)
    attention_jvp_bwd(q, k, v, tq, tk, tv, o, to, lse, mu, do, dto)
    assert [fn.launches for fn in counted] == before
    # the kernel path checks shapes, then wants CUDA tensors: it never falls back
    ops = jvp_bwd_operands(q, k, v, tq, tk, tv, o, to, lse, mu, do, dto)
    with pytest.raises(ValueError, match="CUDA"):
        _launch_args(ops)
    with pytest.raises(ValueError, match="head_dim"):
        kernel_args(1, 2, 32, q[..., :32])
