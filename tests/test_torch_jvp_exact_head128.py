"""PyTorch port vs the JAX package at head dim 128: the rest of the JVP
family and the exact backward (B10 in both modes, the exact modes of B9,
B11 and B12, and B2/B3 exact).

The same numpy inputs go to the JAX package (its Pallas kernels in
interpret mode on the CPU, as its own tests run them) and to the port, which
on CPU tensors runs its kernels' plain versions. The CUDA kernels at 128 are
held against those plain versions on the card by chip_smoke.py (phase 30).

Covered: B10's plain version in both modes against the JAX tangent kernel;
`attention_value_and_jvp(fast=False)` (O, tO and the six gradients) against
jax.grad; `torch.func.jvp(attention_jvp)` against jax.jvp and
`attention_jvp`'s gradients (B2/B3's exact plain versions) against
jax.grad; `flash_attention_bwd_plain` in exact mode (causal and not, GQA rep
3, t != s) against the JAX backward; `torch.func.jvp(dit_forward)` of a small
d=128 DiT carried over by `dit_params_from_jax` against jax.jvp; the launch
geometry of the d=128 instances (B10 exact's grid and walk, the shared bytes
of B10 in both modes, of the FFMA exact kernels and of B2/B3 exact).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu import attention_jvp as jax_attention_jvp
from quantizedattention_tpu import attention_value_and_jvp as jax_value_and_jvp
from quantizedattention_tpu.models import dit as jdit
from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd as jax_flash_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd as jax_flash_fwd
from quantizedattention_tpu.ops.jvp_tangent import attention_tangent_fwd as jax_tangent_fwd
from quantizedattention_tpu_torch.models import DiTConfig, dit_forward, dit_params_from_jax
from quantizedattention_tpu_torch.ops import (
    attention_jvp,
    attention_tangent_fwd,
    attention_value_and_jvp,
    flash_attention_bwd_plain,
)
from quantizedattention_tpu_torch.ops import flash_tiling, jvp_tiling

torch.set_num_threads(2)

D = 128
# Exact mode: both sides compute in f32 from the same inputs and differ only
# in summation order (as at 64, test_torch_jvp.py): 1e-4 of max|want|.
EXACT_TOL = 1e-4
# Autograd and AD-transform parity: the JAX package's own envelope for the
# JVP family (tests/test_jvp_grad.py), rtol and atol 5e-4 (as at 64).
AD_TOL = 5e-4
# B10 fast rounds its products' operands to bf16 while the JAX side on the
# CPU computes in f32: the JAX package's fast-vs-exact envelope, 5e-2 (as at
# 64, test_torch_jvp.py).
FAST_TOL = 5e-2
SMEM_LIMIT = 232_448  # shared bytes an H100 block may use


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(b, h, t, s, seed):
    """q, k, v, tq, tk, tv, and two output weights: f32 numpy at d=128."""
    rng = np.random.default_rng(seed)
    q_side = [rng.standard_normal((b, h, t, D), np.float32) for _ in range(4)]
    kv_side = [rng.standard_normal((b, h, s, D), np.float32) for _ in range(4)]
    return (q_side[0], kv_side[0], kv_side[1], q_side[1], kv_side[2], kv_side[3],
            q_side[2], q_side[3])


# --------------------------------------------------------------------------
# B10: the tangent's plain version in both modes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("t,s,causal", [(128, 128, True), (77, 201, False)])
def test_tangent_plain_matches_jax_at_128(t, s, causal, fast):
    """On JAX's own fp32 forward residuals (O, lse): exact at 1e-4 of max,
    fast (bf16 operands) within the JAX package's fast envelope."""
    arrays = _inputs(1, 2, t, s, seed=t + 3 * s)
    q, k, v, tq, tk, tv = (jnp.asarray(x) for x in arrays[:6])
    o32, lse32 = jax_flash_fwd(q, k, v, causal=causal, precision="fp32")
    want = np.asarray(jax_tangent_fwd(q, k, v, o32, lse32, tq, tk, tv, causal=causal))
    got = attention_tangent_fwd(*(_t(x) for x in arrays[:3]), _t(o32), _t(lse32),
                                *(_t(x) for x in arrays[3:6]), causal=causal, fast=fast)
    assert got.dtype == torch.float32 and got.shape == (1, 2, t, D)
    if fast:
        np.testing.assert_allclose(got.numpy(), want, rtol=FAST_TOL, atol=FAST_TOL)
    else:
        assert _max_rel(got, want) <= EXACT_TOL


# --------------------------------------------------------------------------
# The entry points in exact mode against JAX's AD
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,s,causal", [(128, 128, True), (77, 201, False)])
def test_value_and_jvp_exact_forward_and_grads_match_jax_at_128(t, s, causal):
    """attention_value_and_jvp's default mode (B9 exact forward, B11 + B12
    exact backward): (O, tO) at 1e-4 of max and jax.grad's six gradients of
    a mixed loss within the JAX package's AD envelope."""
    arrays = _inputs(1, 2, t, s, seed=5 * t + s)
    q, k, v, tq, tk, tv, wo, wt = arrays

    def jax_loss(*a):
        o, to = jax_value_and_jvp(*a, causal=causal)
        return jnp.sum(jnp.sin(o) * wo) + jnp.sum(to * wt) + jnp.sum(to ** 2)

    inputs = [jnp.asarray(x) for x in arrays[:6]]
    o_w, to_w = jax_value_and_jvp(*inputs, causal=causal)
    want = jax.grad(jax_loss, argnums=tuple(range(6)))(*inputs)
    leaves = [_t(x).requires_grad_(True) for x in arrays[:6]]
    o, to = attention_value_and_jvp(*leaves, causal=causal)
    assert _max_rel(o.detach(), o_w) <= EXACT_TOL
    assert _max_rel(to.detach(), to_w) <= EXACT_TOL
    loss = (torch.sin(o) * _t(wo)).sum() + (to * _t(wt)).sum() + to.square().sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w, name in zip(got, want, ("q", "k", "v", "tq", "tk", "tv")):
        assert g.shape == w.shape and g.abs().max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=AD_TOL, atol=AD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_attention_jvp_forward_mode_matches_jax_at_128(causal):
    """torch.func.jvp of attention_jvp (B1 fp32's forward, then B10 exact)
    against jax.jvp of the JAX attention_jvp."""
    q, k, v, tq, tk, tv, _, _ = _inputs(1, 2, 96, 96, seed=9)
    o_w, to_w = jax.jvp(lambda q_, k_, v_: jax_attention_jvp(q_, k_, v_, causal=causal),
                        tuple(map(jnp.asarray, (q, k, v))), tuple(map(jnp.asarray, (tq, tk, tv))))
    o, to = torch.func.jvp(lambda q_, k_, v_: attention_jvp(q_, k_, v_, causal=causal),
                           tuple(map(_t, (q, k, v))), tuple(map(_t, (tq, tk, tv))))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_w), rtol=AD_TOL, atol=AD_TOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(to_w), rtol=AD_TOL, atol=AD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_jvp_grads_match_jax_at_128(causal):
    """attention_jvp's reverse mode (B2/B3's exact plain versions) against
    jax.grad of the JAX attention_jvp."""
    q, k, v, _, _, _, do, _ = _inputs(1, 2, 128, 128, seed=13)
    want = jax.grad(lambda *a: jnp.sum(jax_attention_jvp(*a, causal=causal) * do),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(attention_jvp(*leaves, causal=causal), leaves, _t(do))
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32 and g.abs().max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=AD_TOL, atol=AD_TOL,
                                   err_msg=f"d{name}")


# (b, h, h_kv, t, s, causal): causal and not, GQA rep 3, t != s both ways
BWD_CASES = [(1, 2, 2, 128, 128, True), (1, 2, 2, 128, 128, False), (1, 3, 1, 77, 130, True),
             (1, 2, 2, 130, 77, False)]


@pytest.mark.parametrize("b,h,h_kv,t,s,causal", BWD_CASES,
                         ids=["-".join(map(str, c[:5])) + ("c" if c[5] else "")
                              for c in BWD_CASES])
def test_flash_bwd_plain_exact_matches_jax_at_128(b, h, h_kv, t, s, causal):
    """B2/B3's exact plain versions (dP summed in float64) against the JAX
    backward on the JAX forward's residuals, 1e-4 of max|want| per tensor
    (as at 64, test_torch_train.py)."""
    rng = np.random.default_rng(100 + t + s + h)
    q, do = (rng.standard_normal((b, h, t, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h_kv, s, D), np.float32) for _ in range(2))
    o, lse = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    want = jax_flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(do),
                         causal=causal)
    got = flash_attention_bwd_plain(*(_t(x) for x in (q, k, v, o, lse, do)), causal=causal,
                                    fast=False)
    for g, w, x in zip(got, want, (q, k, v)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == x.shape
        assert np.abs(g.numpy() - w).max() <= EXACT_TOL * np.abs(w).max()


# --------------------------------------------------------------------------
# Forward-mode AD of a small DiT at head dim 128
# --------------------------------------------------------------------------

DIT = dict(d_model=256, n_heads=2, head_dim=D, n_layers=1, seq_len=128)
# f32 on both sides; the DiT's forward and its tangent differ only in
# summation order (as at 64, test_torch_dit.py): 1e-4 of max|want|.
FWD_REL = 1e-4


def test_dit_forward_mode_matches_jax_at_128():
    """torch.func.jvp of dit_forward (default attention: attention_jvp, so
    B10 exact under forward mode) against jax.jvp of the JAX dit_forward,
    along (dx, dt) = (dit_forward's output, 1); `ada` and `out` drawn
    nonzero on both sides, params carried over by dit_params_from_jax."""
    jcfg = jdit.DiTConfig(**DIT)
    jparams = jdit.init_dit(jax.random.key(2), jcfg)
    rng = np.random.default_rng(17)
    d = DIT["d_model"]
    jparams["out"] = jnp.asarray(rng.standard_normal((d, d), np.float32) / math.sqrt(d))
    for layer in jparams["layers"]:
        layer["ada"] = jnp.asarray(rng.standard_normal((d, 6 * d), np.float32) / math.sqrt(d))
    x = rng.standard_normal((2, DIT["seq_len"], d), np.float32)
    t = rng.uniform(size=2).astype(np.float32)
    xj, tj = jnp.asarray(x), jnp.asarray(t)
    vj = jdit.dit_forward(jparams, xj, tj, jcfg)
    u_w, du_w = jax.jvp(lambda x_, t_: jdit.dit_forward(jparams, x_, t_, jcfg), (xj, tj),
                        (vj, jnp.ones_like(tj)))
    cfg = DiTConfig(**DIT)
    params = dit_params_from_jax(jparams, "cpu")
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        v = dit_forward(params, xt, tt, cfg)
        u, du = torch.func.jvp(lambda x_, t_: dit_forward(params, x_, t_, cfg), (xt, tt),
                               (v, torch.ones_like(tt)))
    for g, w in ((u, u_w), (du, du_w)):
        w = np.asarray(w)
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert np.abs(g.numpy() - w).max() <= FWD_REL * np.abs(w).max()


# --------------------------------------------------------------------------
# Launch geometry at 128
# --------------------------------------------------------------------------

# (t, s): ragged, cross both ways, one token, the dit_jvp path's, off a tile
TANGENT_SHAPES = [(1, 1), (1, 300), (300, 1), (33, 130), (77, 201), (129, 31), (512, 512)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,s", TANGENT_SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_tangent_walk_at_128_covers_every_visible_pair_once(t, s, causal, sms):
    """B10 exact at 128: grid column x holds rows (n - 1 - x) * 64 ..,
    range z the key tiles `tangent_range` gives; split or not, every
    visible (position, key) pair of a head is computed exactly once."""
    n_qb, z, per = jvp_tiling.tangent_grid(1, t, s, sms, D)
    rows = jvp_tiling.tangent_rows(D)
    assert rows == 64 and n_qb == -(-t // rows)
    assert z * per * jvp_tiling.TANGENT_KEYS >= s > (z - 1) * per * jvp_tiling.TANGENT_KEYS
    seen = np.zeros((t, s), np.int32)
    for x in range(n_qb):
        q0 = (n_qb - 1 - x) * rows
        for zi in range(z):
            for tile in jvp_tiling.tangent_range(q0, zi, per, t, s, causal, D):
                seen[q0:q0 + rows, tile * 32:tile * 32 + 32] += 1
    visible = np.tril(np.ones((t, s), bool)) if causal else np.ones((t, s), bool)
    assert (seen[visible] == 1).all() and (seen <= 1).all()


@pytest.mark.parametrize("bh,t,s,want", [
    (16, 4096, 4096, (64, 1, 128)),   # the DiT's: 1024 blocks fill the card unsplit
    (8, 512, 512, (8, 3, 6)),         # the dit_jvp path's: 64 q blocks, 3 key ranges of 6 tiles
    (2, 4096, 4096, (64, 2, 64)),     # (1, 2, 4096) as the oracle phase: 128 q blocks, 2 ranges
    (1, 1, 1, (1, 1, 1)),
])
def test_tangent_grid_at_128_splits_keys_only_to_fill_the_card(bh, t, s, want):
    assert jvp_tiling.tangent_grid(bh, t, s, 132, D) == want


def test_shared_bytes_at_128():
    """What phase 2 holds against the kernels' own counts: B10 exact (Q
    small, tQ big and tQ small of the block's 64 rows, and each warpgroup's
    K and V parts of 16 keys), B10 fast (padded bf16 rows), the FFMA exact
    kernels' padded f32 tiles and B2/B3 exact's; each under the limit, and
    the d=64 instances' counts as before."""
    tangent = jvp_tiling.tangent_shared_bytes(D)
    assert tangent == 3 * 64 * D * 4 + 2 * 2 * (4 * 16 * D * 4) + 128 + 1024
    assert jvp_tiling.tangent_shared_bytes(64) == 2 * 16384 + 3 * 65536 + 128 + 1024
    assert jvp_tiling.tangent_fast_shared_bytes(D) == (2 * 64 + 4 * 32) * (D + 8) * 2
    assert jvp_tiling.tangent_fast_shared_bytes(64) == 36864
    exact = {k: jvp_tiling.exact_shared_bytes(k, D) for k in ("fwd", "dkv", "dq")}
    tile, ptile = 32 * (D + 1) * 4, 32 * 33 * 4
    assert exact == {"fwd": 6 * tile + 2 * ptile, "dkv": 8 * tile + 4 * ptile + 4 * 32 * 4,
                     "dq": 8 * tile + 2 * ptile}
    assert [jvp_tiling.exact_shared_bytes(k, 64) for k in ("fwd", "dkv", "dq")] == \
        [58368, 83968, 75008]
    bwd = {k: flash_tiling.bwd_exact_shared_bytes(k, D) for k in ("dkv", "dq")}
    assert bwd == {"dkv": 4 * tile + 2 * ptile + 2 * 32 * 4, "dq": 4 * tile + ptile}
    # at 64 B2/B3 exact keep their static arrays, under the 48 KB default
    assert [flash_tiling.bwd_exact_shared_bytes(k, 64) for k in ("dkv", "dq")] == [41984, 37504]
    for n in (tangent, jvp_tiling.tangent_fast_shared_bytes(D), *exact.values(), *bwd.values()):
        assert n <= SMEM_LIMIT


@pytest.mark.parametrize("d", [32, 96])
def test_geometry_refuses_other_head_dims(d):
    for call in (lambda: jvp_tiling.tangent_grid(1, 64, 64, 132, d),
                 lambda: jvp_tiling.tangent_shared_bytes(d),
                 lambda: jvp_tiling.exact_shared_bytes("dkv", d),
                 lambda: flash_tiling.bwd_exact_shared_bytes("dq", d)):
        with pytest.raises(ValueError, match="head_dim"):
            call()
