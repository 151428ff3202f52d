"""PyTorch port vs the JAX package at head dim 128: the int4 decode family
(B15/B16) and the rCM step's kernels (B1 fp32, B9, B11 and B12 fast).

The same numpy inputs go to the JAX package (its Pallas kernels in
interpret mode on the CPU, as its own tests run them) and to the port, which
on CPU tensors runs its kernels' plain versions. The CUDA kernels at 128 are
held against those plain versions on the card by chip_smoke.py (phase 30).

Covered: the int4 decode and verify plains (slotted and paged, GQA rep 1
and 4) against the JAX kernels; the int4 writers and prefix readers byte for
byte against the jitted JAX ones; B1 fp32's plain version and
`attention_value_and_jvp(fast=True)` (O, tO and the six gradients) against
the JAX package's; the rCM loss and every gradient of a small DiT at head
dim 128 carried over by `dit_params_from_jax`; the launch geometry of the
new d=128 instances; the int4 engine at a small d=128 GQA LM, paged tokens
equal to slotted ones and teacher-forced decode logits against JAX's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu import attention_value_and_jvp as jax_value_and_jvp
from quantizedattention_tpu.models import dit as jdit
from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd as jax_flash_fwd
from quantizedattention_tpu.parallel import kv4_cache as j4
from quantizedattention_tpu.parallel import paged4_cache as jp4
from quantizedattention_tpu.quantize.weights import embedding_lookup as j_embed
from quantizedattention_tpu.quantize.weights import mm as j_mm
from quantizedattention_tpu_torch.models import (
    DiTConfig,
    TransformerConfig,
    dit_param_leaves,
    dit_params_from_jax,
    params_from_jax,
    prefill_slots,
    rcm_loss,
)
from quantizedattention_tpu_torch.models.transformer import _decode_logits
from quantizedattention_tpu_torch.ops import attention_value_and_jvp, flash_attention_fwd_fp32
from quantizedattention_tpu_torch.ops import flash_tiling, jvp_tiling
from quantizedattention_tpu_torch.parallel import decode_tiling as dt
from quantizedattention_tpu_torch.parallel import kv4_cache as t4
from quantizedattention_tpu_torch.parallel import paged4_cache as tp4
from quantizedattention_tpu_torch.serve import ServingEngine

torch.set_num_threads(2)

D = 128
# Decode plain version vs the Pallas kernel: only the summation order and
# where P is rounded to bf16 differ (as at 64, test_torch_kv_caches.py).
DECODE_TOL = 5e-3
# B1 fp32: both sides f32 from the same inputs, differing in summation order
# only (as at 64, test_torch_jvp.py): 1e-4 of max|want|.
EXACT_TOL = 1e-4
# Fast mode rounds every product's operands to bf16 while the JAX side on
# the CPU computes in f32: the JAX package's fast-vs-exact envelope
# (tests/test_jvp_grad.py), O 2e-2 and tO / gradients 5e-2 of max|want|.
FAST_O_TOL, FAST_TOL = 2e-2, 5e-2
# The rCM loss and gradients, exact mode: the JAX test's criterion
# (tests/test_models.py), max|diff| < 2e-3 of max|want| per tensor.
GRAD_REL = 2e-3
# Teacher-forced decode logits through two layers of int4 attention noise
# (as test_torch_kv_caches.py).
LOGIT_TOL = 2e-2
PS = 128  # the JAX paged caches take 128-multiples


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _assert_equal(tcache, jcache, skip_page0=False):
    """Every field byte-equal (a paged pool's page 0, where the port parks
    the writes JAX drops, left out)."""
    for name, got, want in zip(tcache._fields, tcache, jcache):
        got, want = got.numpy(), np.asarray(want)
        if skip_page0 and name in ("k_p", "v_p"):
            got, want = got[:, 1:], want[:, 1:]
        elif skip_page0 and name in ("sk", "sv"):
            got, want = got[1:], want[1:]
        np.testing.assert_array_equal(got, want, err_msg=name)


# --------------------------------------------------------------------------
# B15 and B16: the decode and verify plains against the JAX kernels
# --------------------------------------------------------------------------

LENGTHS = [0, 1, 127, 128, 129, 255, 300, 512]


def _slotted4(rng, n_kv, lengths=LENGTHS, max_len=512):
    b = len(lengths)
    fields = [rng.integers(-128, 128, (b, n_kv, max_len // 2, D), dtype=np.int8),
              rng.uniform(0.002, 0.03, (b, n_kv, max_len)).astype(np.float32),
              rng.integers(-128, 128, (b, n_kv, max_len // 2, D), dtype=np.int8),
              rng.uniform(0.002, 0.03, (b, n_kv, max_len)).astype(np.float32),
              np.asarray(lengths, np.int32)]
    return (j4.Int4KVCache(*(jnp.asarray(a) for a in fields)),
            t4.Int4KVCache(*(_t(a) for a in fields)))


def _paged4(rng, n_kv, lengths=LENGTHS, max_pages=4):
    """A pool whose pages are shuffled across sequences; page 0 and every
    page past a row's length hold junk payloads."""
    n = len(lengths)
    n_pages = 1 + n * max_pages
    jc = jp4.init_paged4_cache(n_kv, n_pages, n, max_pages, D, PS)
    fields = [rng.integers(-128, 128, x.shape, dtype=np.int8) if x.dtype == jnp.int8
              else rng.uniform(0.002, 0.03, x.shape).astype(np.float32) for x in jc[:4]]
    table = rng.permutation(np.arange(1, n_pages)).reshape(n, max_pages).astype(np.int32)
    for row, length in enumerate(lengths):
        table[row, -(-length // PS):] = 0
    fields += [table, np.asarray(lengths, np.int32)]
    return (type(jc)(*(jnp.asarray(a) for a in fields)),
            tp4.Paged4KVCache(*(_t(a) for a in fields)))


CACHES = {"int4": (_slotted4, j4.decode_attention_int4, t4.decode_attention_int4,
                   j4.verify_decode_attention_int4, t4.verify_decode_attention_int4),
          "paged4": (_paged4, jp4.paged4_decode_attention, tp4.paged4_decode_attention,
                     jp4.paged4_verify_attention, tp4.paged4_verify_attention)}


@pytest.mark.parametrize("kind", sorted(CACHES))
@pytest.mark.parametrize("n_q,n_kv", [(2, 2), (8, 2)], ids=["rep1", "rep4"])
def test_decode4_plain_matches_jax_at_128(kind, n_q, n_kv):
    make, jdecode, tdecode, _, _ = CACHES[kind]
    rng = np.random.default_rng(30 + n_q)
    jc, tc = make(rng, n_kv)
    q = rng.standard_normal((len(LENGTHS), n_q, D), np.float32)
    o_j, lse_j = jdecode(jnp.asarray(q), jc, return_lse=True)
    o_t, lse_t = tdecode(_t(q), tc, return_lse=True)
    assert o_t.shape == (len(LENGTHS), n_q, D) and o_t.dtype == torch.float32
    assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= DECODE_TOL
    live = np.asarray(LENGTHS) > 0
    assert np.abs(lse_t.numpy()[live] - np.asarray(lse_j)[live]).max() <= DECODE_TOL
    assert (o_t[~torch.from_numpy(live)] == 0).all()
    assert torch.isneginf(lse_t[~torch.from_numpy(live)]).all()


@pytest.mark.parametrize("kind", sorted(CACHES))
def test_verify4_staircase_matches_jax_at_128(kind):
    """spec 4: each query row j sees the tokens before len - 3 + j; against
    the JAX verify function and, row by row, the port's own decode at that
    bound."""
    make, _, tdecode, jverify, tverify = CACHES[kind]
    rng = np.random.default_rng(40)
    jc, tc = make(rng, 2)
    spec = 4
    q = rng.standard_normal((len(LENGTHS), 8, spec, D), np.float32)
    got = tverify(_t(q), tc)
    want = np.asarray(jverify(jnp.asarray(q), jc))
    sees = (np.asarray(LENGTHS)[:, None] - spec + 1 + np.arange(spec)[None]) > 0
    seen = np.broadcast_to(sees[:, None, :, None], want.shape)
    assert np.abs(got.numpy()[seen] - want[seen]).max() <= DECODE_TOL
    assert (got.numpy()[~seen] == 0).all() and np.isfinite(got.numpy()).all()
    for j in range(spec):
        bound = (tc[-1] - spec + 1 + j).clamp(min=0).to(torch.int32)
        row = tdecode(_t(q[:, :, j]), type(tc)(*tc[:-1], bound))
        torch.testing.assert_close(got[:, :, j], row, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# The int4 writers and prefix readers: byte-equal to the jitted JAX ones
# --------------------------------------------------------------------------

def _filled4(rng, b=5, h=2, max_len=512, lengths=(1, 127, 128, 301, 510)):
    fields = [rng.integers(-128, 128, (b, h, max_len // 2, D), dtype=np.int8),
              rng.uniform(0.01, 0.1, (b, h, max_len)).astype(np.float32),
              rng.integers(-128, 128, (b, h, max_len // 2, D), dtype=np.int8),
              rng.uniform(0.01, 0.1, (b, h, max_len)).astype(np.float32),
              np.asarray(lengths, np.int32)]
    return (j4.Int4KVCache(*(jnp.asarray(a) for a in fields)),
            t4.Int4KVCache(*(_t(a) for a in fields)))


@pytest.mark.parametrize("t_new", [1, 3, 130])
def test_append_kv4_matches_jax_at_128(t_new):
    """Odd offsets, so both nibbles of a byte row get written, an inactive
    row and a row that runs past max_len (JAX drops those tokens)."""
    rng = np.random.default_rng(50 + t_new)
    jc, tc = _filled4(rng)
    k = rng.standard_normal((5, 2, t_new, D), np.float32)
    v = rng.standard_normal((5, 2, t_new, D), np.float32)
    active = np.asarray([True, False, True, True, True])
    jc = jax.jit(j4.append_kv4)(jc, jnp.asarray(k), jnp.asarray(v), active=jnp.asarray(active))
    tc = t4.append_kv4(tc, _t(k), _t(v), active=_t(active))
    _assert_equal(tc, jc)


def test_write_slot_chunk_and_read_prefix_match_jax_at_128():
    rng = np.random.default_rng(60)
    jc, tc = _filled4(rng, b=3, lengths=(7, 9, 11))
    write = jax.jit(j4.write_kv4_slot)  # it runs inside the jitted prefills
    for slot, t, true_len in ((1, 100, 97), (0, 300, 300)):
        k = rng.standard_normal((2, t, D), np.float32)
        v = rng.standard_normal((2, t, D), np.float32)
        jc = write(jc, jnp.int32(slot), jnp.asarray(k), jnp.asarray(v), jnp.int32(true_len))
        tc = t4.write_kv4_slot(tc, slot, _t(k), _t(v), true_len)
    _assert_equal(tc, jc)
    # a chunk starting in a pack block's second half (one nibble of each byte row)
    k = rng.standard_normal((2, 128, D), np.float32)
    v = rng.standard_normal((2, 128, D), np.float32)
    jc = jax.jit(j4.write_kv4_chunk)(jc, jnp.int32(2), jnp.asarray(k), jnp.asarray(v),
                                     jnp.int32(128), jnp.int32(256))
    tc = t4.write_kv4_chunk(tc, 2, _t(k), _t(v), 128, 256)
    _assert_equal(tc, jc)
    for slot, n in ((0, 256), (2, 256), (1, 128)):
        for got, want in zip(t4.read_prefix_kv4(tc, slot, n),
                             j4.read_prefix_kv4(jc, jnp.int32(slot), n)):
            assert got.shape == (2, n, D)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged4_writers_and_read_prefix_match_jax_at_128():
    rng = np.random.default_rng(70)
    jc, tc = _paged4(rng, 2, lengths=[0, 0, 0])
    k = rng.standard_normal((2, 2 * PS, D), np.float32)
    v = rng.standard_normal((2, 2 * PS, D), np.float32)
    rows = np.asarray([[3, 5, 0, 0], [7, 1, 2, 0], [4, 6, 8, 9]], np.int32)
    for s in range(3):
        jc = jp4.assign_pages4(jc, jnp.int32(s), jnp.asarray(rows[s]))
        tc = tp4.assign_pages4(tc, s, _t(rows[s]))
    jc = jp4.write_prompt_paged4(jc, jnp.int32(1), jnp.asarray(k), jnp.asarray(v), jnp.int32(200))
    tc = tp4.write_prompt_paged4(tc, 1, _t(k), _t(v), 200)
    _assert_equal(tc, jc)
    k2 = rng.standard_normal((3, 2, 5, D), np.float32)
    v2 = rng.standard_normal((3, 2, 5, D), np.float32)
    active = np.asarray([True, True, False])
    jc = jp4.append_tokens_paged4(jc, jnp.asarray(k2), jnp.asarray(v2), jnp.asarray(active))
    tc = tp4.append_tokens_paged4(tc, _t(k2), _t(v2), _t(active))
    _assert_equal(tc, jc, skip_page0=True)
    for got, want in zip(tp4.read_prefix_paged4(tc, 1, 2 * PS),
                         jp4.read_prefix_paged4(jc, jnp.int32(1), 2 * PS)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# B1 fp32 and the fast pair (B9 forward, B11 + B12 backward)
# --------------------------------------------------------------------------

def _inputs(b, h, t, s, seed):
    """q, k, v, tq, tk, tv, and two output weights: f32 numpy at d=128."""
    rng = np.random.default_rng(seed)
    q_side = [rng.standard_normal((b, h, t, D), np.float32) for _ in range(4)]
    kv_side = [rng.standard_normal((b, h, s, D), np.float32) for _ in range(4)]
    return (q_side[0], kv_side[0], kv_side[1], q_side[1], kv_side[2], kv_side[3],
            q_side[2], q_side[3])


@pytest.mark.parametrize("t,s,causal", [(128, 128, True), (77, 201, False), (200, 130, True)])
def test_flash_fwd_fp32_plain_matches_jax_at_128(t, s, causal):
    q, k, v = _inputs(1, 2, t, s, seed=t + s)[:3]
    o_w, lse_w = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               precision="fp32")
    o, lse = flash_attention_fwd_fp32(_t(q), _t(k), _t(v), causal=causal)
    assert o.shape == (1, 2, t, D) and o.dtype == torch.float32
    assert _max_rel(o, o_w) <= EXACT_TOL
    assert np.abs(lse.numpy() - np.asarray(lse_w)).max() <= EXACT_TOL


@pytest.mark.parametrize("t,s,causal", [(128, 128, False), (77, 201, True)])
def test_value_and_jvp_fast_forward_and_grads_match_jax_at_128(t, s, causal):
    """fast=True on both sides: (O, tO) and jax.grad's six gradients of a
    mixed loss, within the JAX package's fast-vs-exact envelope (the JAX side
    is f32 on the CPU)."""
    arrays = _inputs(1, 2, t, s, seed=7 * t + s)
    q, k, v, tq, tk, tv, wo, wt = arrays

    def jax_loss(*a):
        o, to = jax_value_and_jvp(*a, causal=causal, fast=True)
        return jnp.sum(jnp.sin(o) * wo) + jnp.sum(to * wt) + jnp.sum(to ** 2)

    inputs = [jnp.asarray(x) for x in arrays[:6]]
    o_w, to_w = jax_value_and_jvp(*inputs, causal=causal, fast=True)
    want = jax.grad(jax_loss, argnums=tuple(range(6)))(*inputs)
    leaves = [_t(x).requires_grad_(True) for x in arrays[:6]]
    o, to = attention_value_and_jvp(*leaves, causal=causal, fast=True)
    assert _max_rel(o.detach(), o_w) <= FAST_O_TOL
    assert _max_rel(to.detach(), to_w) <= FAST_TOL
    loss = (torch.sin(o) * _t(wo)).sum() + (to * _t(wt)).sum() + to.square().sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w, name in zip(got, want, ("q", "k", "v", "tq", "tk", "tv")):
        assert g.shape == w.shape and g.abs().max() > 0, name
        assert _max_rel(g, w) <= FAST_TOL, name


# --------------------------------------------------------------------------
# The rCM loss on a small DiT at head dim 128
# --------------------------------------------------------------------------

DIT = dict(d_model=256, n_heads=2, head_dim=D, n_layers=1, seq_len=128)


def test_rcm_loss_and_grads_match_jax_at_128():
    """`ada` and `out` drawn nonzero on both sides (at the JAX init they are
    zero and attention never reaches the loss); params carried over by
    dit_params_from_jax. Exact mode within the JAX test's criterion; fast
    mode (the rCM step's, bf16 operands) within the fast envelope."""
    jcfg = jdit.DiTConfig(**DIT)
    jparams = jdit.init_dit(jax.random.key(0), jcfg)
    rng = np.random.default_rng(11)
    d = DIT["d_model"]
    jparams["out"] = jnp.asarray(rng.standard_normal((d, d), np.float32) / math.sqrt(d))
    for layer in jparams["layers"]:
        layer["ada"] = jnp.asarray(rng.standard_normal((d, 6 * d), np.float32) / math.sqrt(d))
    x = rng.standard_normal((2, DIT["seq_len"], d), np.float32)
    t = rng.uniform(size=2).astype(np.float32)

    def jax_loss(p):
        u, dudt = jdit.dit_jvp_step(p, jnp.asarray(x), jnp.asarray(t), jcfg)
        return jnp.mean(dudt ** 2) + 0.1 * jnp.mean(u ** 2)

    loss_w, grads_w = jax.value_and_grad(jax_loss)(jparams)
    top = [grads_w[key] for key in ("t_mlp1", "t_mlp2", "out")]
    keys = ("ada", "wq", "wk", "wv", "wo", "w1", "w2")
    want = [np.asarray(g) for g in top + [lyr[k] for lyr in grads_w["layers"] for k in keys]]
    cfg = DiTConfig(**DIT)
    for fast, tol in ((False, GRAD_REL), (True, FAST_TOL)):
        params = dit_params_from_jax(jparams, "cpu")
        assert params["layers"][0]["wq"].shape == (d, 2 * D)
        leaves = dit_param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = rcm_loss(params, torch.from_numpy(x), torch.from_numpy(t), cfg, fast=fast)
        grads = torch.autograd.grad(loss, leaves)
        assert abs(loss.item() - float(loss_w)) <= tol * abs(float(loss_w)), fast
        for i, (g, w) in enumerate(zip(grads, want)):
            assert g.shape == w.shape and torch.isfinite(g).all(), (fast, i)
            assert g.abs().max() > 0, (fast, i)
            assert np.abs(g.numpy() - w).max() <= tol * np.abs(w).max(), (fast, i)


# --------------------------------------------------------------------------
# Launch geometry at 128
# --------------------------------------------------------------------------

SMEM_LIMIT = 232_448  # shared bytes an H100 block may use


def test_jvp_geometry_at_128():
    """B9, B11 and B12 fast and B1 fp32 at 128: the kernels' shared bytes
    (what phase 2 holds against the kernels' own counts) under the limit,
    exactly the resident tiles, the ring and the barrier area; B11's two
    launches; B9's 32-key tiles and prep rows."""
    dkv = jvp_tiling.dkv_shared_bytes(D)
    assert dkv == 4 * 128 * D * 2 + 3 * (4 * 32 * D * 2 + 4 * 32 * 4) + 128 + 1024
    assert jvp_tiling.dkv_stages(D) == 3 and jvp_tiling.dkv_parts(D) == 2
    fwd = jvp_tiling.fwd_shared_bytes(D)
    assert jvp_tiling.fwd_keys(D) == 32
    assert fwd == 2 * 128 * D * 2 + jvp_tiling.FWD_STAGES * 4 * 32 * D * 2 + 256 + 1024
    dq = jvp_tiling.dq_shared_bytes(D)
    assert jvp_tiling.dq_stages(D) == 3
    assert dq == 4 * 128 * D * 2 + 3 * 4 * 32 * D * 2 + 256 + 1024
    f32 = flash_tiling.fp32_shared_bytes(D)
    assert flash_tiling.fp32_keys(D) == 32 and flash_tiling.fp32_stages(D) == 2
    assert f32 == 2 * 64 * D * 4 + 2 * 64 * 64 * 4 + 2 * 4 * 32 * D * 4 + 128 + 1024
    for n in (dkv, fwd, dq, f32):
        assert n <= SMEM_LIMIT
    assert jvp_tiling.fwd_prep_grid(16, 4096, D) == (32, 16, 4)
    # the d=64 instances keep their geometry
    assert (jvp_tiling.dkv_stages(64), jvp_tiling.dkv_parts(64), jvp_tiling.fwd_keys(64),
            jvp_tiling.dq_stages(64), flash_tiling.fp32_keys(64)) == (6, 1, 64, 8, 64)


@pytest.mark.parametrize("t,s,causal", [(4096, 4096, False), (300, 300, True), (77, 201, True)])
def test_b9_walk_at_32_keys_covers_every_visible_pair_once(t, s, causal):
    keys = jvp_tiling.fwd_keys(D)
    _, n_qb = jvp_tiling.q_blocks(1, t)
    seen = np.zeros((t, s), np.int32)
    for y in range(n_qb):
        q0 = jvp_tiling.block_rows(y, n_qb)
        for j in range(jvp_tiling.key_tiles(q0, t, s, causal, keys)):
            rows = slice(q0, min(q0 + jvp_tiling.Q_BLOCK, t))
            seen[rows, j * keys: min((j + 1) * keys, s)] += 1
    visible = np.tril(np.ones((t, s), bool)) if causal else np.ones((t, s), bool)
    assert (seen[visible] == 1).all() and (seen <= 1).all()


def test_decode4_geometry_at_128():
    """B15/B16 at 128: a block's shared bytes (int4 byte rows of 128 bytes, a
    staged row at its owner's slot) under the limit, one block an SM, and
    the grid's z doubled to fill the card."""
    n = dt.shared_bytes("int4", D)
    assert n == dt.shared_bytes("int8", D) + 2 * (2 * dt.CHUNK)  # the slots' sources
    assert n <= SMEM_LIMIT and dt.resident(D) == 1
    assert dt.resident(D) * (n + 1024) <= dt.SM_SHARED
    assert dt.grid(4, 8, 1280, head_dim=D) == (4, 8, 4)
    assert dt.grid(4, 8, 1280, head_dim=64) == (4, 8, 5)


# --------------------------------------------------------------------------
# The int4 engine at a small d=128 GQA LM
# --------------------------------------------------------------------------

CFG128 = dict(vocab_size=64, d_model=512, n_heads=4, n_kv_heads=2, head_dim=D, n_layers=2,
              max_seq=256)
PROMPTS = [[1, 2, 3], [10, 20, 30, 40, 50, 60, 7], [5] * 12, [63, 0, 42, 17]]
BUDGETS = [4, 6, 3, 5]


@pytest.fixture(scope="module")
def lm128():
    jcfg = jtr.TransformerConfig(**CFG128)
    jparams = jtr.init_transformer(jax.random.key(3), jcfg)
    return jcfg, jparams, TransformerConfig(**CFG128), params_from_jax(jparams, "cpu")


def test_int4_engine_paged_tokens_equal_slotted_at_128(lm128):
    """4 requests on 2 slots: the paged int4 pool serves the slotted int4
    cache's tokens, token for token."""
    _, _, cfg, tparams = lm128
    runs = []
    for kw in ({}, {"cache": "paged", "page_size": 16}):
        eng = ServingEngine(tparams, cfg, "cpu", n_slots=2, kv_quant="int4", decode_horizon=2,
                            scheduler="python", **kw)
        rids = [eng.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
        out = eng.run()
        runs.append([out[r].tokens for r in rids])
        cache = tp4.Paged4KVCache if kw else t4.Int4KVCache
        assert type(eng.caches[0]) is cache and eng.caches[0][0].shape[-1] == D
    assert runs[1] == runs[0]
    assert [len(t) for t in runs[0]] == BUDGETS


@pytest.mark.parametrize("kind", ["int4", "paged4"])
def test_int4_teacher_forced_decode_matches_jax_at_128(lm128, kind):
    """Prefill two prompts into rows 1 and 0, then three teacher-forced
    decode steps: the port's logits stay within LOGIT_TOL of the JAX
    package's on the int4 caches at head dim 128."""
    jcfg, jparams, cfg, tparams = lm128
    rng = np.random.default_rng(8)
    lens = [20, 9]
    tokens = np.zeros((2, PS), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 64, n)
    slots = np.asarray([1, 0], np.int32)
    if kind == "int4":
        jcaches = [j4.init_kv4_cache(2, 2, CFG128["max_seq"], D) for _ in range(2)]
        tcaches = [t4.init_kv4_cache(2, 2, CFG128["max_seq"], D, "cpu") for _ in range(2)]
    else:
        jcaches = [jp4.init_paged4_cache(2, 5, 2, 2, D, PS) for _ in range(2)]
        tcaches = [tp4.init_paged4_cache(2, 5, 2, 2, D, PS, "cpu") for _ in range(2)]
        rows = np.asarray([[4, 1], [2, 3]], np.int32)
        for s in range(2):
            jcaches = [jp4.assign_pages4(c, jnp.int32(s), jnp.asarray(rows[s])) for c in jcaches]
            tcaches = [tp4.assign_pages4(c, s, _t(rows[s])) for c in tcaches]
    _, jcaches = jtr.prefill_slots(jparams, jcaches, jnp.asarray(tokens), jnp.asarray(lens),
                                   jnp.asarray(slots), jcfg)
    _, tcaches = prefill_slots(tparams, tcaches, _t(tokens).long(), _t(lens), _t(slots).long(),
                               cfg)
    pos = np.asarray([9, 20], np.int32)
    act = np.asarray([True, True])
    for step, tok in enumerate(rng.integers(0, 64, (3, 2), dtype=np.int32)):
        x = j_embed(jparams["embed"], jnp.asarray(tok))[:, None, :]
        new = []
        for layer, cache in zip(jparams["layers"], jcaches):
            h = jtr.rmsnorm(x, layer["ln1"])
            q, k, v = jtr._project_qkv(layer, h, jcfg, jnp.asarray(pos)[:, None])
            cache = jtr._cache_append(cache, k, v, active=jnp.asarray(act))
            o = jtr._cache_decode(q[:, :, 0, :], cache).reshape(2, 1, -1)
            x = jtr._mlp_residual(layer, x + j_mm(o.astype(x.dtype), layer["wo"]))
            new.append(cache)
        jcaches = new
        jl = j_mm(jtr.rmsnorm(x, jparams["final_norm"])[:, 0], jparams["unembed"])
        tl, tcaches = _decode_logits(tparams, tcaches, _t(tok).long(), _t(pos).long(), _t(act),
                                     cfg)
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL, f"{kind} step {step}"
        pos = pos + 1
