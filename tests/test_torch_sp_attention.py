"""PyTorch port vs the JAX package: sequence-parallel attention.

First the kernels' global offsets (queue B, B-f2) in the plain versions of
B1 and B2/B3, and of B5 and B7/B8 on the JAX quantizer's residuals, against
the JAX kernels' q_offset/k_offset in interpret mode: tile-aligned offsets,
offsets off JAX's and the port's tiles, GQA, and rows that see no key. Then
the strategies across 4 gloo ranks
(parallel/launch.py:RankPool, spawned once for the module; the calls are
models/sharded_jobs.py's): the bf16 ring, the all-gather, Ulysses and the
zigzag ring, outputs and gradients of sum(O * dO) against JAX's one-device
attention over the whole sequence; kv_sharded_attention against JAX's under
shard_map and one device; and the int8 ring and int8 zigzag (with GQA)
against JAX's own int8 ring and zigzag under shard_map on 4 of the 8
emulated devices (tests/conftest.py), the only reference on the same
quantization grid (each shard quantized on its own grain, K smoothed with
the global mean); so are the int8 all-gather (causal and not, and GQA) and
the int8 KV-sharded attention, against JAX's own under shard_map. Rank r
sits at (data r // (model * context), model (r // context) % model,
context r % context) in both meshes.

Tolerances: the B1 and B2/B3 parity tests' (tests/test_torch_kernels.py,
tests/test_torch_train.py) and, for int8, tests/test_torch_int8.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu import flash_attention_bf16 as j_flash_bf16
from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd as j_flash_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd as j_flash_fwd
from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd as j_int8_bwd
from quantizedattention_tpu.ops.int8_fwd import (
    int8_attention_fwd_from_quantized as j_int8_fwd_from_quantized,
)
from quantizedattention_tpu.ops.int8_fwd import quantize_qkv as j_quantize_qkv
from quantizedattention_tpu.parallel import make_attention_mesh as j_mesh
from quantizedattention_tpu.parallel.collective import kv_sharded_attention as j_kv_sharded
from quantizedattention_tpu.parallel.collective import (
    kv_sharded_attention_int8 as j_kv_sharded_int8,
)
from quantizedattention_tpu.parallel.collective import (
    make_allgather_attention as j_allgather,
)
from quantizedattention_tpu.tune.config import default_block_config
from quantizedattention_tpu.parallel.ring import make_ring_attention as j_ring
from quantizedattention_tpu.parallel.zigzag import make_zigzag_attention as j_zigzag
from quantizedattention_tpu_torch.models import sharded_jobs
from quantizedattention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu_torch.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu_torch.ops.int8_fwd import int8_attention_fwd_from_quantized
from quantizedattention_tpu_torch.parallel import (
    allgather_kv_attention_int8,
    make_allgather_attention,
    zigzag_perm,
)
from quantizedattention_tpu_torch.parallel.launch import RankPool

torch.set_num_threads(2)

# B1 plain vs the JAX kernel (tests/test_torch_kernels.py)
O_TOL, LSE_TOL = 5e-3, 1e-3
# B2/B3 plain vs the JAX kernels (tests/test_torch_train.py): exact mode to
# 1e-4 of max|JAX|; fast mode rounds every product's operands to bf16 where
# JAX on the CPU computes in f32: relative L2
EXACT_TOL, FAST_REL_L2 = 1e-4, 1e-2
# int8 against JAX's int8 ring / zigzag (tests/test_torch_int8.py): O and lse
# as B5 plain vs JAX, gradients as the int8 autograd vs jax.grad (the two
# sides' K means differ in summation order, so a few K payload entries can
# land one quantization step apart)
INT8_GRAD_REL_L2 = 1e-3
# B5 plain vs the JAX kernel and B7/B8 plain vs the JAX kernels on the same
# residuals (tests/test_torch_int8.py): O and lse as B1's; the gradients as
# max|diff| / max|JAX| per tensor
INT8_BWD_REL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkvdo(seed, b, h, h_kv, t, s):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((b, h, t, 64), (b, h_kv, s, 64), (b, h_kv, s, 64), (b, h, t, 64))]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# --------------------------------------------------------------------------
# B1, B2/B3 with global offsets: plain versions vs the JAX kernels
# --------------------------------------------------------------------------

OFFSET_CASES = [  # (b, h, h_kv, t, s, q_offset, k_offset): every row sees a key
    (1, 2, 2, 256, 256, 256, 256),   # the ring's diagonal step
    (1, 2, 2, 256, 256, 256, 0),     # a past shard: nothing masked
    (1, 4, 2, 128, 256, 128, 0),     # the all-gather launch, GQA rep 2
    (1, 4, 2, 300, 700, 1000, 37),   # off every tile grid, GQA
    (1, 2, 1, 77, 201, 150, 90),     # ragged, rep 2
]


@pytest.mark.parametrize("case", OFFSET_CASES, ids=lambda c: "t{}s{}q{}k{}h{}kv{}".format(
    *c[3:], *c[1:3]))
def test_offsets_plain_match_jax(case):
    b, h, h_kv, t, s, qo, ko = case
    q, k, v, do = _qkvdo(1000 * t + s + qo, b, h, h_kv, t, s)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o_j, lse_j = j_flash_fwd(jq, jk, jv, causal=True, q_offset=qo, k_offset=ko)
    o_t, lse_t = flash_attention_fwd(*map(_t, (q, k, v)), causal=True, q_offset=qo, k_offset=ko)
    assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= O_TOL
    assert np.abs(lse_t.numpy() - np.asarray(lse_j)).max() <= LSE_TOL
    want = j_flash_bwd(jq, jk, jv, o_j, lse_j, jdo, causal=True, q_offset=qo, k_offset=ko)
    args = [_t(x) for x in (q, k, v, o_j, lse_j, do)]
    exact = flash_attention_bwd(*args, causal=True, fast=False, q_offset=qo, k_offset=ko)
    fast = flash_attention_bwd(*args, causal=True, fast=True, q_offset=qo, k_offset=ko)
    for e, f, w in zip(exact, fast, want):
        w = np.asarray(w)
        assert np.abs(e.numpy() - w).max() <= EXACT_TOL * np.abs(w).max()
        assert _rel_l2(f.numpy(), w) <= FAST_REL_L2


EMPTY_CASES = [  # (b, h, h_kv, t, s, q_offset, k_offset): rows below k_offset - q_offset see none
    (1, 2, 2, 256, 256, 0, 256),   # every row: no tile is live (kv_sharded's first ranks)
    (1, 4, 2, 256, 512, 0, 128),   # rows 0-127 inside a live tile of JAX's (block_q 256)
    (1, 2, 2, 200, 300, 0, 77),    # rows 0-76, off every tile grid
]


def _empty_rows(t, qo, ko):
    return np.arange(t) + qo - ko < 0


def _unseen_keys(t, s, qo, ko):
    return np.arange(s) + ko > t - 1 + qo


@pytest.mark.parametrize("case", EMPTY_CASES, ids=lambda c: "t{}s{}q{}k{}".format(*c[3:]))
def test_rows_without_keys_give_zero(case):
    """A row that sees no key gives O = 0 and lse = -inf, and no gradient
    flows through it: dQ = 0 there, and a key no row sees gets dK = dV = 0;
    the other rows match JAX."""
    b, h, h_kv, t, s, qo, ko = case
    q, k, v, do = _qkvdo(7 * t + s, b, h, h_kv, t, s)
    o_j, lse_j = j_flash_fwd(*map(jnp.asarray, (q, k, v)), causal=True, q_offset=qo, k_offset=ko)
    o_t, lse_t = flash_attention_fwd(*map(_t, (q, k, v)), causal=True, q_offset=qo, k_offset=ko)
    empty = _empty_rows(t, qo, ko)
    assert empty.any()
    assert (o_t.numpy()[:, :, empty] == 0).all() and np.isneginf(lse_t.numpy()[:, :, empty]).all()
    seen = ~empty
    if seen.any():
        assert np.abs(o_t.numpy()[:, :, seen] - np.asarray(o_j)[:, :, seen]).max() <= O_TOL
        assert np.abs(lse_t.numpy()[:, :, seen] - np.asarray(lse_j)[:, :, seen]).max() <= LSE_TOL
    unseen = _unseen_keys(t, s, qo, ko)
    for fast in (True, False):
        dq, dk, dv = flash_attention_bwd(*map(_t, (q, k, v)), o_t, lse_t, _t(do), causal=True,
                                         fast=fast, q_offset=qo, k_offset=ko)
        assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
        assert (dq.numpy()[:, :, empty] == 0).all()
        assert (dk.numpy()[:, :, unseen] == 0).all() and (dv.numpy()[:, :, unseen] == 0).all()


def test_jax_gives_rows_without_keys_inside_a_live_tile_a_finite_lse():
    """The reference defect the port does not copy (ROADMAP.md §C): in the
    JAX kernel a row that sees no key but shares a q tile with rows that do
    takes MASK_VALUE for every key, so its lse is MASK_VALUE + log2(kept
    keys) and its O the mean of their V (ops/flash_fwd.py:92-98), where the
    port gives lse -inf and O = 0. Merged over ranks (lse_weighted_merge) the
    weight exp2(lse - max) of such an lse is 0, so kv_sharded_attention's O
    agrees (test_kv_sharded_matches_jax)."""
    b, h, h_kv, t, s, qo, ko = EMPTY_CASES[1]
    q, k, v, _ = _qkvdo(3, b, h, h_kv, t, s)
    o_j, lse_j = j_flash_fwd(*map(jnp.asarray, (q, k, v)), causal=True, q_offset=qo, k_offset=ko)
    empty = _empty_rows(t, qo, ko)
    lse_j = np.asarray(lse_j)[:, :, empty]
    assert np.isfinite(lse_j).all() and lse_j.max() < -29000
    assert np.abs(np.asarray(o_j)[:, :, empty]).max() > 0
    # a q tile with no visible key at all is skipped whole: lse -inf, O = 0
    b, h, h_kv, t, s, qo, ko = EMPTY_CASES[0]
    q, k, v, _ = _qkvdo(4, b, h, h_kv, t, s)
    o_j, lse_j = j_flash_fwd(*map(jnp.asarray, (q, k, v)), causal=True, q_offset=qo, k_offset=ko)
    assert np.isneginf(np.asarray(lse_j)).all() and (np.asarray(o_j) == 0).all()


def test_offsets_are_host_ints():
    q, k, v, _ = map(_t, _qkvdo(0, 1, 2, 2, 8, 8))
    for bad in (-1, 2.5):
        with pytest.raises(ValueError, match="q_offset and k_offset"):
            flash_attention_fwd(q, k, v, causal=True, q_offset=bad)
    res = tuple((torch.zeros((2, 128, 64), dtype=torch.int8), torch.ones((2, 1)))
                for _ in range(3))
    for bad in (-1, 2.5):
        with pytest.raises(ValueError, match="q_offset and k_offset"):
            int8_attention_fwd_from_quantized(res, (1, 2, 8, 8, 64), causal=True, k_offset=bad)


# --------------------------------------------------------------------------
# B5, B7/B8 with global offsets: plain versions vs the JAX kernels
# --------------------------------------------------------------------------

def _int8_case(seed, b, h, h_kv, t, s, qo, ko):
    """Inputs, k_mean and the JAX side's residuals (default_block_config's
    grain), O and lse at the offsets."""
    q, k, v, do = _qkvdo(seed, b, h, h_kv, t, s)
    k_mean = k.mean(axis=2, keepdims=True)
    res = j_quantize_qkv(*map(jnp.asarray, (q, k, v)), default_block_config("int8", t, s, 64),
                         k_sub=jnp.asarray(k_mean))
    dims = (b, h, t, s, 64)
    o, lse = j_int8_fwd_from_quantized(res, dims, causal=True, q_offset=qo, k_offset=ko)
    return res, dims, k_mean, do, np.asarray(o), np.asarray(lse)


def _res_t(res):
    return tuple((_t(x), _t(sc)) for x, sc in res)


@pytest.mark.parametrize("case", OFFSET_CASES, ids=lambda c: "t{}s{}q{}k{}h{}kv{}".format(
    *c[3:], *c[1:3]))
def test_int8_offsets_plain_match_jax(case):
    b, h, h_kv, t, s, qo, ko = case
    res, dims, k_mean, do, o_j, lse_j = _int8_case(3000 * t + s + qo, *case)
    o_t, lse_t = int8_attention_fwd_from_quantized(_res_t(res), dims, causal=True, q_offset=qo,
                                                   k_offset=ko)
    assert np.abs(o_t.numpy() - o_j).max() <= O_TOL
    assert np.abs(lse_t.numpy() - lse_j).max() <= LSE_TOL
    want = j_int8_bwd(res, jnp.asarray(k_mean), jnp.asarray(o_j), jnp.asarray(lse_j),
                      jnp.asarray(do), dims, causal=True, q_offset=qo, k_offset=ko)
    got = int8_attention_bwd(_res_t(res), _t(k_mean), _t(o_j), _t(lse_j), _t(do), dims,
                             causal=True, q_offset=qo, k_offset=ko)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= INT8_BWD_REL * np.abs(w).max()


@pytest.mark.parametrize("case", EMPTY_CASES, ids=lambda c: "t{}s{}q{}k{}".format(*c[3:]))
def test_int8_rows_without_keys_give_zero(case):
    """B5's plain version gives a row that sees no key O = 0 and lse = -inf
    (C4's rule; the JAX kernel gives one inside a live tile a finite lse),
    the other rows JAX's. B7/B8's, on those O and lse (JAX's on the rows that
    see a key), give such a row dQ = 0 and a key no row sees dK = dV = 0, and
    match JAX everywhere: JAX's backward masks such a row's P to 0 too."""
    b, h, h_kv, t, s, qo, ko = case
    res, dims, k_mean, do, o_j, lse_j = _int8_case(11 * t + s, *case)
    o_t, lse_t = int8_attention_fwd_from_quantized(_res_t(res), dims, causal=True, q_offset=qo,
                                                   k_offset=ko)
    empty = _empty_rows(t, qo, ko)
    assert empty.any()
    assert (o_t.numpy()[:, :, empty] == 0).all() and np.isneginf(lse_t.numpy()[:, :, empty]).all()
    seen = ~empty
    if seen.any():
        assert np.abs(o_t.numpy()[:, :, seen] - o_j[:, :, seen]).max() <= O_TOL
        assert np.abs(lse_t.numpy()[:, :, seen] - lse_j[:, :, seen]).max() <= LSE_TOL
    o_in = np.where(empty[:, None], 0.0, o_j).astype(np.float32)
    lse_in = np.where(empty, -np.inf, lse_j).astype(np.float32)
    want = j_int8_bwd(res, jnp.asarray(k_mean), jnp.asarray(o_j), jnp.asarray(lse_j),
                      jnp.asarray(do), dims, causal=True, q_offset=qo, k_offset=ko)
    dq, dk, dv = int8_attention_bwd(_res_t(res), _t(k_mean), _t(o_in), _t(lse_in), _t(do), dims,
                                    causal=True, q_offset=qo, k_offset=ko)
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
    unseen = _unseen_keys(t, s, qo, ko)
    assert (dq.numpy()[:, :, empty] == 0).all()
    assert (dk.numpy()[:, :, unseen] == 0).all() and (dv.numpy()[:, :, unseen] == 0).all()
    for g, w in zip((dq, dk, dv), want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= INT8_BWD_REL * np.abs(w).max()


# --------------------------------------------------------------------------
# The strategies on 4 ranks
# --------------------------------------------------------------------------

B, H, H_KV, T = 2, 4, 2, 256  # GQA rep 2; model 2 leaves 2 q / 1 kv heads a rank
STRATEGIES = [  # (strategy, mesh (data, model, context))
    ("ring", (1, 2, 2)),
    ("ring", (1, 1, 4)),
    ("allgather", (1, 2, 2)),
    ("ulysses", (2, 1, 2)),
    ("zigzag", (1, 2, 2)),
    ("zigzag", (1, 1, 4)),
]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


@pytest.fixture(scope="module")
def inputs():
    return _qkvdo(20, B, H, H_KV, T, T)


@pytest.fixture(scope="module")
def one_device(inputs):
    """JAX's one-device bf16 attention over the whole sequence and the
    gradients of sum(O * dO), exact backward."""
    q, k, v, do = map(jnp.asarray, inputs)

    def loss(q_, k_, v_):
        return jnp.sum(j_flash_bf16(q_, k_, v_, causal=True, bwd_exact=True) * do)

    o = j_flash_bf16(q, k, v, causal=True)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x) for x in (o, *grads)]


def _block(a, rank, shape):
    """Rank `rank`'s (batch, head, token) block of the global array `a`."""
    data, model, context = shape
    coords = (rank // (model * context), (rank // context) % model, rank % context)
    index = []
    for dim, (n, c) in enumerate(zip(shape, coords)):
        size = a.shape[dim] // n
        index.append(slice(c * size, (c + 1) * size))
    return np.asarray(a)[tuple(index)]


def _zigzag(a, context):
    return np.asarray(a)[:, :, zigzag_perm(context, a.shape[2]).numpy()]


@pytest.mark.parametrize("strategy,shape", STRATEGIES, ids=lambda x: str(x))
def test_bf16_strategy_matches_one_device(pool, inputs, one_device, strategy, shape):
    outs = pool.run(sharded_jobs.sp_attention, strategy, "bf16", *map(_t, inputs), shape, "cpu")
    for rank, got in enumerate(outs):
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, one_device):
            if strategy == "zigzag":
                w = _zigzag(w, shape[2])
            w = _block(w, rank, shape)
            assert g.shape == w.shape
            if name == "o":
                assert np.abs(g.numpy() - w).max() <= O_TOL, (rank, name)
            else:
                assert _rel_l2(g.numpy(), w) <= FAST_REL_L2, (rank, name)


@pytest.fixture(scope="module")
def kv_inputs():
    """q over 800 positions (replicated), K/V sharded 4 ways: t_local 200,
    no multiple of JAX's block_q."""
    return _qkvdo(21, 1, 4, 2, 800, 800)[:3]


def test_kv_sharded_matches_jax(pool, kv_inputs):
    q, k, v = kv_inputs
    mesh = j_mesh(context=4)
    spec_q, spec_kv = jax.sharding.PartitionSpec(), jax.sharding.PartitionSpec(
        None, None, "context", None)
    sharded = jax.jit(jax.shard_map(
        lambda q_, k_, v_: j_kv_sharded(q_, k_, v_, "context", causal=True),
        mesh=mesh, in_specs=(spec_q, spec_kv, spec_kv), out_specs=spec_q, check_vma=False))
    want = np.asarray(sharded(*map(jnp.asarray, (q, k, v))))
    one, _ = j_flash_fwd(*map(jnp.asarray, (q, k, v)), causal=True)
    outs = pool.run(sharded_jobs.kv_sharded, *map(_t, (q, k, v)), (1, 1, 4), True, "cpu")
    for got in outs:
        assert np.abs(got.numpy() - want).max() <= O_TOL
        assert np.abs(got.numpy() - np.asarray(one)).max() <= O_TOL
        assert torch.equal(got, outs[0])


def _int8_reference(kind, strategy, inputs, shape):
    """JAX's own int8 ring or zigzag under shard_map: O and the gradients of
    sum(O * dO) on the global arrays (zigzag: of the permuted sequence)."""
    q, k, v, do = map(jnp.asarray, inputs)
    mesh = j_mesh(*shape)
    if strategy == "ring":
        fn = j_ring(mesh, kind=kind, causal=True)
    else:
        fn = j_zigzag(mesh, kind=kind)
    o = fn(q, k, v)
    grads = jax.grad(lambda *x: jnp.sum(fn(*x) * do), argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x) for x in (o, *grads)]


@pytest.mark.parametrize("strategy", ["ring", "zigzag"])
def test_int8_strategy_matches_jax(pool, inputs, strategy):
    shape = (1, 2, 2)
    want = _int8_reference("int8", strategy, inputs, shape)
    outs = pool.run(sharded_jobs.sp_attention, strategy, "int8", *map(_t, inputs), shape, "cpu")
    for rank, got in enumerate(outs):
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            if strategy == "zigzag":
                w = _zigzag(w, shape[2])
            w = _block(w, rank, shape)
            if name == "o":
                assert np.abs(g.numpy() - w).max() <= O_TOL, (rank, name)
            else:
                assert _rel_l2(g.numpy(), w) <= INT8_GRAD_REL_L2, (rank, name)


# the int8 all-gather and KV-sharded attentions against JAX's own under
# shard_map: (h, h_kv, causal); T 512 over context 4 (t_local 128, the least
# JAX takes), GQA as tests/test_distributed.py:775
ALLGATHER_INT8_CASES = [(2, 2, True), (2, 2, False), (4, 2, True)]


@pytest.mark.parametrize("h,h_kv,causal", ALLGATHER_INT8_CASES,
                         ids=lambda x: str(x))
def test_int8_allgather_matches_jax(pool, h, h_kv, causal):
    shape = (1, 1, 4)
    inputs = _qkvdo(40 + h + int(causal), 1, h, h_kv, 512, 512)
    q, k, v, do = map(jnp.asarray, inputs)
    fn = j_allgather(j_mesh(*shape), causal=causal, kind="int8")
    o = fn(q, k, v)
    grads = jax.grad(lambda *x: jnp.sum(fn(*x) * do), argnums=(0, 1, 2))(q, k, v)
    want = [np.asarray(x) for x in (o, *grads)]
    outs = pool.run(sharded_jobs.allgather, "int8", *map(_t, inputs), shape, causal, "cpu")
    for rank, got in enumerate(outs):
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            w = _block(w, rank, shape)
            assert g.shape == w.shape, (rank, name)
            if name == "o":
                assert np.abs(g.numpy() - w).max() <= O_TOL, (rank, name)
            else:
                assert _rel_l2(g.numpy(), w) <= INT8_GRAD_REL_L2, (rank, name)


@pytest.mark.parametrize("causal", [True, False])
def test_int8_kv_sharded_matches_jax(pool, causal):
    """q over 256 positions (replicated), K/V over context 4 (t_local 64)."""
    q, k, v, _ = _qkvdo(22 + int(causal), 1, 2, 2, 256, 256)
    spec_q, spec_kv = jax.sharding.PartitionSpec(), jax.sharding.PartitionSpec(
        None, None, "context", None)
    sharded = jax.jit(jax.shard_map(
        lambda q_, k_, v_: j_kv_sharded_int8(q_, k_, v_, "context", causal=causal),
        mesh=j_mesh(context=4), in_specs=(spec_q, spec_kv, spec_kv), out_specs=spec_q,
        check_vma=False))
    want = np.asarray(sharded(*map(jnp.asarray, (q, k, v))))
    outs = pool.run(sharded_jobs.kv_sharded, *map(_t, (q, k, v)), (1, 1, 4), causal, "cpu",
                    "int8")
    for got in outs:
        assert np.abs(got.numpy() - want).max() <= O_TOL
        assert torch.equal(got, outs[0])


class _Mesh:
    """Enough of a DeviceMesh for the checks made before any collective."""

    mesh_dim_names = ("data", "model", "context")

    def size(self, dim):
        return 1

    def get_local_rank(self, axis):
        return 0


def test_int8_collectives_need_offsets():
    """The int8 all-gather keeps JAX's refusals, made before any collective:
    t_local a multiple of 128 (collective.py:153-154), and of the kv block
    and grain of the config clamped to the shard (:155-163); the int8 kind
    of make_allgather_attention is the int8 all-gather."""
    for t_local, match in ((100, "t_local % 128"), (8320, "multiple of the kv block")):
        q, k, v, _ = map(_t, _qkvdo(0, 1, 2, 2, t_local, t_local))
        with pytest.raises(ValueError, match=match):
            allgather_kv_attention_int8(q, k, v, _Mesh())
        with pytest.raises(ValueError, match=match):
            make_allgather_attention(_Mesh(), kind="int8")(q, k, v)
    with pytest.raises(ValueError, match="unknown kind"):
        make_allgather_attention(_Mesh(), kind="fp8")
