"""The bf16 flash forward's launch geometry (B1, csrc/flash_fwd.cu) and its Q
rounding rule, and the launch geometry of the backward's fast mode (B2 and
B3, csrc/flash_bwd.cu).

`ops.flash_tiling` holds what the wrapper passes to the kernel (bq query
positions a block, the grid) and the kernel's shared bytes. Checked here for
every GQA rep from 1 to 128 at t in {1, 63, 64, 127, 128, 129, 256, 1000,
2048}: a block's rows hold the whole group for bq positions, and the grid's
rows, mapped as the kernel maps them, cover every (q head, position < t)
exactly once; one block's shared memory fits an H100, and the grid's limits
raise. The Q rounding rule the kernel applies to each element, bf16(f32(q) *
f32(qk_scale)) rounded to nearest even, gives the bytes of the JAX package's
q.astype(f32) * qk_scale -> bf16 on f32 and on bf16 inputs.

For the backward, at every rep from 1 to 128 on ragged, cross and one-token
shapes, causal and not: B2's 128-key blocks and the 64-row q tiles they
walk (the kernel's rule, restated here) cover every (key, position) pair
that attention computes exactly once, B3's blocks cover every (q head,
position) once and walk the key tiles up to the last key one of their rows
sees, the lse/D row stride
starts each row on 16 bytes, each block's shared memory fits an H100, and
the grids' limits raise (the wrappers check them before asking for CUDA
tensors). Shared bytes, refusals and the largest launch are held at both
head dims the kernels take, 64 and 128 (and other head dims refused), and
the Q rounding rule at sm_scale = 1/sqrt(64) and 1/sqrt(128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu.ops.common import qk_scales as jax_qk_scales
from quantizedattention_tpu_torch.ops import flash_tiling as tiling
from quantizedattention_tpu_torch.ops.common import qk_scales

torch.set_num_threads(2)

TS = [1, 63, 64, 127, 128, 129, 256, 1000, 2048]
REPS = list(range(1, tiling.BLOCK_ROWS + 1))


def _grid_rows(rep, t):
    """(group, position, live) of every row of every block of one kv head, as
    the kernel maps them: grid row y starts at q0 = (n_qt - 1 - y) * bq, and
    its row r holds group r // bq at position q0 + r % bq, live when r < rep *
    bq and the position is below t."""
    bq, (_, n_qt) = tiling.grid(1, rep, t, 64)  # the same rows at every head dim
    q0 = (n_qt - 1 - np.arange(n_qt)) * bq
    r = np.arange(tiling.BLOCK_ROWS)
    pos = q0[:, None] + r % bq
    return bq, np.broadcast_to(r // bq, pos.shape), pos, (r < rep * bq) & (pos < t)


@pytest.mark.parametrize("rep", REPS)
def test_rows_cover_every_head_and_position_once(rep):
    for t in TS:
        bq, g, pos, live = _grid_rows(rep, t)
        assert bq * rep <= tiling.BLOCK_ROWS < (bq + 1) * rep
        # every (q head of the group, position < t) exactly once, nothing else
        counts = np.bincount((g * t + pos)[live], minlength=rep * t)
        assert counts.shape == (rep * t,) and (counts == 1).all(), (rep, t)
        assert (g[live] < rep).all() and (pos[live] < t).all()


@pytest.mark.parametrize("t", TS)
def test_grid_for_every_length(t):
    """One grid row per kv head, q tiles of bq = BLOCK_ROWS // rep positions,
    none of them empty, the first tile (the last grid row) at position 0."""
    for rep in REPS:
        bq, (x, n_qt) = tiling.grid(3, rep, t, 64)
        assert all(tiling.grid(3, rep, t, d) == (bq, (x, n_qt)) for d in tiling.HEAD_DIMS)
        assert x == 3 and bq == tiling.BLOCK_ROWS // rep
        assert (n_qt - 1) * bq < t <= n_qt * bq, (rep, t)


HEAD_DIMS = pytest.mark.parametrize("d", tiling.HEAD_DIMS)


@HEAD_DIMS
def test_shared_memory_fits_one_block(d):
    n = tiling.shared_bytes(d)
    assert n <= tiling.SMEM_LIMIT
    # Q, the K/V ring and the f32 O staging tile alone
    floor = (tiling.BLOCK_ROWS * d * 2 + tiling.KV_STAGES * 2 * tiling.kv_tile(d) * d * 2
             + tiling.BLOCK_ROWS * tiling.o_ld(d) * 4)
    assert floor < n <= floor + 4096
    assert tiling.KV_STAGES >= 3 and tiling.BLOCK_ROWS == 2 * 64
    # 128 keys a tile at 64; at 128 a tile of 64 keys keeps the same bytes
    assert tiling.kv_tile(d) * d == 128 * 64
    assert (n, tiling.kv_tile(d)) == ((153_728, 128) if d == 64 else (202_880, 64))


@HEAD_DIMS
@pytest.mark.parametrize("bh_kv, rep, t, match", [
    (1, 129, 64, "rep <= 128"),
    (1, 0, 64, "rep <= 128"),
    (65536, 1, 64, "b\\*h_kv"),
    (0, 1, 64, "b\\*h_kv"),
    (1, 128, 65536, "q tiles"),
])
def test_geometry_refusals(bh_kv, rep, t, match, d):
    with pytest.raises(ValueError, match=match):
        tiling.grid(bh_kv, rep, t, d)


@pytest.mark.parametrize("d", [32, 96, 256, 0])
def test_geometry_refuses_other_head_dims(d):
    for fn in (lambda: tiling.grid(1, 1, 64, d), lambda: tiling.bwd_grids(1, 1, 64, 64, d),
               lambda: tiling.shared_bytes(d), lambda: tiling.dkv_shared_bytes(d),
               lambda: tiling.dq_shared_bytes(d), lambda: tiling.kv_tile(d)):
        with pytest.raises(ValueError, match="head_dim"):
            fn()


@HEAD_DIMS
def test_largest_launch_accepted(d):
    assert tiling.grid(65535, 128, 65535, d) == (1, (65535, 65535))


def _bf16_rne(x32: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, rounded to nearest even (the kernel's
    __float2bfloat16_rn on finite values)."""
    u = x32.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


@pytest.mark.parametrize("head_dim", [64, 128])  # sm_scale None: 1/sqrt(head_dim)
@pytest.mark.parametrize("sm_scale", [None, 0.3, 0.125, 1.0, 2.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_rounding_rule_matches_jax(dtype, sm_scale, head_dim):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 333)) * np.exp2(rng.integers(-20, 20, (4, 333)))).astype(np.float32)
    x[0, :6] = [0.0, -0.0, 1.0, -3.5, 65504.0, 1e-20]
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    qk_scale = qk_scales(head_dim, sm_scale)[1]
    assert qk_scale == jax_qk_scales(head_dim, sm_scale)[1]
    want = np.asarray((xj.astype(jnp.float32) * qk_scale).astype(jnp.bfloat16)).view(np.uint16)
    # the kernel: the element widened to f32 exactly, one f32 product, rounded
    # to nearest even
    x32 = np.array(xj.astype(jnp.float32))
    got = _bf16_rne(x32 * np.float32(qk_scale))
    np.testing.assert_array_equal(got, want)
    # the plain version's rule, (q.float() * qk_scale).to(bfloat16), on the same input
    xt = torch.from_numpy(x32).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    plain = (xt.float() * qk_scale).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(plain, want)


# --------------------------------------------------------------------------
# The backward's fast mode: B2 (dK, dV) and B3 (dQ)
# --------------------------------------------------------------------------

BWD_SHAPES = [(1000, 1000), (200, 330), (330, 200), (77, 201), (1, 1), (1, 300), (128, 128),
              (40, 300), (1280, 1280)]


def _visible(t, s, causal):
    """The (key, position) pairs attention computes."""
    k, p = np.meshgrid(np.arange(s), np.arange(t), indexing="ij")
    return (k <= p) if causal else np.ones((s, t), dtype=bool)


def _check_bwd_geometry(rep, t, s, causal):
    bq, dkv, dq = tiling.bwd_grids(5, rep, t, s, 64)  # the same walks at every head dim
    tile = tiling.BWD_TILE
    assert dkv == (5, -(-s // tiling.DKV_KEYS)) and dq == (5, -(-t // bq))
    # B2: each block's q tiles (causal, from the tile holding position k0 on,
    # as csrc/flash_bwd.cu's j0; each inside [0, t) or its last ragged tile)
    # cover each pair of its keys that attention computes exactly once
    vis = _visible(t, s, causal)
    cover = np.zeros((s, t), dtype=int)
    n_qt = -(-t // tile)
    for kb in range(dkv[1]):
        k0 = kb * tiling.DKV_KEYS
        keys = slice(k0, min(k0 + tiling.DKV_KEYS, s))
        for j in range(min(k0 // tile, n_qt) if causal else 0, n_qt):
            assert j * tile < t
            cover[keys, j * tile:min(j * tile + tile, t)] += 1
    assert (cover[vis] == 1).all(), (rep, t, s, causal)
    assert cover.max() <= 1
    # B3: blocks of bq positions (last first, as the kernel walks them) cover
    # [0, t) once per q head; each walks the key tiles up to the last key one
    # of its rows sees (causal, csrc/flash_bwd.cu's kv_hi = min(s, t, q0 + bq))
    starts = [(dq[1] - 1 - y) * bq for y in range(dq[1])]
    assert sorted(p for q0 in starts for p in range(q0, min(q0 + bq, t))) == list(range(t))
    assert rep * bq <= tiling.BLOCK_ROWS
    for q0 in starts:
        n_tiles = -(-(min(s, t, q0 + bq) if causal else s) // tile)
        rows = vis[:, q0:min(q0 + bq, t)]
        last_seen = int(np.nonzero(rows.any(axis=1))[0].max()) + 1
        assert (n_tiles - 1) * tile < last_seen <= n_tiles * tile, (rep, t, s, causal, q0)


OFFSETS = [(1024, 1024), (1024, 0), (0, 512), (1000, 37), (0, 77), (37, 1000), (128, 64)]


@pytest.mark.parametrize("q_offset,k_offset", OFFSETS)
def test_offset_tiles_cover_each_visible_pair_once(q_offset, k_offset):
    """With the global offsets (diag = q_offset - k_offset): B1/B3's blocks
    walk the key tiles up to the last key any of their rows sees (none: no
    tile), and B2's q tiles from `dkv_first_q_tile` on cover each pair its
    keys make with a position that sees them exactly once."""
    diag = q_offset - k_offset
    tile = tiling.BWD_TILE
    for t, s in BWD_SHAPES + [(1024, 2048), (300, 700)]:
        k, p = np.meshgrid(np.arange(s), np.arange(t), indexing="ij")
        vis = k <= p + diag
        for bq in (128, 64, 42, 1):
            for q0 in range(0, t, bq):
                rows = vis[:, q0:min(q0 + bq, t)]
                end = tiling.kv_end(q0, bq, t, s, True, diag)
                seen = np.nonzero(rows.any(axis=1))[0]
                assert end == (int(seen.max()) + 1 if seen.size else 0), (t, s, q0, bq)
        cover = np.zeros((s, t), dtype=int)
        n_qt = -(-t // tile)
        for k0 in range(0, s, tiling.DKV_KEYS):
            for j in range(tiling.dkv_first_q_tile(k0, t, True, diag), n_qt):
                cover[k0:min(k0 + tiling.DKV_KEYS, s), j * tile:min(j * tile + tile, t)] += 1
        assert (cover[vis] == 1).all() and cover.max() <= 1, (t, s)


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 8, 16, 64, 127, 128])
def test_bwd_tiles_cover_each_visible_pair_once(rep):
    for t, s in BWD_SHAPES:
        for causal in (True, False):
            _check_bwd_geometry(rep, t, s, causal)


@pytest.mark.parametrize("t", TS)
def test_lse_row_stride_starts_rows_on_16_bytes(t):
    ld = tiling.lse_row_stride(t)
    assert t <= ld < t + 4 and ld * 4 % 16 == 0


@HEAD_DIMS
def test_bwd_shared_memory_fits_one_block(d):
    dkv, dq = tiling.dkv_shared_bytes(d), tiling.dq_shared_bytes(d)
    assert max(dkv, dq) <= tiling.SMEM_LIMIT
    tile = tiling.BWD_TILE * d * 2
    # B2: K, V and the q_s / dO_s ring with each tile's lse and D; B3: Q and
    # the K / V ring
    dkv_floor = 4 * tile + tiling.DKV_STAGES * (2 * tile + 2 * tiling.BWD_TILE * 4)
    dq_floor = 2 * tile + tiling.DQ_STAGES * 2 * tile
    assert dkv_floor < dkv <= dkv_floor + 2048
    assert dq_floor < dq <= dq_floor + 2048
    assert tiling.DKV_STAGES >= 3 and tiling.DQ_STAGES >= 3


@pytest.mark.parametrize("bh_kv, rep, t, s, match", [
    (1, 129, 64, 64, "rep <= 128"),
    (1, 0, 64, 64, "rep <= 128"),
    (65536, 1, 64, 64, "b\\*h_kv"),
    (1, 1, 64, 128 * 65536, "key tiles"),
    (1, 128, 65536, 64, "row"),
    (1, 1, 0, 64, "key tiles"),
])
def test_bwd_geometry_refusals(bh_kv, rep, t, s, match):
    with pytest.raises(ValueError, match=match):
        tiling.bwd_grids(bh_kv, rep, t, s, 64)


def test_bwd_wrappers_check_the_geometry_first():
    """rep 129 is refused by the geometry before the wrapper asks for CUDA
    tensors, and rep 128 passes it (then wants CUDA)."""
    from quantizedattention_tpu_torch.ops.flash_bwd import _launch_args, bwd_operands

    for h, match in ((129, "rep <= 128"), (128, "CUDA")):
        q = torch.zeros((1, h, 4, 64))
        k = torch.ones((1, 1, 4, 64))
        ops = bwd_operands(q, k, k, q, torch.zeros((1, h, 4)), q, causal=True, fast=True)
        with pytest.raises(ValueError, match=match):
            _launch_args(ops)
