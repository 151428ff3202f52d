"""The int8 kernels' launch geometry against the JAX package's scale grain:
the forward (B5 and B6) and the backward (B7 and B8).

`ops.int8_tiling` holds what the wrappers pass to the kernels, bq query
positions a block, and what they check before a launch. The grain comes from
the JAX package's own rule, default_block_config("int8", ...).clamp_rep(rep).
Checked here for rep 1-16 on ragged, cross and one-token shapes: the port's
grain equals the JAX rule's, no 128-key tile straddles a kv grain or runs
past the padded payload, a block's rows hold the whole GQA group, and one
block's shared memory fits an H100. For the backward, at chip_smoke.py's
phase-8 shapes and the same grain table: B7's 128-key blocks and 64-row q
tiles each lie inside one grain, its q tiles cover the positions that see
the block's keys exactly once, B8's blocks cover [0, t) once per head and
walk the keys their rows see, and both grids stay within their limits.
"""

import pytest
import torch

from quantizedattention_tpu.tune.config import default_block_config
from quantizedattention_tpu_torch.ops import int8_fwd as tfwd
from quantizedattention_tpu_torch.ops import int8_tiling as tiling
from quantizedattention_tpu_torch.tune.config import int8_grain

torch.set_num_threads(2)

# (t, s): ragged lengths, cross lengths both ways, one token, a single
# 128-key tile, and the training and config 3 lengths
SHAPES = [(1000, 1000), (200, 330), (330, 200), (77, 201), (1, 1), (1, 300), (128, 128),
          (2048, 2048), (8192, 8192)]
REPS = list(range(1, 17))


def _jax_grain(t, s, rep):
    cfg = default_block_config("int8", t, s, 64).clamp_rep(rep)
    kv_pad = -(-s // cfg.block_kv) * cfg.block_kv
    return cfg.block_q, min(cfg.kv_compute, kv_pad), -(-t // cfg.block_q) * cfg.block_q, kv_pad


@pytest.mark.parametrize("rep", REPS)
def test_key_tiles_stay_inside_one_jax_grain(rep):
    for t, s in SHAPES:
        q_grain, kv_grain, q_pad, kv_pad = int8_grain(t, s, rep)
        assert (q_grain, kv_grain, q_pad, kv_pad) == _jax_grain(t, s, rep)
        tiling.check_grain(kv_grain, kv_pad)
        # the tiles [k0, k0 + 128) up to the last key each lie in one grain
        # and inside the padded payload
        for k0 in range(0, s, tiling.KV_TILE):
            k1 = k0 + tiling.KV_TILE
            assert k1 <= kv_pad and k0 // kv_grain == (k1 - 1) // kv_grain, (t, s, rep, k0)
        assert q_pad >= t and q_pad % q_grain == 0


def test_shared_memory_fits_one_block():
    n = tiling.shared_bytes()
    assert n <= tiling.SMEM_LIMIT
    # Q, the K/V ring and the bf16 V ring alone
    floor = (tiling.BLOCK_ROWS * 64 + tiling.KV_STAGES * 2 * tiling.KV_TILE * 64
             + tiling.V_STAGES * tiling.KV_TILE * 64 * 2)
    assert floor < n <= floor + 4096
    assert tiling.KV_STAGES >= 2 and tiling.V_STAGES >= 2 and tiling.BLOCK_ROWS == 2 * 64


@pytest.mark.parametrize("rep", [1, 2, 3, 5, 16, 64, 128])
def test_geometry_block_rows(rep):
    """rep * bq rows hold the whole GQA group for bq positions, and one more
    position would not fit: no q head is split across blocks."""
    bq = tiling.block_positions(2, rep)
    assert rep * bq <= tiling.BLOCK_ROWS < rep * (bq + 1)


def test_geometry_refusals():
    with pytest.raises(ValueError, match="rep <= 128"):
        tiling.block_positions(1, 129)
    with pytest.raises(ValueError, match="b\\*h_kv"):
        tiling.block_positions(65536, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        tiling.check_grain(64, 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tiling.check_grain(256, 384)
    # the wrappers check the geometry before they ask for CUDA tensors
    q = torch.zeros((1, 129, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rep <= 128"):
        tfwd._fused_launch_args(q, k, k, None)
    res = tfwd.quantize_qkv(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="rep <= 128"):
        tfwd._launch_args(res, (1, 129, 4, 4, 64))


# chip_smoke.py's phase-8 shapes (INT8_CASES with EDGE_CASES): (b, h, h_kv, t,
# s, causal)
BWD_CASES = [(4, 16, 16, 2048, 2048, True), (2, 16, 16, 1000, 1000, True),
             (2, 16, 4, 2048, 2048, True), (8, 4, 2, 512, 512, True),
             (8, 16, 16, 256, 256, True), (1, 4, 2, 77, 201, False), (2, 6, 2, 33, 130, True),
             (1, 3, 1, 1, 1, True), (1, 8, 8, 200, 330, True), (1, 6, 2, 300, 300, True),
             (1, 10, 2, 257, 257, True), (1, 5, 1, 330, 200, False), (2, 4, 4, 128, 128, False),
             (1, 3, 1, 170, 170, True)]


def _check_bwd_geometry(b, h, h_kv, t, s, causal):
    rep = h // h_kv
    q_grain, kv_grain, q_pad, kv_pad = int8_grain(t, s, rep)
    tiling.check_bwd_grains(q_grain, kv_grain, q_pad, kv_pad)
    bq, dkv_grid, dq_grid = tiling.bwd_grids(b * h_kv, rep, t, s, q_pad, kv_pad)
    assert dkv_grid[0] == dq_grid[0] == b * h_kv
    assert max(dkv_grid[1], dq_grid[1]) <= tiling.MAX_GRID_Y
    assert b * h * q_pad <= tiling.MAX_TMA_ROW and b * h_kv * kv_pad <= tiling.MAX_TMA_ROW
    tile = tiling.BWD_TILE
    n_qt = -(-t // tile)
    # B7: each 128-key block lies in one kv grain and the padding; its q tiles
    # (each in one q grain and the padding) cover the positions that see one
    # of its keys exactly once
    for kb in range(dkv_grid[1]):
        k0 = kb * tiling.DKV_KEYS
        k1 = k0 + tiling.DKV_KEYS
        assert k1 <= kv_pad and k0 // kv_grain == (k1 - 1) // kv_grain, (t, s, rep, k0)
        j0 = tiling.dkv_first_q_tile(k0, t, causal)
        for j in range(j0, n_qt):
            q0 = j * tile
            assert q0 + tile <= q_pad and q0 // q_grain == (q0 + tile - 1) // q_grain
        # the tiles from j0 on cover [64 j0, t) once; the positions that see
        # a key of the block are [k0, t) (causal: p >= its first key) or [0, t)
        first_seeing = min(k0, t) if causal else 0
        assert min(j0 * tile, t) == first_seeing, (t, s, rep, k0)
    # B8: blocks of bq positions cover [0, t) once; each walks the 64-key
    # tiles (each in one kv grain) up to the last key one of its rows sees
    starts = [(dq_grid[1] - 1 - y) * bq for y in range(dq_grid[1])]  # the kernel's order
    assert sorted(p for q0 in starts for p in range(q0, min(q0 + bq, t))) == list(range(t))
    assert rep * bq <= tiling.BLOCK_ROWS
    for q0 in starts:
        n_tiles = tiling.dq_key_tiles(q0, bq, t, s, causal)
        last_seen = max(min(s, p + 1) if causal else s for p in range(q0, min(q0 + bq, t)))
        assert (n_tiles - 1) * tile < last_seen <= n_tiles * tile <= kv_pad, (t, s, rep, q0)
        for j in range(n_tiles):
            assert (j * tile) // kv_grain == (j * tile + tile - 1) // kv_grain


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_bwd_tiles_cover_each_visible_pair_inside_one_grain(case):
    _check_bwd_geometry(*case)


@pytest.mark.parametrize("rep", REPS)
def test_bwd_geometry_on_the_jax_grain_table(rep):
    """The backward's geometry holds wherever the JAX rule sets the grain:
    every shape of SHAPES with rep q heads a kv head, causal and not."""
    for t, s in SHAPES:
        for causal in (True, False):
            _check_bwd_geometry(1, rep, 1, t, s, causal)


def test_bwd_shared_memory_fits_one_block():
    dkv, dq = tiling.dkv_shared_bytes(), tiling.dq_shared_bytes()
    assert max(dkv, dq) <= tiling.SMEM_LIMIT
    tile_i8 = tiling.BWD_TILE * 64
    # B7: K, the Q/dO ring and two widened Q tiles; B8: Q, the K/V ring and
    # the widened K and V tiles
    dkv_floor = 128 * 64 + tiling.DKV_STAGES * 3 * tile_i8 + 2 * 2 * tile_i8
    dq_floor = 128 * 64 + tiling.DQ_STAGES * 2 * tile_i8 + (tiling.DQ_WIDE_K + 2) * 2 * tile_i8
    assert dkv_floor < dkv <= dkv_floor + 32 * 1024 + 4096
    assert dq_floor < dq <= dq_floor + 4096
    assert tiling.DKV_STAGES >= 3 and tiling.DQ_STAGES >= 3


def test_bwd_geometry_refusals():
    with pytest.raises(ValueError, match="multiple of 64"):
        tiling.check_bwd_grains(96, 128, 96, 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tiling.check_bwd_grains(128, 64, 128, 128)
    with pytest.raises(ValueError, match="dividing"):
        tiling.check_bwd_grains(128, 256, 128, 384)
    with pytest.raises(ValueError, match="rep <= 128"):
        tiling.bwd_grids(1, 129, 128, 128, 128, 128)
    with pytest.raises(ValueError, match="at most 65535"):
        tiling.bwd_grids(1, 1, 128, 128 * 65536, 128, 128 * 65536)
    # the wrappers check the geometry before they ask for CUDA tensors
    from quantizedattention_tpu_torch.ops import int8_bwd as tbwd
    q = torch.zeros((1, 129, 4, 64))
    k = torch.ones((1, 1, 4, 64))
    dims = (1, 129, 4, 4, 64)
    res = tfwd.quantize_qkv(q, k, k)
    o, lse = tfwd.int8_attention_fwd_from_quantized(res, dims)
    ops = tbwd.int8_bwd_operands(res, k.mean(-2, keepdim=True), o, lse, q, dims)
    with pytest.raises(ValueError, match="rep <= 128"):
        tbwd._launch_args(ops)
