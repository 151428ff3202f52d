"""The int8 kernels' launch geometry against the JAX package's scale grain:
the forward (B5 and B6), the backward (B7 and B8) and the Q/K/V quantizer
(B4).

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
B4: the blocks of a grain's cluster tile it once, for grains 16-1024, and
one launch's clusters cover every padded token of up to three jobs with
different grains once; launches and grains past the kernel's limits raise. Its
plain version on the model's strided views gives the bytes it gives on
contiguous inputs and the jitted JAX quantizer's, and `_qkv_jobs` hands the
kernel the caller's tensors, not copies.
"""

import numpy as np
import pytest
import torch

from quantizedattention_tpu.ops.int8_fwd import quantize_qkv as jax_quantize_qkv
from quantizedattention_tpu.tune.config import default_block_config
from quantizedattention_tpu_torch.ops import int8_fwd as tfwd
from quantizedattention_tpu_torch.ops import int8_tiling as tiling
from quantizedattention_tpu_torch.quantize import int8 as tq
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
        # at either head dim, the tiles [k0, k0 + kv_tile) up to the last key
        # each lie in one grain and inside the padded payload
        for d in tiling.HEAD_DIMS:
            tile = tiling.kv_tile(d)
            for k0 in range(0, s, tile):
                k1 = k0 + tile
                assert k1 <= kv_pad and k0 // kv_grain == (k1 - 1) // kv_grain, (t, s, rep, k0, d)
        assert q_pad >= t and q_pad % q_grain == 0


def _fwd_floor(d):
    """Q, the K/V ring and the bf16 V ring alone."""
    tile = tiling.kv_tile(d)
    return (tiling.BLOCK_ROWS * d + tiling.KV_STAGES * 2 * tile * d
            + tiling.V_STAGES * tile * d * 2)


def test_shared_memory_fits_one_block():
    n = tiling.shared_bytes(64)
    assert n <= tiling.SMEM_LIMIT
    floor = _fwd_floor(64)
    assert floor < n <= floor + 4096
    assert tiling.KV_STAGES >= 2 and tiling.V_STAGES >= 2 and tiling.BLOCK_ROWS == 2 * 64


def test_shared_memory_fits_one_block_at_128():
    """At head dim 128 the forward walks 64-key tiles: its Q tile, K/V ring
    and bf16 V ring (int8 rows of 128 bytes, bf16 rows two panels of 128)
    fit one block, and so would a second block's."""
    assert tiling.kv_tile(128) == 64 and tiling.kv_tile(64) == 128
    n = tiling.shared_bytes(128)
    floor = _fwd_floor(128)
    assert floor < n <= floor + 4096
    assert floor == 128 * 128 + 3 * 2 * 64 * 128 + 2 * 64 * 128 * 2
    assert 2 * (n + 1024) <= 228 * 1024


@pytest.mark.parametrize("d", [0, 32, 80, 96, 256])
def test_geometry_refuses_other_head_dims(d):
    for fn in (tiling.kv_tile, tiling.shared_bytes, tiling.dkv_stages, tiling.dkv_shared_bytes,
               tiling.dq_shared_bytes, tiling.quant_shared_bytes):
        with pytest.raises(ValueError, match="head_dim"):
            fn(d)


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


def _bwd_floors(d):
    """B7: K (and at 128 the widened V), the Q/dO ring and two widened Q
    tiles; B8: Q, the K/V ring and the widened K and V tiles."""
    tile_i8 = tiling.BWD_TILE * d
    vw = 0 if d == 64 else 128 * d * 2
    dkv = 128 * d + vw + tiling.dkv_stages(d) * 3 * tile_i8 + 2 * 2 * tile_i8
    dq = 128 * d + tiling.DQ_STAGES * 2 * tile_i8 + (tiling.DQ_WIDE_K + 2) * 2 * tile_i8
    return dkv, dq


def test_bwd_shared_memory_fits_one_block():
    dkv, dq = tiling.dkv_shared_bytes(64), tiling.dq_shared_bytes(64)
    assert max(dkv, dq) <= tiling.SMEM_LIMIT
    dkv_floor, dq_floor = _bwd_floors(64)
    assert dkv_floor < dkv <= dkv_floor + 32 * 1024 + 4096
    assert dq_floor < dq <= dq_floor + 4096
    assert tiling.dkv_stages(64) >= 3 and tiling.DQ_STAGES >= 3


def test_bwd_shared_memory_fits_one_block_at_128():
    """At head dim 128, B7 keeps the widened V (the A of dP^T) and dK's f32
    sums (64 a thread) in shared memory beside a 3-stage ring, and B8 sums
    dQ there (64 a thread): both under an H100 block's 227 KB, where B7's
    ring of 4 stages would not be."""
    dkv, dq = tiling.dkv_shared_bytes(128), tiling.dq_shared_bytes(128)
    assert max(dkv, dq) <= tiling.SMEM_LIMIT
    dkv_floor, dq_floor = _bwd_floors(128)
    sums = 64 * 256 * 4
    assert dkv_floor + sums < dkv <= dkv_floor + sums + 4096
    assert dq_floor + sums < dq <= dq_floor + sums + 4096
    assert tiling.dkv_stages(128) == 3
    assert dkv + 3 * tiling.BWD_TILE * 128 > tiling.SMEM_LIMIT  # a fourth stage passes the SM


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


# --------------------------------------------------------------------------
# B4, the Q/K/V quantizer: a cluster of blocks a grain, rows through strides
# --------------------------------------------------------------------------

QUANT_GRAINS = [16, 48, 128, 256, 384, 512, 640, 768, 896, 1024]


@pytest.mark.parametrize("grain", QUANT_GRAINS)
def test_quant_shares_cover_each_grain_once(grain):
    """The blocks of a grain's cluster take disjoint shares that tile it."""
    seen = [tok for rank in range(tiling.QUANT_CLUSTER)
            for tok in tiling.quant_share_tokens(grain, rank)]
    assert sorted(seen) == list(range(grain))
    # a share fits the kernel's registers: at most 128 tokens
    assert len(tiling.quant_share_tokens(grain, 0)) <= tiling.QUANT_MAX_GRAIN // tiling.QUANT_CLUSTER


def _quant_walk(jobs):
    """(job, row, token) of every block of one launch as the kernel maps it:
    cluster c of the launch is job j's item c - starts[j], row (c -
    starts[j]) // n_grains, grain (c - starts[j]) % n_grains; block `rank`
    of it takes its share of the grain."""
    starts = tiling.quant_items(jobs)
    seen = []
    for block in range(starts[-1] * tiling.QUANT_CLUSTER):
        c, rank = divmod(block, tiling.QUANT_CLUSTER)
        j = max(i for i in range(len(jobs)) if starts[i] <= c)
        rows, pad, grain = jobs[j]
        row, g = divmod(c - starts[j], pad // grain)
        seen += [(j, row, g * grain + tok) for tok in tiling.quant_share_tokens(grain, rank)]
    return seen


@pytest.mark.parametrize("jobs", [
    [(4, 1024, 1024)],                                        # the training grain, two halves
    [(3, 384, 128), (2, 1024, 512), (2, 1024, 1024)],         # three jobs, three grains
    [(6, 256, 256), (2, 1152, 384), (2, 1152, 384)],          # Q, K, V of rep 3 at a ragged t
], ids=["one", "three_grains", "rep3"])
def test_quant_blocks_cover_every_padded_token_once(jobs):
    """One launch over up to three jobs covers each job's [rows, pad) tokens,
    the padded tail included, exactly once."""
    seen = _quant_walk(jobs)
    want = [(j, row, tok) for j, (rows, pad, _) in enumerate(jobs) for row in range(rows)
            for tok in range(pad)]
    assert len(seen) == len(want) and sorted(seen) == want


@pytest.mark.parametrize("t,s,rep", [(2048, 2048, 1), (1000, 1000, 1), (1100, 1100, 4),
                                     (77, 201, 2), (8192, 8192, 1), (300, 300, 3)])
def test_quant_geometry_takes_the_jax_grain(t, s, rep):
    """quantize_qkv's jobs at the JAX grain are all launchable."""
    q_grain, kv_grain, q_pad, kv_pad = int8_grain(t, s, rep)
    starts = tiling.quant_items([(4 * rep, q_pad, q_grain), (4, kv_pad, kv_grain),
                                 (4, kv_pad, kv_grain)])
    assert starts[-1] == 4 * rep * q_pad // q_grain + 8 * kv_pad // kv_grain


def test_quant_shared_bytes_fit():
    """A block's largest share in f32 (128 tokens x 64), six blocks an SM
    (each with its static bytes and the 1 KB the card reserves a block)."""
    assert tiling.quant_shared_bytes(64) == 128 * 64 * 4 <= 48 * 1024
    static = 4 * (tiling.QUANT_THREADS // 32 + 1)
    assert 6 * (tiling.quant_shared_bytes(64) + static + 1024) <= 228 * 1024


def test_quant_shared_bytes_fit_at_128():
    """At head dim 128 a block's largest share is 128 tokens x 128 in f32,
    64 KB (over the 48 KB a launch gets without raising its limit, which
    the kernel raises): three blocks an SM."""
    n = tiling.quant_shared_bytes(128)
    assert n == 128 * 128 * 4 == 2 * tiling.quant_shared_bytes(64) > 48 * 1024
    static = 4 * (tiling.QUANT_THREADS // 32 + 1)
    assert 3 * (n + static + 1024) <= 228 * 1024 < 4 * (n + static + 1024)


def test_quant_grid_limits_raise():
    for grain in (0, 8, 24, 2048):
        with pytest.raises(ValueError, match="multiples of 16"):
            tiling.quant_check_grain(grain)
    with pytest.raises(ValueError, match="1 to 3 jobs"):
        tiling.quant_items([(1, 128, 128)] * 4)
    with pytest.raises(ValueError, match="multiple of grain"):
        tiling.quant_items([(1, 200, 128)])
    with pytest.raises(ValueError, match="items a launch"):
        tiling.quant_items([(2**21, 2**14, 16)])


def _strided_qkv(b, h, h_kv, t, s, seed=0, shift=0.0):
    """q [b, h, t, 64], k/v [b, h_kv, s, 64]: views of [b, t, h, 64] storage,
    as the model hands them in, and contiguous copies of the same values."""
    rng = np.random.default_rng(seed)
    views = [torch.from_numpy(rng.standard_normal((b, n, heads, 64), np.float32)).transpose(1, 2)
             for n, heads in ((t, h), (s, h_kv), (s, h_kv))]
    views[1] = (views[1] + np.float32(shift)).transpose(1, 2).contiguous().transpose(1, 2)
    return views, [x.contiguous() for x in views]


@pytest.mark.parametrize("b,h,h_kv,t,s,shift", [(2, 4, 4, 300, 300, 0.0), (1, 4, 2, 77, 201, 4.0),
                                                (1, 2, 2, 1100, 1100, 0.0)])
def test_plain_quantizer_on_strided_views_is_byte_equal(b, h, h_kv, t, s, shift):
    """B4's plain version on [b, h, t, 64] views of [b, t, h, 64] tensors
    gives the bytes it gives on contiguous ones, and the jitted JAX
    quantizer's."""
    views, dense = _strided_qkv(b, h, h_kv, t, s, shift=shift)
    assert not views[0].is_contiguous()
    k_mean = dense[1].mean(-2, keepdim=True)
    got = tfwd.quantize_qkv_plain(*views, k_sub=k_mean)
    want = tfwd.quantize_qkv_plain(*dense, k_sub=k_mean)
    cfg = default_block_config("int8", t, s, 64)
    jax_res = jax_quantize_qkv(*(np.asarray(x) for x in dense), cfg, k_sub=k_mean.numpy())
    for (x, sc), (x_w, sc_w), (x_j, sc_j) in zip(got, want, jax_res):
        assert torch.equal(x, x_w) and torch.equal(sc, sc_w)
        assert np.array_equal(x.numpy(), np.asarray(x_j))
        assert np.array_equal(sc.numpy(), np.asarray(sc_j))


def test_qkv_jobs_hand_over_the_callers_storage():
    """On the kernel route B4 reads the caller's tensors: `_qkv_jobs` copies
    none of Q, K or V (f32 for `quantize_qkv`, the inputs' own type for
    B6), and the launch check takes the views as they are."""
    views, _ = _strided_qkv(2, 4, 2, 300, 300)
    k_mean = views[1].mean(-2, keepdim=True)
    for cast, to_f32 in ((lambda x: x, True), (lambda x: x.to(torch.bfloat16), False)):
        xs = [cast(x) for x in views]
        jobs = tfwd._qkv_jobs(*xs, k_mean, to_f32=to_f32)
        for job, x in zip(jobs, xs):
            assert job.x.data_ptr() == x.data_ptr() and job.x.stride() == x.stride()
        # the layout is what the kernel takes: the check stops only at the device
        with pytest.raises(ValueError, match="CUDA"):
            tq._launch_args(jobs, tuple(tq.IN_TYPES))
    # a view whose token rows are not contiguous is refused, not copied
    jobs = tfwd._qkv_jobs(views[0].transpose(2, 3).contiguous().transpose(2, 3), *views[1:], None)
    with pytest.raises(ValueError, match="unit last stride"):
        tq._launch_args(jobs)
