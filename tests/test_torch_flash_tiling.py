"""The bf16 flash forward's launch geometry (B1, csrc/flash_fwd.cu) and its Q
rounding rule.

`ops.flash_tiling` holds what the wrapper passes to the kernel (bq query
positions a block, the grid) and the kernel's shared bytes. Checked here for
every GQA rep from 1 to 128 at t in {1, 63, 64, 127, 128, 129, 256, 1000,
2048}: a block's rows hold the whole group for bq positions, and the grid's
rows, mapped as the kernel maps them, cover every (q head, position < t)
exactly once; one block's shared memory fits an H100, and the grid's limits
raise. The Q rounding rule the kernel applies to each element, bf16(f32(q) *
f32(qk_scale)) rounded to nearest even, gives the bytes of the JAX package's
q.astype(f32) * qk_scale -> bf16 on f32 and on bf16 inputs.
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
    bq, (_, n_qt) = tiling.grid(1, rep, t)
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
        bq, (x, n_qt) = tiling.grid(3, rep, t)
        assert x == 3 and bq == tiling.BLOCK_ROWS // rep
        assert (n_qt - 1) * bq < t <= n_qt * bq, (rep, t)


def test_shared_memory_fits_one_block():
    n = tiling.shared_bytes()
    assert n <= tiling.SMEM_LIMIT
    # Q, the K/V ring and the f32 O staging tile alone
    floor = (tiling.BLOCK_ROWS * 64 * 2 + tiling.KV_STAGES * 2 * tiling.KV_TILE * 64 * 2
             + tiling.BLOCK_ROWS * tiling.O_LD * 4)
    assert floor < n <= floor + 4096
    assert tiling.KV_STAGES >= 3 and tiling.BLOCK_ROWS == 2 * 64


@pytest.mark.parametrize("bh_kv, rep, t, match", [
    (1, 129, 64, "rep <= 128"),
    (1, 0, 64, "rep <= 128"),
    (65536, 1, 64, "b\\*h_kv"),
    (0, 1, 64, "b\\*h_kv"),
    (1, 128, 65536, "q tiles"),
])
def test_geometry_refusals(bh_kv, rep, t, match):
    with pytest.raises(ValueError, match=match):
        tiling.grid(bh_kv, rep, t)


def test_largest_launch_accepted():
    assert tiling.grid(65535, 128, 65535) == (1, (65535, 65535))


def _bf16_rne(x32: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, rounded to nearest even (the kernel's
    __float2bfloat16_rn on finite values)."""
    u = x32.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


@pytest.mark.parametrize("sm_scale", [None, 0.3, 0.125, 1.0, 2.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_rounding_rule_matches_jax(dtype, sm_scale):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 333)) * np.exp2(rng.integers(-20, 20, (4, 333)))).astype(np.float32)
    x[0, :6] = [0.0, -0.0, 1.0, -3.5, 65504.0, 1e-20]
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    qk_scale = qk_scales(64, sm_scale)[1]
    assert qk_scale == jax_qk_scales(64, sm_scale)[1]
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
