"""The launch geometry of the weight-only matmuls, B17 and B18
(`ops.linear_tiling`), which both wrappers pass to their kernels.

For every row count from one token to a 2048-token prefill, at the bench
LM's projection shapes (d_model 1024, MLP 4096, vocab 8192), a small test
width and the odd shape chip_smoke.py checks: the regime follows m, the
column tiles cover [0, n) once, the cluster's k split covers the
contraction (B17: k; B18: the packed rows, in 64-row chunks that never cut
a 64-row piece of a scale group) once and in order, the cluster fits the
portable size, the grid fits its y extent, a block's shared memory fits an
H100, and every bench shape that streams fills the card with at least 128
blocks.
"""

import pytest

from quantizedattention_tpu_torch.ops import linear_tiling as lt

MS = [1, 5, 8, 16, 40, 64, 65, 256, 2048]
BENCH = [(1024, 1024), (1024, 4096), (4096, 1024), (1024, 8192)]  # BENCH_CFG's (k, n)
SHAPES = BENCH + [(256, 64), (1000, 300)]  # a test width; chip_smoke.py's WEIGHT_ODD
GROUP = 128


def _check(plan, m, n, rows):
    assert plan.regime == ("stream" if m <= lt.STREAM_MAX_M else "tensor")
    covered = [c for c0, c1 in plan.col_tiles() for c in range(c0, c1)]
    assert covered == list(range(n))
    assert len(plan.col_tiles()) == (plan.grid[1] if plan.regime == "stream" else plan.grid[0])
    ranges = plan.chunk_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.chunks
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # in order, no gap or overlap
    assert all(c1 > c0 for c0, c1 in ranges)  # no block without work
    k_rows = [r for c0, c1 in ranges for r in range(c0 * lt.CHUNK, min(c1 * lt.CHUNK, rows))]
    assert k_rows == list(range(rows))
    assert 1 <= plan.split <= lt.MAX_CLUSTER
    assert plan.grid[1] <= lt.MAX_GRID_Y
    assert plan.shared_bytes <= lt.SMEM_LIMIT
    if plan.regime == "stream":
        assert plan.bn in lt.STREAM_BNS and plan.bm == -(-m // 8) * 8
        assert plan.grid[0] == plan.split  # the cluster spans the grid's x
    else:
        assert (plan.bm, plan.bn, plan.split) == (lt.TC_BM, lt.TC_BN, 1)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_int8_geometry(m, k, n):
    plan = lt.plan_int8(m, k, n)
    _check(plan, m, n, k)
    if plan.regime == "stream" and (k, n) in BENCH:
        assert plan.ctas >= lt.MIN_CTAS


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_int4_geometry(m, k, n):
    kp = -(-k // (2 * GROUP)) * (2 * GROUP)  # quantize_weight_int4's padded contraction
    half = kp // 2
    plan = lt.plan_int4(m, half, n, GROUP)
    _check(plan, m, n, half)
    assert half % lt.CHUNK == 0  # whole chunks, each inside one scale group
    assert all(c * lt.CHUNK // GROUP == ((c + 1) * lt.CHUNK - 1) // GROUP
               for c in range(plan.chunks))
    if plan.regime == "stream" and (k, n) in BENCH:
        assert plan.ctas >= lt.MIN_CTAS


def test_shared_bytes_grow_with_the_streamed_rows():
    """The streaming ring holds the x rows padded to 8; B18 stages two
    halves of x; the tensor-core block is the same for every m > 64."""
    assert lt.shared_bytes(1, 64, 1) == lt.shared_bytes(8, 64, 1) < lt.shared_bytes(9, 64, 1)
    assert lt.shared_bytes(40, 128, 2) > lt.shared_bytes(40, 128, 1)
    assert lt.shared_bytes(65, 128, 1) == lt.shared_bytes(2048, 128, 2)


def test_geometry_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="divides"):
        lt.plan_int4(8, 512, 64, 96)
    with pytest.raises(ValueError, match="divides"):
        lt.plan_int4(8, 384, 64, 256)
    with pytest.raises(ValueError, match="at least 1"):
        lt.plan_int8(0, 64, 64)
    with pytest.raises(ValueError, match="grid"):
        lt.plan_int8(8, 64, 128 * (lt.MAX_GRID_Y + 1))
    with pytest.raises(ValueError, match="grid"):
        lt.plan_int8(lt.TC_BM * lt.MAX_GRID_Y + 1, 64, 64)
