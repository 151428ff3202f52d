"""Launch geometry of the weight-only matmuls: B17 (csrc/int8_linear.cu) and
B18 (csrc/int4_linear.cu).

Pure Python, so the CPU tests can check it. Both kernels walk the
contraction in chunks of CHUNK rows: k rows of the int8 weight, or rows of
the packed int4 weight (each of which holds one row of both halves; the last
chunk is cut at the packed rows where a scale group that is not a multiple
of CHUNK leaves them ragged). The regime follows m:

- streaming (m <= STREAM_MAX_M: decode, spec verify): a block of
  `stream_threads` threads takes `bn` (64 or 128) columns and a contiguous
  range of the chunks; the chunks are split over `split` blocks of one
  thread-block cluster (at most MAX_CLUSTER, the portable size), which sum
  their partials in rank order. `bn` and `split` are picked so that every
  serving shape launches at least MIN_CTAS blocks (the H100 has 132 SMs).
  The grid is (split, column tiles).
- tensor cores (m > STREAM_MAX_M: prefill): blocks of TC_BM x TC_BN outputs,
  one block over all of the contraction. The grid is (column tiles, row
  tiles).

The wrappers pass `bn` and `split` to the kernel; `shared_bytes` mirrors the
kernels' own count, which chip_smoke.py holds against it on the card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

CHUNK = 64  # contraction rows a stage
STREAM_MAX_M = 64
STREAM_STAGES = 4
STREAM_THREADS_B18 = 128  # B17 takes 2 bn (stream_threads)
STREAM_BNS = (128, 64)  # tried in this order
MAX_CLUSTER = 8
MIN_CTAS = 128
TC_BM = TC_BN = 128
TC_STAGES = 4  # x + 8-bit weight tiles in flight
SMEM_LIMIT = 232_448  # shared bytes an H100 block may use (227 KB)
MAX_GRID_Y = 65535


@dataclass(frozen=True)
class Plan:
    regime: str  # "stream" or "tensor"
    m: int
    n: int
    chunks: int  # CHUNK-row chunks of the contraction
    bm: int  # rows a block (x rows padded to 8 when streaming)
    bn: int  # columns a block
    split: int  # blocks of a cluster sharing the chunks
    shared_bytes: int

    @property
    def grid(self) -> tuple[int, int]:
        tiles = -(-self.n // self.bn)
        if self.regime == "stream":
            return self.split, tiles
        return tiles, -(-self.m // self.bm)

    @property
    def ctas(self) -> int:
        gx, gy = self.grid
        return gx * gy

    def col_tiles(self) -> list[tuple[int, int]]:
        """[c0, c1) of each block column, clipped to n."""
        return [(c, min(c + self.bn, self.n)) for c in range(0, self.n, self.bn)]

    def chunk_ranges(self) -> list[tuple[int, int]]:
        """[c0, c1) of the chunks of each cluster rank, as the kernels split them."""
        return [(r * self.chunks // self.split, (r + 1) * self.chunks // self.split)
                for r in range(self.split)]


def stream_threads(bn: int, x_halves: int) -> int:
    """Threads of a streaming block: B17 gives a warp 16 columns, B18 (two
    x halves, sub-dots beside the accumulators) 32."""
    return 2 * bn if x_halves == 1 else STREAM_THREADS_B18


def shared_bytes(m: int, bn: int, x_halves: int) -> int:
    """Dynamic shared memory of one block. Streaming: STREAM_STAGES stages of
    the x box [8 nt, CHUNK] bf16 (`x_halves` of them: 2 for B18's two
    halves) and the [CHUNK, bn] byte box; the receive buffer of the cluster
    sum (the [8 nt, bn] f32 partial plus MAX_CLUSTER floats a thread of
    slack); 128 bytes of mbarriers; 1024 bytes to align the swizzled boxes.
    Tensor cores: TC_STAGES stages of a [TC_BM, CHUNK] bf16 x tile and a
    [CHUNK, TC_BN] byte tile (the weights are widened in registers), the
    mbarriers and the alignment slack."""
    if m <= STREAM_MAX_M:
        mp = -(-m // 8) * 8
        stage = x_halves * mp * CHUNK * 2 + CHUNK * bn
        recv = 4 * (mp * bn + MAX_CLUSTER * stream_threads(bn, x_halves))
        return STREAM_STAGES * stage + recv + 128 + 1024
    stage = TC_BM * CHUNK * 2 + CHUNK * TC_BN
    return TC_STAGES * stage + 128 + 1024


def _plan(m: int, rows: int, n: int, x_halves: int) -> Plan:
    if m < 1 or n < 1 or rows < 1:
        raise ValueError(f"kernel takes m, n and a contraction of at least 1; got m={m}, n={n}, "
                         f"rows={rows}")
    chunks = -(-rows // CHUNK)
    if m > STREAM_MAX_M:
        plan = Plan("tensor", m, n, chunks, TC_BM, TC_BN, 1, shared_bytes(m, TC_BN, x_halves))
    else:
        for bn in STREAM_BNS:
            tiles = -(-n // bn)
            split = 1
            while split * 2 <= min(MAX_CLUSTER, chunks) and tiles * split < MIN_CTAS:
                split *= 2
            if tiles * split >= MIN_CTAS:
                break
        plan = Plan("stream", m, n, chunks, -(-m // 8) * 8, bn, split,
                    shared_bytes(m, bn, x_halves))
    if plan.grid[1] > MAX_GRID_Y:
        raise ValueError(f"kernel takes at most {MAX_GRID_Y} blocks along the grid's y; "
                         f"m={m}, n={n} need {plan.grid[1]}")
    return plan


@functools.lru_cache(maxsize=1024)  # decode asks again for the same few shapes
def plan_int8(m: int, k: int, n: int) -> Plan:
    """B17's launch for x [m, k] @ w [k, n]."""
    return _plan(m, k, n, 1)


@functools.lru_cache(maxsize=1024)
def plan_int4(m: int, half: int, n: int, group: int) -> Plan:
    """B18's launch for x [m, 2 half] and packed [half, n] with `group`-row
    scale groups (any positive divisor of half; the geometry does not depend
    on it)."""
    if group <= 0 or half % group:
        raise ValueError(f"kernel takes a group that divides the packed rows; got group "
                         f"{group}, {half} packed rows")
    return _plan(m, half, n, 2)
