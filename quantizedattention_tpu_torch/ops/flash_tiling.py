"""Launch geometry of the corrected-bf16 flash forward (csrc/flash_fwd.cu, B1
bf16 mode).

Pure Python, so the CPU tests can hold it. A block has BLOCK_ROWS query
rows, two warpgroups of 64, which hold one kv head's whole GQA group: bq =
BLOCK_ROWS // rep query positions a block, row r -> q head kv_head * rep +
r // bq at position q0 + r % bq (rows from rep * bq on are dead). The grid is
(b * h_kv, cdiv(t, bq)); grid row y holds the q tile whose first position is
(cdiv(t, bq) - 1 - y) * bq, so the blocks with the most key tiles start
first. Keys are walked in tiles of KV_TILE through a ring of KV_STAGES TMA
stages (K and V of one tile a stage). The constants mirror the kernel's,
and `shared_bytes` is held against the kernel's own count on the card.
"""

from __future__ import annotations

HEAD_DIM = 64
BLOCK_ROWS = 128  # two warpgroups of 64
KV_TILE = 128  # keys a tile
KV_STAGES = 3  # K/V tiles in flight (each 2 x 16 KB of bf16)
O_LD = HEAD_DIM + 8  # floats of a staged O row (padded: conflict-free stores)
SMEM_LIMIT = 232_448  # shared bytes an H100 block may use (227 KB)
MAX_KV_BLOCKS = 65535  # b * h_kv, as the other attention kernels take it
MAX_Q_TILES = 65535  # the grid's y extent


def shared_bytes() -> int:
    """Dynamic shared memory of one block: the bf16 Q tile, the K/V ring, the
    f32 O staging tile, 128 bytes of mbarriers, 1024 bytes of bf16 ones (the
    B operand of P's row sums) and 1024 bytes to align the swizzled tiles."""
    q = BLOCK_ROWS * HEAD_DIM * 2
    kv = KV_STAGES * 2 * KV_TILE * HEAD_DIM * 2
    o = BLOCK_ROWS * O_LD * 4
    return q + kv + o + 128 + 1024 + 1024


def block_positions(bh_kv: int, rep: int) -> int:
    """bq, the query positions a block, for a launch on bh_kv kv heads with
    GQA rep; raises where the kernel takes no block."""
    if not 1 <= rep <= BLOCK_ROWS:
        raise ValueError(f"kernel takes rep <= {BLOCK_ROWS} (the GQA group fills one block's "
                         f"rows); got rep={rep}")
    if not 1 <= bh_kv <= MAX_KV_BLOCKS:
        raise ValueError(f"kernel takes b*h_kv <= {MAX_KV_BLOCKS}; got {bh_kv}")
    return BLOCK_ROWS // rep


def grid(bh_kv: int, rep: int, t: int) -> tuple[int, tuple[int, int]]:
    """(bq, the grid (b * h_kv, q tiles)); raises where the kernel takes no
    launch."""
    bq = block_positions(bh_kv, rep)
    n_qt = -(-t // bq)
    if not 1 <= n_qt <= MAX_Q_TILES:
        raise ValueError(f"kernel takes 1 to {MAX_Q_TILES} q tiles of {bq}; got t={t}")
    return bq, (bh_kv, n_qt)

