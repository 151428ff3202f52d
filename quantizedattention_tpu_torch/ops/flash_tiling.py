"""Launch geometry of the corrected-bf16 flash forward (csrc/flash_fwd.cu, B1
bf16 mode), of its fp32 mode (3xTF32) and of its backward's fast mode
(csrc/flash_bwd.cu, B2 and B3).

Pure Python, so the CPU tests can hold it. A block has BLOCK_ROWS query
rows, two warpgroups of 64, which hold one kv head's whole GQA group: bq =
BLOCK_ROWS // rep query positions a block, row r -> q head kv_head * rep +
r // bq at position q0 + r % bq (rows from rep * bq on are dead). The grid is
(b * h_kv, cdiv(t, bq)); grid row y holds the q tile whose first position is
(cdiv(t, bq) - 1 - y) * bq, so the blocks with the most key tiles start
first. Keys are walked in tiles of `kv_tile` through a ring of KV_STAGES TMA
stages (K and V of one tile a stage). The constants mirror the kernel's,
and `shared_bytes` is held against the kernel's own count on the card.

The fp32 mode (the third section) takes FP32_ROWS positions of one q head a
block, two warpgroups of 64, and walks tiles of `fp32_keys(d)` keys (64 at
head dim 64, 32 at 128) of K big and small and V^T big and small through a
ring of `fp32_stages(d)` TMA stages (64 KB each at either head dim); its
K/V prep writes V^T with FP32_KV_COLS-aligned rows and the keys of each
group of 8 in the order TF32_A_COLUMNS.

The backward (the second section) streams 64-row tiles through rings of TMA
stages in both kernels. B2 takes 128 keys a block (two warpgroups of 64) and
walks, for each q head of the GQA group, the 64-row q tiles that see its
keys; B3 takes BLOCK_ROWS rows a block, as the forward does (bq positions of
every q head of the group), and walks the 64-key tiles its rows see. The
kernels compute those walks themselves. Their shared bytes are held against
the kernels' own counts on the card as well.

B1 bf16 and the backward's fast mode take head dim 64 or 128 (HEAD_DIMS):
a bf16 row of 128 dims is two 64-column panels, each its own 128-byte
swizzled tile. At 128 the forward walks keys in tiles of 64 (`kv_tile`),
and every tile's bytes double; the rows, q tiles and walks are the same.
So does the fp32 mode (FP32_HEAD_DIMS), and so do the backward's exact
kernels (FFMA on 32-row tiles of padded f32 rows, `bwd_exact_shared_bytes`).
"""

from __future__ import annotations

from quantizedattention_tpu_torch.ops.common import KERNEL_HEAD_DIMS, check_head_dim

HEAD_DIMS = KERNEL_HEAD_DIMS["B1 bf16"]  # and fast B2/B3's
BLOCK_ROWS = 128  # two warpgroups of 64
KV_STAGES = 3  # K/V tiles in flight (each 2 x 16 KB of bf16)
SMEM_LIMIT = 232_448  # shared bytes an H100 block may use (227 KB)
MAX_KV_BLOCKS = 65535  # b * h_kv, as the other attention kernels take it
MAX_Q_TILES = 65535  # the grid's y extent


def kv_tile(head_dim: int) -> int:
    """Keys a K/V tile of the forward: 128 at head dim 64, 64 at 128 (S and
    P's two register sets then take 64 registers a thread, beside O's 64)."""
    check_head_dim("B1 bf16", head_dim)
    return 128 if head_dim == 64 else 64


def o_ld(head_dim: int) -> int:
    """Floats of a staged O row (padded: conflict-free stores)."""
    check_head_dim("B1 bf16", head_dim)
    return head_dim + 8


def shared_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block: the bf16 Q tile, the K/V ring, the
    f32 O staging tile, 128 bytes of mbarriers, 1024 bytes of bf16 ones (the
    B operand of P's row sums) and 1024 bytes to align the swizzled tiles."""
    q = BLOCK_ROWS * head_dim * 2
    kv = KV_STAGES * 2 * kv_tile(head_dim) * head_dim * 2
    o = BLOCK_ROWS * o_ld(head_dim) * 4
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


def grid(bh_kv: int, rep: int, t: int, head_dim: int) -> tuple[int, tuple[int, int]]:
    """(bq, the grid (b * h_kv, q tiles)); raises where the kernel takes no
    launch (a head dim outside HEAD_DIMS included)."""
    check_head_dim("B1 bf16", head_dim)
    bq = block_positions(bh_kv, rep)
    n_qt = -(-t // bq)
    if not 1 <= n_qt <= MAX_Q_TILES:
        raise ValueError(f"kernel takes 1 to {MAX_Q_TILES} q tiles of {bq}; got t={t}")
    return bq, (bh_kv, n_qt)



def kv_end(q0: int, bq: int, t: int, s: int, causal: bool, diag: int = 0) -> int:
    """The keys a causal block of positions q0 .. q0 + bq - 1 walks (B1 and
    B3: `kv_hi`): up to the last one its last position below t sees, with
    the global offsets as diag = q_offset - k_offset; 0 where no row sees a
    key (no key tile)."""
    return max(0, min(s, min(t, q0 + bq) + diag)) if causal else s


# --------------------------------------------------------------------------
# The backward's fast mode, B2 (dK, dV) and B3 (dQ)
# --------------------------------------------------------------------------

BWD_TILE = 64  # q positions a B2 tile, keys a B3 tile
DKV_KEYS = 128  # keys a B2 block: two warpgroups of 64
DKV_STAGES = 4  # q_s / dO_s tiles (with their lse and D) in flight (B2)
DQ_STAGES = 4  # K / V tiles in flight (B3)
def _bf_tile(head_dim: int) -> int:
    """Bytes of a bf16 tile of BWD_TILE rows."""
    check_head_dim("B2/B3 fast", head_dim)
    return BWD_TILE * head_dim * 2


def dkv_shared_bytes(head_dim: int) -> int:
    """B2's dynamic shared memory: K and V [128, head_dim] bf16, the ring of
    q_s and dO_s tiles with each tile's lse and D (64 floats each), 128 bytes
    of mbarriers and release counters and 1024 bytes to align the swizzled
    tiles."""
    tile = _bf_tile(head_dim)
    return 4 * tile + DKV_STAGES * (2 * tile + 2 * BWD_TILE * 4) + 128 + 1024


def dq_shared_bytes(head_dim: int) -> int:
    """B3's dynamic shared memory: Q [128, head_dim] bf16, the ring of K and
    V tiles, 128 bytes of mbarriers and counters and 1024 bytes of
    alignment."""
    tile = _bf_tile(head_dim)
    return 2 * tile + DQ_STAGES * 2 * tile + 128 + 1024


def lse_row_stride(t: int) -> int:
    """The row stride (floats) of the fast mode's lse and D, [b * h, ld]: t
    rounded up to 4, so that a row starts on 16 bytes (TMA)."""
    return -(-t // 4) * 4


def dkv_first_q_tile(k0: int, t: int, causal: bool, diag: int = 0) -> int:
    """B2's first 64-row q tile for the key block starting at k0 (`j0`): the
    first that holds a position seeing key k0 (position + diag >= k0); the
    tile count where none does (the block writes dK = dV = 0)."""
    n_qt = -(-t // BWD_TILE)
    return min(max(0, k0 - diag) // BWD_TILE, n_qt) if causal else 0


def bwd_grids(bh_kv: int, rep: int, t: int, s: int,
              head_dim: int) -> tuple[int, tuple[int, int], tuple[int, int]]:
    """(bq, B2's grid, B3's grid), each grid (x, y) = (b * h_kv, key tiles of
    128 or row blocks of bq positions); raises where a kernel takes no launch
    (a head dim outside HEAD_DIMS included)."""
    check_head_dim("B2/B3 fast", head_dim)
    bq = block_positions(bh_kv, rep)
    dkv = (bh_kv, -(-s // DKV_KEYS))
    dq = (bh_kv, -(-t // bq))
    if min(t, s) < 1 or max(dkv[1], dq[1]) > MAX_Q_TILES:
        raise ValueError(f"kernels take 1 to {MAX_Q_TILES} key tiles of {DKV_KEYS} and row "
                         f"blocks of {bq}; got t={t}, s={s}")
    return bq, dkv, dq


EXACT_TILE = 32  # keys a B2 exact block, rows a B3 exact block, and their streamed tiles


def bwd_exact_shared_bytes(kernel: str, head_dim: int) -> int:
    """Shared memory of an exact block ("dkv" B2: K, V, Q, dO tiles of
    EXACT_TILE rows of d + 1 floats, P^T and dS^T [32, 33], lse and D; "dq"
    B3: Q, dO, K, V tiles and dS): static arrays at head dim 64, dynamic
    shared memory at 128."""
    check_head_dim("B2/B3 exact", head_dim)
    tile, ptile = EXACT_TILE * (head_dim + 1), EXACT_TILE * (EXACT_TILE + 1)
    floats = {"dkv": 4 * tile + 2 * ptile + 2 * EXACT_TILE, "dq": 4 * tile + ptile}[kernel]
    return 4 * floats


# --------------------------------------------------------------------------
# The forward's fp32 mode (3xTF32)
# --------------------------------------------------------------------------

FP32_HEAD_DIMS = KERNEL_HEAD_DIMS["B1 fp32"]
FP32_ROWS = 128  # q positions a block, one q head: two warpgroups of 64
FP32_KV_COLS = 8  # V^T rows are padded to a multiple of this many keys
# Column j of each group of 8 keys of V^T holds key TF32_A_COLUMNS[j]: a
# TF32 A fragment built from an accumulator holds its columns 2c and 2c + 1
# as fragment columns c and c + 4 (hopper.cuh's tf32_a_column).
TF32_A_COLUMNS = (0, 2, 4, 6, 1, 3, 5, 7)


def fp32_keys(head_dim: int) -> int:
    """Keys a tile of the fp32 mode: 64 at head dim 64; 32 at 128, where Q
    big's fragments and O take 64 registers a thread each."""
    check_head_dim("B1 fp32", head_dim)
    return 64 if head_dim == 64 else 32


def fp32_stages(head_dim: int) -> int:
    """Tiles in flight: 3 at head dim 64, 2 at 128 (Q small is 64 KB)."""
    check_head_dim("B1 fp32", head_dim)
    return 3 if head_dim == 64 else 2


def fp32_shared_bytes(head_dim: int) -> int:
    """The fp32 kernel's dynamic shared memory: Q small of both warpgroups
    ([64, head_dim] f32 each) and Q big's dims past 64 (at 128: the first 64
    are register fragments), the ring (a stage: K big, K small, V^T big, V^T
    small of one tile, f32), 128 bytes of mbarriers and release counters,
    1024 bytes of alignment."""
    stage = 4 * fp32_keys(head_dim) * head_dim * 4
    q = 2 * 64 * (2 * head_dim - 64) * 4
    return q + fp32_stages(head_dim) * stage + 128 + 1024


def fp32_kv_cols(s: int) -> int:
    """The row length of the prep's V^T (keys, a multiple of 8: a group of 8
    permuted keys never straddles the row's end)."""
    return -(-s // FP32_KV_COLS) * FP32_KV_COLS


def fp32_grid(bh: int, t: int) -> tuple[int, int]:
    """The fp32 kernel's grid (b * h, q tiles of FP32_ROWS); raises where the
    kernel takes no launch."""
    n_qt = -(-t // FP32_ROWS)
    if not 1 <= bh <= MAX_KV_BLOCKS or not 1 <= n_qt <= MAX_Q_TILES:
        raise ValueError(f"kernel takes 1 to {MAX_KV_BLOCKS} q heads (b*h) and 1 to {MAX_Q_TILES} "
                         f"tiles of {FP32_ROWS} positions; got b*h={bh}, t={t}")
    return bh, n_qt
