"""Launch geometry of the JVP family's kernels (csrc/jvp.cu): the
second-order backward's dK/dV (B11 fast, `jvp_dkv_wgmma`) and dQ (B12 fast,
`jvp_dq_wgmma`), the forward (B9 fast, `jvp_fwd_wgmma`) with its K-side
prep (`jvp_fwd_prep_kernel`), the tangent's exact mode (B10 exact,
`jvp_tangent_tf32` at head dim 64 and `jvp_tangent_tf32_128` at 128,
3xTF32), and the shared bytes of B10 fast (`jvp_tangent_mma`) and of the
exact modes' FFMA kernels (B9, B11, B12 exact).

Pure Python, so the CPU tests can hold it. A B11 block takes DKV_KEYS keys
of one (batch * head), two warpgroups of 64, with K, tK, V and tV resident
in shared memory, and walks the Q_ROWS-row q tiles that see its keys
(causal: from `first_q_tile` on) through a ring of `dkv_stages(d)` TMA
stages, each the bf16 Q, tQ, dO and dtO tiles and the tile's four row terms
(lse, mu, c, dhat). The prep writes the row terms `row_stride(t)` floats
apart (TMA wants 16-byte row starts). The grid is (b * h, key tiles); grid
row y holds keys y * DKV_KEYS .., so key tile 0 (the most q tiles) starts
first. At head dim 128 the four outputs take more registers than a thread
has: a call launches the grid `dkv_parts(d)` times, once for dV and dtV and
once for dK and dtK.

B9 and B12 walk the other way: a block takes Q_BLOCK q rows of one (batch *
head), two warpgroups of 64, and walks the key tiles its rows see (causal:
up to its last row below t; `key_tiles`), `fwd_keys(d)` keys a tile for B9
and DQ_KEYS for B12, K, tK, V and tV a stage, through rings of FWD_STAGES
and `dq_stages(d)` stages. B12 keeps the block's Q, tQ, dO and dtO resident
(B11's prep writes them, and the row terms, for both kernels); B9 keeps Q
and tQ, rounded in the kernel, and reads K, tK, V and tV from its prep's
contiguous bf16 copies ([b * h, s, d] each, one launch for the four,
`fwd_prep_rows(d)` keys a block). Their grids are (b * h, q blocks); grid
row y holds rows (n - 1 - y) * Q_BLOCK .., so the blocks with the most key
tiles start first. The constants mirror the kernels', and every shared-byte
count is held against the kernel's own on the card.

Head dim: every kernel takes 64 or 128 (HEAD_DIMS); at 128 a bf16 row is
two 64-dim panels, each its own 128-byte swizzled TMA box, and every tile's
bytes double, so the rings hold fewer stages; the rows, tiles and walks are
the same but for B9's 32-key tiles and B10 exact's rows.

B10 exact takes `tangent_rows(d)` q rows of one (batch * head) a block (128
at head dim 64, two warpgroups of 64; 64 at 128, both warpgroups on the
same rows, each 16 keys of every tile) and walks TANGENT_KEYS-key tiles.
With lse given its sums over keys need no rescaling, so the key tiles may
be split into z ranges of `per` tiles (`tangent_grid`: enough blocks to
fill the card once, where the q blocks alone do not), each range a block of
its own; a second launch adds the ranges' sums in range order. Its grid is
(q blocks, b * h, z); grid column x holds rows (n - 1 - x) *
tangent_rows(d) .., the blocks with the most key tiles first.

The exact FFMA kernels (B9, B11, B12 exact) take 32-row or 32-key tiles of
padded f32 rows (d + 1 floats) in dynamic shared memory (`exact_shared_bytes`);
B10 fast takes 64 q rows and 32-key tiles of padded bf16 rows (d + 8).
"""

from __future__ import annotations

from quantizedattention_tpu_torch.ops.common import KERNEL_HEAD_DIMS, check_head_dim
from quantizedattention_tpu_torch.ops.flash_tiling import MAX_Q_TILES, lse_row_stride

HEAD_DIMS = KERNEL_HEAD_DIMS["B9/B11/B12 fast"]
assert all(KERNEL_HEAD_DIMS[k] == HEAD_DIMS for k in ("B9/B11/B12 exact", "B10"))
DKV_KEYS = 128  # keys a block: two warpgroups of 64
Q_ROWS = 32  # q rows a streamed tile
ROW_TERMS = 4  # lse, mu, c, dhat
MAX_HEADS = 65535  # b * h, the grid's x extent


def _fast(head_dim: int) -> int:
    check_head_dim("B9/B11/B12 fast", head_dim)
    return head_dim


def dkv_stages(head_dim: int) -> int:
    """B11's q-side tiles in flight: 6 at head dim 64, 3 at 128 (K, tK, V,
    tV resident take 128 KB there)."""
    return 6 if _fast(head_dim) == 64 else 3


def dkv_parts(head_dim: int) -> int:
    """Launches of B11's grid a call: 1 at head dim 64 (all four outputs), 2
    at 128 (dV and dtV, then dK and dtK: four m64 x 128 f32 sums would take
    256 registers a thread)."""
    return 1 if _fast(head_dim) == 64 else 2


def dkv_shared_bytes(head_dim: int) -> int:
    """B11 fast's dynamic shared memory: K, tK, V, tV [128, d] bf16, the ring
    (four bf16 tiles [Q_ROWS, d] and four rows of Q_ROWS floats a stage), 128
    bytes of mbarriers and release counters, 1024 bytes to align the
    swizzled tiles."""
    resident = 4 * DKV_KEYS * _fast(head_dim) * 2
    tile = Q_ROWS * head_dim * 2
    return resident + dkv_stages(head_dim) * (4 * tile + ROW_TERMS * Q_ROWS * 4) + 128 + 1024


def row_stride(t: int) -> int:
    """Floats between the rows of the prep's row terms, [4, b * h, ld]."""
    return lse_row_stride(t)


def first_q_tile(k0: int, t: int, causal: bool) -> int:
    """The first q tile a block whose keys start at k0 walks: causal q tiles
    wholly before its keys see none of them."""
    n_qt = -(-t // Q_ROWS)
    return min(k0 // Q_ROWS, n_qt) if causal else 0


def dkv_grid(bh: int, t: int, s: int) -> tuple[int, int]:
    """B11 fast's grid (b * h, key tiles of DKV_KEYS); raises where the
    kernel takes no launch."""
    n_kt = -(-s // DKV_KEYS)
    if not 1 <= bh <= MAX_HEADS or t < 1 or not 1 <= n_kt <= MAX_Q_TILES:
        raise ValueError(f"kernel takes 1 to {MAX_HEADS} heads (b*h), t >= 1 and 1 to "
                         f"{MAX_Q_TILES} key tiles of {DKV_KEYS}; got b*h={bh}, t={t}, s={s}")
    return bh, n_kt


# --------------------------------------------------------------------------
# B9 fast and B12 fast: q blocks walking key tiles
# --------------------------------------------------------------------------

Q_BLOCK = 128  # q rows a B9 or B12 block: two warpgroups of 64
DQ_KEYS = 32  # keys a B12 tile
FWD_STAGES = 4  # B9's tiles in flight
_BAR_AREA = 256  # mbarriers and release counters


def fwd_keys(head_dim: int) -> int:
    """Keys a B9 tile (K, tK, V, tV): 64 at head dim 64, 32 at 128 (O and
    tO's sum take 128 registers a thread there)."""
    return 64 if _fast(head_dim) == 64 else 32


def dq_stages(head_dim: int) -> int:
    """B12's tiles in flight: 8 (256 keys) at head dim 64, 3 at 128 (its
    resident Q, tQ, dO, dtO take 128 KB there)."""
    return 256 // DQ_KEYS if _fast(head_dim) == 64 else 3


def fwd_prep_rows(head_dim: int) -> int:
    """Keys of each operand a B9 prep block converts: 256 at head dim 64,
    128 at 128 (head_dim / 8 threads a row)."""
    return 8 * 256 // (_fast(head_dim) // 8)


def fwd_shared_bytes(head_dim: int) -> int:
    """B9 fast's dynamic shared memory: the block's bf16 Q and tQ, the ring
    (bf16 K, tK, V, tV tiles a stage), the barrier area, 1024 bytes to align
    the swizzled tiles."""
    q_tile = Q_BLOCK * _fast(head_dim) * 2
    return 2 * q_tile + FWD_STAGES * 4 * fwd_keys(head_dim) * head_dim * 2 + _BAR_AREA + 1024


def dq_shared_bytes(head_dim: int) -> int:
    """B12 fast's dynamic shared memory: the block's bf16 Q, tQ, dO and dtO,
    the ring (bf16 K, tK, V, tV tiles a stage), the barrier area, 1024 bytes
    of alignment."""
    q_tile = Q_BLOCK * _fast(head_dim) * 2
    return (4 * q_tile + dq_stages(head_dim) * 4 * DQ_KEYS * head_dim * 2 + _BAR_AREA + 1024)


def q_blocks(bh: int, t: int) -> tuple[int, int]:
    """B9's and B12's fast grid (b * h, q blocks of Q_BLOCK rows); raises
    where the kernels take no launch."""
    n_qb = -(-t // Q_BLOCK)
    if not 1 <= bh <= MAX_HEADS or not 1 <= n_qb <= MAX_Q_TILES:
        raise ValueError(f"kernel takes 1 to {MAX_HEADS} heads (b*h) and 1 to {MAX_Q_TILES} "
                         f"q blocks of {Q_BLOCK}; got b*h={bh}, t={t}")
    return bh, n_qb


def block_rows(y: int, n_qb: int) -> int:
    """The first q row of grid row y (the last rows first)."""
    return (n_qb - 1 - y) * Q_BLOCK


def key_tiles(q0: int, t: int, s: int, causal: bool, keys: int) -> int:
    """The tiles of `keys` keys (`fwd_keys(d)` or DQ_KEYS) a block whose
    rows start at q0 walks: causal keys past its last row below t are never
    visible."""
    hi = min(s, t, q0 + Q_BLOCK) if causal else s
    return -(-hi // keys)


def fwd_prep_grid(bh: int, s: int, head_dim: int) -> tuple[int, int, int]:
    """B9's K-side prep grid (key blocks, b * h, the four operands)."""
    rows = fwd_prep_rows(head_dim)
    if not 1 <= bh <= MAX_HEADS or s < 1:
        raise ValueError(f"kernel takes 1 to {MAX_HEADS} heads (b*h) and s >= 1; got b*h={bh}, "
                         f"s={s}")
    return -(-s // rows), bh, 4


# --------------------------------------------------------------------------
# B10 exact: 3xTF32 q blocks over ranges of key tiles
# --------------------------------------------------------------------------

TANGENT_KEYS = 32  # keys a tile
_KBLK = TANGENT_KEYS * 128  # bytes of a [32 keys x 32 dims] f32 block
_QBLK = 64 * 128  # bytes of a [64 rows x 32 dims] f32 block


def _tangent(head_dim: int) -> int:
    check_head_dim("B10", head_dim)
    return head_dim


def tangent_rows(head_dim: int) -> int:
    """B10 exact's q rows a block: 128 at head dim 64 (a warpgroup's 64
    each), 64 at 128 (shared by both warpgroups, each 16 keys of a tile:
    Q's three TF32 parts beside tO would take more registers than a thread
    has)."""
    return 128 if _tangent(head_dim) == 64 else 64


def tangent_shared_bytes(head_dim: int) -> int:
    """B10 exact's dynamic shared memory, 128 bytes of mbarriers (and
    release counters) and 1024 bytes to align the swizzled tiles. At head
    dim 64 each warpgroup's tQ small [64, 64] f32 and a ring of 3 stages (K,
    tK big and small [32, 64], V^T, tV^T big and small [64, 32]: 64 KB a
    stage); at 128 Q small, tQ big and tQ small [64, 128] for both
    warpgroups (96 KB) and each warpgroup's K part (K, tK big and small [16,
    128]) and V part (V^T, tV^T big and small [128, 16]), 32 KB each."""
    if _tangent(head_dim) == 64:
        return 2 * 64 * 64 * 4 + 3 * (8 * _KBLK + 4 * 64 * 128) + 128 + 1024
    part = 4 * 16 * head_dim * 4
    return 3 * 64 * head_dim * 4 + 2 * 2 * part + 128 + 1024


def tangent_fast_shared_bytes(head_dim: int) -> int:
    """B10 fast's dynamic shared memory: the block's 64 rows of bf16 Q and
    tQ and the 32-key bf16 K, tK, V and tV tiles, rows padded to d + 8."""
    return (2 * 64 + 4 * 32) * (_tangent(head_dim) + 8) * 2


def tangent_grid(bh: int, t: int, s: int, sms: int, head_dim: int) -> tuple[int, int, int]:
    """(q blocks, z, per): B10 exact's grid is (q blocks, b * h, z), range z
    taking key tiles z * per .. z * per + per - 1. z > 1 only where the q
    blocks alone fill fewer than `sms` SMs; raises where the kernel takes no
    launch."""
    n_qb, n_kt = -(-t // tangent_rows(head_dim)), -(-s // TANGENT_KEYS)
    if not 1 <= bh <= MAX_HEADS or t < 1 or s < 1:
        raise ValueError(f"kernel takes 1 to {MAX_HEADS} heads (b*h), t >= 1 and s >= 1; got "
                         f"b*h={bh}, t={t}, s={s}")
    want = max(1, -(-sms // (bh * n_qb)))
    per = -(-n_kt // min(want, n_kt))
    return n_qb, -(-n_kt // per), per


def tangent_key_tiles(q0: int, t: int, s: int, causal: bool, head_dim: int) -> int:
    """The key tiles a block whose rows start at q0 sees (causal: up to its
    last row below t)."""
    hi = min(s, t, q0 + tangent_rows(head_dim)) if causal else s
    return -(-hi // TANGENT_KEYS)


def tangent_range(q0: int, z: int, per: int, t: int, s: int, causal: bool,
                  head_dim: int) -> range:
    """The key tiles range z of a block at q0 walks (empty past its last)."""
    return range(z * per, min(z * per + per, tangent_key_tiles(q0, t, s, causal, head_dim)))


# --------------------------------------------------------------------------
# B9, B11 and B12 exact: FFMA on padded f32 tiles
# --------------------------------------------------------------------------

EXACT_TILE = 32  # rows (B9, B12) or keys (B11) a block, and the streamed tiles'
_PTILE = EXACT_TILE * (EXACT_TILE + 1)  # floats of a padded probability tile


def exact_shared_bytes(kernel: str, head_dim: int) -> int:
    """Dynamic shared memory of an exact FFMA block ("fwd" B9: six operand
    tiles and P, H; "dkv" B11: eight operand tiles, four probability tiles
    and four rows of row terms; "dq" B12: eight operand tiles and dS, tSb),
    operand tiles of EXACT_TILE rows of d + 1 floats."""
    check_head_dim("B9/B11/B12 exact", head_dim)
    tile = EXACT_TILE * (head_dim + 1)
    floats = {"fwd": 6 * tile + 2 * _PTILE, "dkv": 8 * tile + 4 * _PTILE + 4 * EXACT_TILE,
              "dq": 8 * tile + 2 * _PTILE}[kernel]
    return 4 * floats
