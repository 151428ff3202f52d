"""Launch geometry of the JVP family's tensor-core kernels (csrc/jvp.cu): the
second-order backward's dK/dV (B11 fast, `jvp_dkv_wgmma`) and dQ (B12 fast,
`jvp_dq_wgmma`), the forward (B9 fast, `jvp_fwd_wgmma`) with its K-side
prep (`jvp_fwd_prep_kernel`), and the tangent's exact mode (B10 exact,
`jvp_tangent_tf32`, 3xTF32).

Pure Python, so the CPU tests can hold it. A B11 block takes DKV_KEYS keys
of one (batch * head), two warpgroups of 64, with K, tK, V and tV resident
in shared memory, and walks the Q_ROWS-row q tiles that see its keys
(causal: from `first_q_tile` on) through a ring of DKV_STAGES TMA stages,
each the bf16 Q, tQ, dO and dtO tiles and the tile's four row terms (lse,
mu, c, dhat). The prep writes the row terms `row_stride(t)` floats apart
(TMA wants 16-byte row starts). The grid is (b * h, key tiles); grid row y
holds keys y * DKV_KEYS .., so key tile 0 (the most q tiles) starts first.

B9 and B12 walk the other way: a block takes Q_BLOCK q rows of one (batch *
head), two warpgroups of 64, and walks the key tiles its rows see (causal:
up to its last row below t; `key_tiles`), FWD_KEYS keys a tile for B9 and
DQ_KEYS for B12, K, tK, V and tV a stage, through rings of FWD_STAGES and
DQ_STAGES stages. B12 keeps the block's Q,
tQ, dO and dtO resident (B11's prep writes them, and the row terms, for
both kernels); B9 keeps Q and tQ, rounded in the kernel, and reads K, tK, V
and tV from its prep's contiguous bf16 copies ([b * h, s, 64] each, one
launch for the four, FWD_PREP_ROWS keys a block). Their grids are (b * h, q
blocks); grid row y holds rows (n - 1 - y) * Q_BLOCK .., so the blocks with
the most key tiles start first. The constants mirror the kernels', and
every shared-byte count is held against the kernel's own on the card.

B10 exact (the last section) takes TANGENT_ROWS q rows of one (batch *
head) a block, as B9, and walks TANGENT_KEYS-key tiles. With lse given its
sums over keys need no rescaling, so the key tiles may be split into z
ranges of `per` tiles (`tangent_grid`: enough blocks to fill the card once,
where the q blocks alone do not), each range a block of its own; a second
launch adds the ranges' sums in range order. Its grid is (q blocks, b * h,
z); grid column x holds rows (n - 1 - x) * TANGENT_ROWS .., the blocks with
the most key tiles first.
"""

from __future__ import annotations

from quantizedattention_tpu_torch.ops.flash_tiling import MAX_Q_TILES, lse_row_stride

HEAD_DIM = 64
DKV_KEYS = 128  # keys a block: two warpgroups of 64
Q_ROWS = 32  # q rows a streamed tile
DKV_STAGES = 6  # q-side tiles in flight
ROW_TERMS = 4  # lse, mu, c, dhat
MAX_HEADS = 65535  # b * h, the grid's x extent
_TILE = Q_ROWS * HEAD_DIM * 2  # bytes of a bf16 q-side tile


def dkv_shared_bytes() -> int:
    """B11 fast's dynamic shared memory: K, tK, V, tV [128, 64] bf16, the
    ring (four bf16 tiles and four rows of Q_ROWS floats a stage), 128 bytes
    of mbarriers and release counters, 1024 bytes to align the swizzled
    tiles."""
    resident = 4 * DKV_KEYS * HEAD_DIM * 2
    return resident + DKV_STAGES * (4 * _TILE + ROW_TERMS * Q_ROWS * 4) + 128 + 1024


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
FWD_KEYS = 64  # keys a B9 tile (K, tK, V, tV)
DQ_KEYS = 32  # keys a B12 tile
FWD_STAGES = 256 // FWD_KEYS  # B9's tiles in flight
DQ_STAGES = 256 // DQ_KEYS  # B12's tiles in flight
FWD_PREP_ROWS = 256  # keys of each operand a B9 prep block converts
_BAR_AREA = 256  # mbarriers and release counters
_Q_TILE = Q_BLOCK * HEAD_DIM * 2  # bytes of a block's bf16 Q (tQ, dO, dtO)


def fwd_shared_bytes() -> int:
    """B9 fast's dynamic shared memory: the block's bf16 Q and tQ, the ring
    (bf16 K, tK, V, tV tiles a stage), the barrier area, 1024 bytes to align
    the swizzled tiles."""
    return 2 * _Q_TILE + FWD_STAGES * 4 * FWD_KEYS * HEAD_DIM * 2 + _BAR_AREA + 1024


def dq_shared_bytes() -> int:
    """B12 fast's dynamic shared memory: the block's bf16 Q, tQ, dO and dtO,
    the ring (bf16 K, tK, V, tV tiles a stage), the barrier area, 1024 bytes
    of alignment."""
    return 4 * _Q_TILE + DQ_STAGES * 4 * DQ_KEYS * HEAD_DIM * 2 + _BAR_AREA + 1024


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
    """The tiles of `keys` keys (FWD_KEYS or DQ_KEYS) a block whose rows
    start at q0 walks: causal keys past its last row below t are never
    visible."""
    hi = min(s, t, q0 + Q_BLOCK) if causal else s
    return -(-hi // keys)


def fwd_prep_grid(bh: int, s: int) -> tuple[int, int, int]:
    """B9's K-side prep grid (key blocks, b * h, the four operands)."""
    if not 1 <= bh <= MAX_HEADS or s < 1:
        raise ValueError(f"kernel takes 1 to {MAX_HEADS} heads (b*h) and s >= 1; got b*h={bh}, "
                         f"s={s}")
    return -(-s // FWD_PREP_ROWS), bh, 4


# --------------------------------------------------------------------------
# B10 exact: 3xTF32 q blocks over ranges of key tiles
# --------------------------------------------------------------------------

TANGENT_ROWS = 128  # q rows a block: two warpgroups of 64
TANGENT_KEYS = 32  # keys a tile
TANGENT_STAGES = 3  # tiles in flight
_KBLK = TANGENT_KEYS * 128  # bytes of a [32 keys x 32 dims] f32 block
_VBLK = HEAD_DIM * 128  # bytes of a [64 dims x 32 keys] f32 block (V^T)


def tangent_shared_bytes() -> int:
    """B10 exact's dynamic shared memory: each warpgroup's tQ small [64, 64]
    f32, the ring (K, tK big and small, V^T, tV^T big and small: 64 KB a
    stage), 128 bytes of mbarriers and release counters, 1024 bytes to align
    the swizzled tiles."""
    return 2 * 64 * HEAD_DIM * 4 + TANGENT_STAGES * (8 * _KBLK + 4 * _VBLK) + 128 + 1024


def tangent_grid(bh: int, t: int, s: int, sms: int) -> tuple[int, int, int]:
    """(q blocks, z, per): B10 exact's grid is (q blocks, b * h, z), range z
    taking key tiles z * per .. z * per + per - 1. z > 1 only where the q
    blocks alone fill fewer than `sms` SMs; raises where the kernel takes no
    launch."""
    n_qb, n_kt = -(-t // TANGENT_ROWS), -(-s // TANGENT_KEYS)
    if not 1 <= bh <= MAX_HEADS or t < 1 or s < 1:
        raise ValueError(f"kernel takes 1 to {MAX_HEADS} heads (b*h), t >= 1 and s >= 1; got "
                         f"b*h={bh}, t={t}, s={s}")
    want = max(1, -(-sms // (bh * n_qb)))
    per = -(-n_kt // min(want, n_kt))
    return n_qb, -(-n_kt // per), per


def tangent_key_tiles(q0: int, t: int, s: int, causal: bool) -> int:
    """The key tiles a block whose rows start at q0 sees (causal: up to its
    last row below t)."""
    hi = min(s, t, q0 + TANGENT_ROWS) if causal else s
    return -(-hi // TANGENT_KEYS)


def tangent_range(q0: int, z: int, per: int, t: int, s: int, causal: bool) -> range:
    """The key tiles range z of a block at q0 walks (empty past its last)."""
    return range(z * per, min(z * per + per, tangent_key_tiles(q0, t, s, causal)))
