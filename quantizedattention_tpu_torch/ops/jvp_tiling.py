"""Launch geometry of the second-order backward's fast dK/dV kernel
(csrc/jvp.cu, B11 fast, `jvp_dkv_wgmma`).

Pure Python, so the CPU tests can hold it. A block takes DKV_KEYS keys of
one (batch * head), two warpgroups of 64, with K, tK, V and tV resident in
shared memory, and walks the Q_ROWS-row q tiles that see its keys (causal:
from `first_q_tile` on) through a ring of DKV_STAGES TMA stages, each the
bf16 Q, tQ, dO and dtO tiles and the tile's four row terms (lse, mu, c,
dhat). The prep writes the row terms `row_stride(t)` floats apart (TMA
wants 16-byte row starts). The grid is (b * h, key tiles); grid row y holds
keys y * DKV_KEYS .., so key tile 0 (the most q tiles) starts first. The
constants mirror the kernel's, and `dkv_shared_bytes` is held against the
kernel's own count on the card.
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
