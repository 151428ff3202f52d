"""Launch geometry of the int8 forward kernel (csrc/int8_fwd.cu), B5 and B6.

Pure Python, so the CPU tests can hold it against the JAX package's scale
grain. A block has BLOCK_ROWS query rows, which hold one kv head's whole GQA
group: bq = BLOCK_ROWS // rep query positions a block, which the wrappers
pass to the kernel (it maps row r to q head kv_head * rep + r // bq at
position q0 + r % bq and launches cdiv(t, bq) x (b * h_kv) blocks). Keys are
walked in tiles of KV_TILE; each tile takes one kv grain's sk and sv, so a kv
grain must be a multiple of KV_TILE (the JAX grain always is: a multiple of
128). K/V tiles arrive by TMA through a ring of KV_STAGES int8 stages; V is
widened into a ring of V_STAGES bf16 stages. The constants mirror the
kernel's, and `shared_bytes` is held against the kernel's own count on the
card.
"""

from __future__ import annotations

HEAD_DIM = 64
BLOCK_ROWS = 128  # two warpgroups of 64
KV_TILE = 128  # keys a tile
KV_STAGES = 3  # int8 K/V tiles in flight
V_STAGES = 2  # bf16 V tiles
SMEM_LIMIT = 232_448  # shared bytes an H100 block may use (227 KB)
MAX_KV_BLOCKS = 65535  # the grid's y extent


def shared_bytes() -> int:
    """Dynamic shared memory of one block: the int8 Q tile, the K/V ring, the
    bf16 V ring, 128 bytes of mbarriers, 1024 bytes of bf16 ones (the B
    operand of P's row sums) and 1024 bytes to align the swizzled tiles."""
    q = BLOCK_ROWS * HEAD_DIM
    kv = KV_STAGES * 2 * KV_TILE * HEAD_DIM
    vb = V_STAGES * KV_TILE * HEAD_DIM * 2
    return q + kv + vb + 128 + 1024 + 1024


def block_positions(bh_kv: int, rep: int) -> int:
    """bq, the query positions a block, for a launch on bh_kv kv heads with
    GQA rep; raises where the kernel takes no block."""
    if not 1 <= rep <= BLOCK_ROWS:
        raise ValueError(f"kernel takes rep <= {BLOCK_ROWS} (the GQA group fills one block's "
                         f"rows); got rep={rep}")
    if not 1 <= bh_kv <= MAX_KV_BLOCKS:
        raise ValueError(f"kernel takes b*h_kv <= {MAX_KV_BLOCKS}; got {bh_kv}")
    return BLOCK_ROWS // rep


def check_grain(kv_grain: int, kv_pad: int) -> None:
    """Raise unless every key tile lies inside one kv grain and the padding."""
    if kv_grain % KV_TILE or kv_pad % kv_grain:
        raise ValueError(f"kernel takes a kv grain that is a multiple of {KV_TILE} and divides "
                         f"the padded length; got grain {kv_grain}, padded {kv_pad}")
