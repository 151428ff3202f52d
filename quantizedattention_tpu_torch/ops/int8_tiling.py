"""Launch geometry of the int8 attention kernels: the forward (csrc/int8_fwd.cu,
B5 and B6), the backward (csrc/int8_bwd.cu, B7 and B8) and the Q/K/V
quantizer (csrc/quant_int8.cu, B4).

Pure Python, so the CPU tests can hold it against the JAX package's scale
grain. A block has BLOCK_ROWS query rows, which hold one kv head's whole GQA
group: bq = BLOCK_ROWS // rep query positions a block, which the wrappers
pass to the kernel (it maps row r to q head kv_head * rep + r // bq at
position q0 + r % bq and launches cdiv(t, bq) x (b * h_kv) blocks). Keys are
walked in tiles of `kv_tile`; each tile takes one kv grain's sk and sv, so a
kv grain must be a multiple of GRAIN_UNIT (the JAX grain always is: a
multiple of 128). K/V tiles arrive by TMA through a ring of KV_STAGES int8 stages; V is
widened into a ring of V_STAGES bf16 stages. The constants mirror the
kernel's, and `shared_bytes` is held against the kernel's own count on the
card.

Head dims (HEAD_DIMS): 64 and 128, one kernel body each. At 128 an int8
row is 128 bytes (the 128-byte swizzle in place of the 64-byte one), the
forward walks keys in tiles of 64 (`kv_tile`), every tile's bytes double,
B7 keeps the widened V in shared memory (the A of dP^T) and B8 sums dQ in
shared memory, and B7's ring holds 3 stages (`dkv_stages`); the rows, q
tiles, grains and walks are the same.

The backward (the second section) streams 64-token tiles through both
kernels. B7 takes 128 keys a block (two warpgroups of 64), so a kv grain must
be a multiple of 128 and a q grain a multiple of 64; it walks, for each q head
of the GQA group, the 64-row q tiles from `dkv_first_q_tile` on. B8 takes
BLOCK_ROWS rows a block, bq = `block_positions` positions of every q head of
the group, and walks the 64-key tiles up to `dq_key_tiles`. Their shared
bytes are held against the kernels' own counts on the card as well.

B4 (the third section) gives each (tensor, row, grain) item a thread-block
cluster of QUANT_CLUSTER blocks; block `rank` of it quantizes the grain's
tokens `quant_share_tokens(grain, rank)`, so the shares tile the grain once,
and the items of up to QUANT_MAX_JOBS tensors are laid end to end in one
launch (`quant_items`), cluster c taking item c.
"""

from __future__ import annotations

from quantizedattention_tpu_torch.ops.common import KERNEL_HEAD_DIMS, check_head_dim

HEAD_DIMS = KERNEL_HEAD_DIMS["B5"]  # and B4's, B6's, B7/B8's
BLOCK_ROWS = 128  # two warpgroups of 64
GRAIN_UNIT = 128  # a kv grain is a multiple of it: B5's widest key tile, B7's key block
KV_STAGES = 3  # int8 K/V tiles in flight
V_STAGES = 2  # bf16 V tiles
SMEM_LIMIT = 232_448  # shared bytes an H100 block may use (227 KB)
MAX_KV_BLOCKS = 65535  # the grid's y extent


def kv_tile(head_dim: int) -> int:
    """Keys a K/V tile of the forward: 128 at head dim 64, 64 at 128 (S then
    takes 32 registers a thread, beside O's and the tile's PV's 64 each)."""
    check_head_dim("B5", head_dim)
    return 128 if head_dim == 64 else 64


def shared_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block: the int8 Q tile, the K/V ring, the
    bf16 V ring, 128 bytes of mbarriers, 1024 bytes of bf16 ones (the B
    operand of P's row sums) and 1024 bytes to align the swizzled tiles."""
    q = BLOCK_ROWS * head_dim
    kv = KV_STAGES * 2 * kv_tile(head_dim) * head_dim
    vb = V_STAGES * kv_tile(head_dim) * head_dim * 2
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
    """Raise unless every key tile (of either head dim) lies inside one kv
    grain and the padding."""
    if kv_grain % GRAIN_UNIT or kv_pad % kv_grain:
        raise ValueError(f"kernel takes a kv grain that is a multiple of {GRAIN_UNIT} and "
                         f"divides the padded length; got grain {kv_grain}, padded {kv_pad}")


# --------------------------------------------------------------------------
# The backward, B7 (dK, dV) and B8 (dQ)
# --------------------------------------------------------------------------

BWD_TILE = 64  # q positions a B7 tile, keys a B8 tile
DKV_KEYS = 128  # keys a B7 block: two warpgroups of 64
DQ_STAGES = 3  # int8 K / V tiles in flight (B8)
DQ_WIDE_K = 3  # widened K tiles (B8): one being written, one read, one draining
MAX_GRID_Y = 65535  # the grid's y extent: key tiles (B7) or row blocks (B8)
MAX_TMA_ROW = 2**31 - 1  # TMA row coordinates are int32
_ACC = 32  # f32 accumulator registers a thread


def dkv_stages(head_dim: int) -> int:
    """B7's ring of int8 Q and bf16 dO tiles: 4 stages at head dim 64, 3 at
    128 (four would pass the SM's shared memory)."""
    check_head_dim("B7/B8", head_dim)
    return 4 if head_dim == 64 else 3


def _sums(head_dim: int) -> int:
    """Bytes of an f32 sum of 64 rows x head_dim a warpgroup, each thread its
    own slots (B7's dK, B8's dQ at 128)."""
    return head_dim // 64 * _ACC * 256 * 4


def dkv_shared_bytes(head_dim: int) -> int:
    """B7's dynamic shared memory: K [128, d] int8, at d = 128 the widened V
    [128, d] bf16, the ring of int8 Q and bf16 dO tiles, two widened Q
    tiles, dK's f32 sums, two row buffers (lse, D and sq of a q tile: 132
    floats), 64 bytes of mbarriers and 1024 bytes to align the swizzled
    tiles."""
    tile_i8 = BWD_TILE * head_dim
    vw = 0 if head_dim == 64 else DKV_KEYS * head_dim * 2
    return (DKV_KEYS * head_dim + vw + dkv_stages(head_dim) * 3 * tile_i8 + 2 * 2 * tile_i8
            + _sums(head_dim) + 2 * (2 * BWD_TILE + 4) * 4 + 64 + 1024)


def dq_shared_bytes(head_dim: int) -> int:
    """B8's dynamic shared memory: Q [128, d] int8, the ring of int8 K and V
    tiles, the widened K and V tiles (bf16), at d = 128 dQ's f32 sums, 64
    bytes of mbarriers and 1024 bytes of alignment."""
    check_head_dim("B7/B8", head_dim)
    tile_i8 = BWD_TILE * head_dim
    sums = 0 if head_dim == 64 else _sums(head_dim)
    return (BLOCK_ROWS * head_dim + DQ_STAGES * 2 * tile_i8 + (DQ_WIDE_K + 2) * 2 * tile_i8
            + sums + 64 + 1024)


def check_bwd_grains(q_grain: int, kv_grain: int, q_pad: int, kv_pad: int) -> None:
    """Raise unless every B7 key block and B8 key tile lies inside one kv
    grain, every q tile inside one q grain, and the grains tile the padding."""
    if q_grain % BWD_TILE or kv_grain % DKV_KEYS or q_pad % q_grain or kv_pad % kv_grain:
        raise ValueError(f"kernels take a q grain that is a multiple of {BWD_TILE} and a kv "
                         f"grain that is a multiple of {DKV_KEYS}, each dividing its padded "
                         f"length; got grains {q_grain}, {kv_grain}, padded {q_pad}, {kv_pad}")


def dkv_first_q_tile(k0: int, t: int, causal: bool) -> int:
    """The first q tile a B7 block at key k0 visits: causal, the tile that
    holds position k0 (tiles before it see none of the block's keys), or
    cdiv(t, 64) when no position reaches k0."""
    n_qt = -(-t // BWD_TILE)
    return min(k0 // BWD_TILE, n_qt) if causal else 0


def dq_key_tiles(q0: int, bq: int, t: int, s: int, causal: bool) -> int:
    """The 64-key tiles a B8 block at position q0 visits: causal, up to its
    last position below t, min(q0 + bq, t) - 1; else all of [0, s)."""
    kv_hi = min(s, q0 + bq, t) if causal else s
    return -(-kv_hi // BWD_TILE)


def bwd_grids(bh_kv: int, rep: int, t: int, s: int, q_pad: int,
              kv_pad: int) -> tuple[int, tuple[int, int], tuple[int, int]]:
    """(bq, B7's grid, B8's grid), each grid (x, y) = (b * h_kv, key tiles of
    128 or row blocks of bq positions); raises where a kernel takes no launch."""
    bq = block_positions(bh_kv, rep)
    dkv = (bh_kv, -(-s // DKV_KEYS))
    dq = (bh_kv, -(-t // bq))
    if max(dkv[1], dq[1]) > MAX_GRID_Y:
        raise ValueError(f"kernels take at most {MAX_GRID_Y} key tiles of {DKV_KEYS} and row "
                         f"blocks of {bq}; got s={s}, t={t}")
    if bh_kv * rep * q_pad > MAX_TMA_ROW or bh_kv * kv_pad > MAX_TMA_ROW:
        raise ValueError(f"kernels take b*h*q_pad and b*h_kv*kv_pad below 2^31; got "
                         f"{bh_kv * rep * q_pad}, {bh_kv * kv_pad}")
    return bq, dkv, dq


# --------------------------------------------------------------------------
# B4, the Q/K/V quantizer
# --------------------------------------------------------------------------

QUANT_CLUSTER = 8  # blocks a grain (the portable cluster size)
QUANT_THREADS = 128
QUANT_MAX_GRAIN = 1024  # a block's share at most 128 tokens: 32 KB of f32 at d 64, in shared memory
QUANT_MAX_JOBS = 3  # Q, K and V of one call
QUANT_MAX_ITEMS = (2**31 - 1) // QUANT_CLUSTER  # (row, grain) items a launch: the grid's x


def quant_check_grain(grain: int) -> None:
    """Raise unless the kernel takes `grain`: a multiple of 16 up to
    QUANT_MAX_GRAIN (each block's share a whole number of tokens)."""
    if grain % 16 or not 16 <= grain <= QUANT_MAX_GRAIN:
        raise ValueError(f"kernel takes grains that are multiples of 16 up to {QUANT_MAX_GRAIN}, "
                         f"got {grain}")


def quant_share_tokens(grain: int, rank: int) -> range:
    """The tokens of a grain (offsets from its first) that block `rank` of
    its cluster quantizes."""
    share = grain // QUANT_CLUSTER
    return range(rank * share, (rank + 1) * share)


def quant_items(jobs) -> list[int]:
    """The first item of each job (rows, pad, grain) of one launch and, last,
    the launch's item count; raises where the kernel takes no launch."""
    if not 1 <= len(jobs) <= QUANT_MAX_JOBS:
        raise ValueError(f"kernel takes 1 to {QUANT_MAX_JOBS} jobs, got {len(jobs)}")
    starts = [0]
    for rows, pad, grain in jobs:
        quant_check_grain(grain)
        if pad % grain:
            raise ValueError(f"pad {pad} is not a multiple of grain {grain}")
        starts.append(starts[-1] + rows * (pad // grain))
    if starts[-1] > QUANT_MAX_ITEMS:
        raise ValueError(f"kernel takes at most {QUANT_MAX_ITEMS} (row, grain) items a launch, "
                         f"got {starts[-1]}")
    return starts


def quant_shared_bytes(head_dim: int) -> int:
    """B4's dynamic shared memory: a block's largest share (QUANT_MAX_GRAIN /
    QUANT_CLUSTER tokens) in f32 rows of head_dim, staged there by its
    copies."""
    check_head_dim("B4", head_dim)
    return QUANT_MAX_GRAIN // QUANT_CLUSTER * head_dim * 4
