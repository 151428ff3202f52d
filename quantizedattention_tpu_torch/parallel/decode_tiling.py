"""Launch geometry of the decode kernels (csrc/cache_decode.cu, one kernel
body, two payloads): B13 over the slotted int8 cache (entry `qa_decode`),
B14 over the paged int8 pool (`qa_paged_decode`), B15 over the slotted int4
cache (`qa_decode4`) and B16 over the paged int4 pool (`qa_paged4_decode`).

Pure Python, so the CPU tests can hold it. The kv axis is split into chunks
of CHUNK consecutive token indices, [c * CHUNK, (c + 1) * CHUNK), whatever a
row's length. The grid is (kv heads, sequences, z), z sized from the
capacity's chunks (max_len, or max_pages * page_size), the card's SMs and
the pairs (kv head, sequence), never from a length, so a launch reads no
length on the host: z = min(chunks, max(1, resident * SMs // pairs)), as
many chunks in parallel as fill the card's resident blocks. Block z takes
chunks z, z + Z, ... below the row's length (`block_chunks`; chunk 0 always
runs, a block whose first chunk is past the length exits at once), each
chunk's copies in flight while the one before is computed. For a chunk, a
block stages the payload rows of its tokens once each, runs its two
TILE-token tiles on four warps each, the online softmax's running max taken
in tile order, and writes an unnormalised partial (acc, m, l) per q row into
scratch (`scratch_shapes`). The merge sums a row's partials in chunk order
over the chunks that hold a token it sees (`row_chunks`): M = max m_c, L =
sum l_c 2^(m_c - M), O = sum acc_c 2^(m_c - M) / L, lse = M + log2 L; a row
with no live token gets O = 0, lse = -inf.

Layouts (the JAX package's): a sequence's tokens live in "pages" of
`page_size` tokens, page j being table[s, j] (paged) or j itself (slotted:
an int8 row is one page of max_len tokens, an int4 row's pages are its
PACK-token pack blocks). Slot s of chunk c is token c * CHUNK + s, in tile
s // TILE. An int8 page holds one payload row a token, and slot s stages
its token's row. An int4 page's byte row r holds its token r in the low
nibble and token r + page_size / 2 in the high nibble; the byte row of slot
s is staged at the slot of its "owner": s itself, or, for a high-nibble
token whose low partner lies in the same chunk, that partner's slot, so a
byte row is staged once per chunk and feeds both its tokens (`owner`,
`staged_rows`). Which slot a token takes, and so every sum of the kernel,
does not depend on the layout or on which block computes the chunk: B14
computes what B13 computes, and B16 what B15 computes, on the same K/V,
bit for bit.

Head dim: the kernels' entries of `ops/common.KERNEL_HEAD_DIMS`: 64 or 128
for all four. At 128 an int8 payload row, and an int4 byte row, is 128
bytes, two 64-byte halves each walked as a row of 64 is (the paged kernels'
rows reached through the page table at d bytes a token, or d bytes a byte
row). A block at head dim 128 asks for twice the stage and partial-sum
bytes, so an SM holds one (`resident`), and the grid's z doubles to fill the
card as before.
"""

from __future__ import annotations

from quantizedattention_tpu_torch.ops.common import KERNEL_HEAD_DIMS, check_head_dim

HEAD_DIMS_INT8 = KERNEL_HEAD_DIMS["B13"]  # the int8 body's entries (B13 and B14 alike)
HEAD_DIMS_INT4 = KERNEL_HEAD_DIMS["B15"]  # the int4 body's entries (B15 and B16 alike)
PACK = 256  # tokens of a slotted int4 pack block: the slotted cache's "page"
PAYLOADS = ("int8", "int4")
CHUNK = 256  # tokens a block: a pack block, or whole pages of 128 or 256
TILE = 128  # tokens an online-softmax step
THREADS = 256  # eight warps: four a tile, 32 tokens each
M_ROWS = 16  # q rows an mma.sync m-tile
MAX_ROWS = 128  # q rows (GQA group x spec) a kv head: eight m-tiles
MAX_GRID_YZ = 65535
H100_SMS = 132
SM_SHARED = 228 * 1024  # shared bytes an H100 SM holds, 1 KB of them reserved a block
MAX_RESIDENT = 2  # registers: two blocks of THREADS at the kernel's 128-register cap


def resident(head_dim: int) -> int:
    """Blocks an SM holds, as the kernel's `resident(D)` declares them for
    both payloads: as many as the larger of their shared_bytes() takes, at
    most MAX_RESIDENT: two at head dim 64, one at 128 (a block asks for 206
    KB of int8 or 211 KB of int4)."""
    most = max(shared_bytes(payload, head_dim) for payload in PAYLOADS)
    return min(MAX_RESIDENT, SM_SHARED // (most + 1024))


def n_chunks(capacity: int) -> int:
    """Chunks of the grid: the capacity's tokens, CHUNK a chunk."""
    return -(-capacity // CHUNK)


def grid(n_kv: int, n_seqs: int, capacity: int, head_dim: int,
         sms: int = H100_SMS) -> tuple[int, int, int]:
    """The kernel's grid (kv heads, sequences, z) on a card of `sms` SMs
    (the wrappers pass the device's count; the default is an H100 SXM's) at
    `head_dim`; raises where the kernel takes no launch. The launch takes its
    z from here."""
    chunks = n_chunks(capacity)
    if n_kv < 1 or not 1 <= n_seqs <= MAX_GRID_YZ or not 1 <= chunks <= MAX_GRID_YZ:
        raise ValueError(f"kernel takes 1 to {MAX_GRID_YZ} sequences and chunks of {CHUNK} "
                         f"tokens; got {n_seqs} sequences, capacity {capacity}")
    return n_kv, n_seqs, min(chunks, max(1, resident(head_dim) * sms // (n_kv * n_seqs)))


def block_chunks(z: int, grid_z: int, length: int, capacity: int) -> list[int]:
    """The chunks block z of a grid of `grid_z` computes, in order."""
    return list(range(z, live_chunks(length, capacity), grid_z))


def scratch_shapes(n_seqs: int, n_kv: int, rows: int, capacity: int,
                   head_dim: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The partials' shapes: acc [n_seqs, n_kv, chunks, rows, head_dim] and
    (m, l) [n_seqs, n_kv, chunks, rows, 2], f32."""
    lead = (n_seqs, n_kv, n_chunks(capacity), rows)
    return lead + (head_dim,), lead + (2,)


def live_chunks(length: int, capacity: int) -> int:
    """Blocks of a (kv head, sequence) that run: the chunks below its length
    (clamped to [0, capacity]), and chunk 0 always."""
    return max(1, n_chunks(min(max(length, 0), capacity)))


def row_limit(length: int, spec: int, r: int) -> int:
    """Tokens q row r = g * spec + j sees: length - (spec - 1) + j."""
    return length - (spec - 1) + r % spec


def row_chunks(limit: int) -> int:
    """Chunks the merge sums for a row that sees `limit` tokens."""
    return n_chunks(max(limit, 0))


def tiles(length: int, chunk: int) -> int:
    """Tiles block `chunk` walks: those holding a token below the length."""
    return min(max(-(-(length - chunk * CHUNK) // TILE), 0), CHUNK // TILE)


def token_slot(t: int) -> tuple[int, int, int]:
    """Token t -> (chunk, tile within the chunk, slot within the tile)."""
    s = t % CHUNK
    return t // CHUNK, s // TILE, s % TILE


def slot_source(page_size: int, t: int, payload: str = "int4") -> tuple[int, int, bool]:
    """Token t -> (page index, the table's column or the pack block; payload
    row within the page; high nibble, always False for int8)."""
    if payload == "int8":
        return t // page_size, t % page_size, False
    half = page_size // 2
    in_page = t % page_size
    return t // page_size, in_page % half, in_page >= half


def owner(page_size: int, s: int, chunk: int = 0, payload: str = "int4") -> int:
    """The slot whose staged payload row slot s of `chunk` reads."""
    if payload == "int8":
        return s
    half = page_size // 2
    hi = (chunk * CHUNK + s) % page_size >= half
    return s - half if hi and s >= half else s


def staged_rows(page_size: int, chunk: int, length: int,
                payload: str = "int4") -> dict[int, tuple[int, int]]:
    """The payload rows block `chunk` loads from device memory: owner slot ->
    (page index, row), for owners below the length (the others are
    zero-filled in shared memory and never read). int8: every live token's
    row, at its own slot; int4: every live owner's byte row."""
    rows = {}
    for s in range(CHUNK):
        t = chunk * CHUNK + s
        if owner(page_size, s, chunk, payload) == s and t < length:
            page, row, _ = slot_source(page_size, t, payload)
            rows[s] = (page, row)
    return rows


def shared_bytes(payload: str, head_dim: int) -> int:
    """Dynamic shared memory of a block: two stages (the chunk computed and
    the next one's copies), each the K and V payload rows [CHUNK, head_dim]
    by slot, for int4 a slot's source (row offset and nibble shift, 2
    bytes), and the f32 scales of K and V; q's first m-tile [M_ROWS,
    head_dim] f32; each warp's row maxima, partial acc (rows padded by a
    float) and l of an m-tile; the m-tile's m and alpha; the merging flag;
    rounded up to 16 bytes. The head dims are B13's (int8) and B15's (int4)."""
    if payload not in PAYLOADS:
        raise ValueError(f"payload {payload!r} is not one of {PAYLOADS}")
    check_head_dim("B13" if payload == "int8" else "B15", head_dim)
    warps = THREADS // 32
    src = 2 * CHUNK if payload == "int4" else 0
    stage = 2 * CHUNK * head_dim + src + 4 * 2 * CHUNK
    floats = warps * M_ROWS * (1 + (head_dim + 1) + 1) + 2 * M_ROWS
    return -(-(2 * stage + 4 * (M_ROWS * head_dim + floats) + 4) // 16) * 16
