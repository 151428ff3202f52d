"""The grains that the JAX package's block config fixes in the numerics.

Counterpart of the part of quantizedattention_tpu/tune/config.py that the
int8 path's numerics depend on. In the JAX package one BlockConfig both tiles
the kernels and sets the int8 quantization grain: Q gets one scale per
`block_q` tokens, K and V one per `kv_compute` tokens, and K/V are padded up
to `block_kv`. The grain is part of the numerics, not of the tiling: a
different grain gives different payloads and scales, hence different
outputs. So the port reproduces the rule exactly (`int8_grain`), while the
Hopper kernels tile at their own 64-token tiles inside it.

The bf16 forward's "beta" correction has a grain of the same kind
(`correction_grain`): the JAX kernel decides whether a row's maximum is tied,
and amplifies it, once per kv subtile of min(kv_compute, block_kv) keys, so
the subtile's width enters the result.

Carried over: the BlockConfig fields, `kv_compute`, `clamp` (fit to short
sequences), `clamp_rep` (the GQA shrink), the pinned "int8", "bf16" and
"fp32" defaults and the int8 all-gather's shard rule (`int8_shard_grain`).
Left out: the autotune JSON cache and the other kinds' defaults.
"""

from __future__ import annotations

import dataclasses

# The JAX package's limits on a GQA group's tiles (clamp_rep): rows of a q
# block times rep, and elements of the forward's and the backward's tile.
MAX_ROWS = 2048
MAX_TILE_ELEMS = 2 * 1024 * 1024
MAX_TILE_ELEMS_BWD = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Block sizes of one attention kernel family (tokens, multiples of 128).

    block_q / block_kv: forward blocks along q / kv; block_q_bwd /
    block_kv_bwd: backward blocks; block_kv_compute: the kv subtile inside a
    block_kv block (0 = the same as block_kv).
    """

    block_q: int = 256
    block_kv: int = 256
    block_q_bwd: int = 128
    block_kv_bwd: int = 128
    block_kv_compute: int = 0

    def __post_init__(self):
        for name in ("block_q", "block_kv", "block_q_bwd", "block_kv_bwd"):
            if getattr(self, name) % 128 != 0:
                raise ValueError(f"{name}={getattr(self, name)} must be a multiple of 128")
        if self.block_kv_compute:
            if self.block_kv_compute % 128 != 0:
                raise ValueError("block_kv_compute must be a multiple of 128")
            if self.block_kv % self.block_kv_compute != 0:
                raise ValueError("block_kv_compute must divide block_kv")

    @property
    def kv_compute(self) -> int:
        return self.block_kv_compute or self.block_kv

    def clamp_rep(self, rep: int) -> "BlockConfig":
        """Shrink the blocks for a GQA group of `rep` q heads, exactly as the
        JAX package does (rep * block_q <= MAX_ROWS, rep * block_q *
        kv_compute <= MAX_TILE_ELEMS, the backward's tile <= MAX_TILE_ELEMS_BWD).
        rep <= 1 is untouched. Deterministic and idempotent. The bwd fields
        are shrunk too, for fidelity to the JAX config; the grain does not
        depend on them."""
        if rep <= 1:
            return self

        def floor128(x: int) -> int:
            return max(128, x // 128 * 128)

        row_cap = floor128(MAX_ROWS // rep)
        block_q = min(self.block_q, row_cap, floor128(MAX_TILE_ELEMS // (rep * 128)))
        sub_cap = floor128(MAX_TILE_ELEMS // (rep * block_q))
        want = min(self.kv_compute, sub_cap, self.block_kv)
        sub = 128
        for cand in range(128, want + 1, 128):
            if self.block_kv % cand == 0:
                sub = cand
        block_q_bwd = min(self.block_q_bwd, row_cap,
                          floor128(MAX_TILE_ELEMS_BWD // (rep * self.block_kv_bwd)))
        block_kv_bwd = min(self.block_kv_bwd,
                           floor128(MAX_TILE_ELEMS_BWD // (rep * block_q_bwd)))
        return dataclasses.replace(
            self, block_q=block_q, block_q_bwd=block_q_bwd, block_kv_bwd=block_kv_bwd,
            block_kv_compute=0 if sub == self.block_kv else sub,
        )

    def clamp(self, q_tokens: int, kv_tokens: int) -> "BlockConfig":
        """Shrink the blocks to fit short sequences (never below 128)."""

        def fit(block: int, tokens: int) -> int:
            return max(128, min(block, ((tokens + 127) // 128) * 128))

        block_kv = fit(self.block_kv, kv_tokens)
        want = min(self.block_kv_compute or block_kv, block_kv)
        compute = 128
        for cand in range(128, want + 1, 128):
            if block_kv % cand == 0:
                compute = cand
        return BlockConfig(
            block_q=fit(self.block_q, q_tokens),
            block_kv=block_kv,
            block_q_bwd=fit(self.block_q_bwd, q_tokens),
            block_kv_bwd=fit(self.block_kv_bwd, kv_tokens),
            block_kv_compute=0 if compute == block_kv else compute,
        )


# The JAX package's pinned "int8", "bf16" and "fp32" defaults (tune/config.py:164-180).
INT8_DEFAULT = BlockConfig(block_q=1024, block_kv=8192, block_q_bwd=1024, block_kv_bwd=1024,
                           block_kv_compute=1024)
BF16_DEFAULT = BlockConfig(block_q=1024, block_kv=8192, block_q_bwd=1024, block_kv_bwd=1024,
                           block_kv_compute=1024)
FP32_DEFAULT = BlockConfig(block_q=256, block_kv=512, block_q_bwd=512, block_kv_bwd=512)


def int8_grain(t: int, s: int, rep: int = 1) -> tuple[int, int, int, int]:
    """(q_grain, kv_grain, q_pad, kv_pad) of int8 attention on t queries and
    s keys with GQA rep: Q gets one scale per q_grain tokens and is padded to
    q_pad; K and V get one per kv_grain tokens and are padded to kv_pad (the
    JAX package's block_kv, a multiple of kv_grain). The head dim does not
    enter the rule."""
    # the default fitted to the lengths, then shrunk for the GQA group
    cfg = INT8_DEFAULT.clamp(t, s).clamp_rep(rep)
    q_pad = -(-t // cfg.block_q) * cfg.block_q
    kv_pad = -(-s // cfg.block_kv) * cfg.block_kv
    return cfg.block_q, min(cfg.kv_compute, kv_pad), q_pad, kv_pad


def int8_shard_grain(t_local: int, rep: int = 1) -> tuple[int, int, int, int]:
    """`int8_grain(t_local, t_local, rep)` of one sequence shard whose K/V
    payloads and scale tables are all-gathered (JAX
    parallel/collective.py:150-163), after its refusals: t_local must be a
    multiple of 128, and of the kv block and grain of the config clamped to
    the shard (`clamp(t_local, t_local)`). Then kv_pad == t_local, so the
    shards' grids concatenate with no interior padding: the gathered
    payload is the whole sequence's quantization grid."""
    if t_local % 128 != 0:
        raise ValueError("int8 all-gather requires t_local % 128 == 0")
    cfg = INT8_DEFAULT.clamp(t_local, t_local)
    if t_local % cfg.block_kv != 0 or t_local % cfg.kv_compute != 0:
        raise ValueError(f"int8 all-gather: t_local={t_local} must be a multiple of the kv block "
                         f"({cfg.block_kv}) and grain ({cfg.kv_compute})")
    return int8_grain(t_local, t_local, rep)


def correction_grain(t: int, s: int, rep: int = 1, precision: str = "bf16") -> int:
    """Keys of one subtile of the JAX forward on t queries and s keys with
    GQA rep, in `precision` "bf16" or "fp32": min(kv_compute, block_kv) of
    the pinned default fitted to the lengths and shrunk for the group (JAX
    ops/flash_fwd.py:255-257,289). The "beta" rule counts ties and amplifies
    the running max once per such group of keys, from key 0. Always a
    multiple of 128."""
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"unknown precision {precision!r}")
    default = BF16_DEFAULT if precision == "bf16" else FP32_DEFAULT
    cfg = default.clamp(t, s).clamp_rep(rep)
    return min(cfg.kv_compute, cfg.block_kv)
