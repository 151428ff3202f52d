"""The int8 forward kernel's launch geometry (B5 and B6) against the JAX
package's scale grain.

`ops.int8_tiling` holds what both wrappers pass to the kernel, bq query
positions a block, and what they check before a launch. The grain comes from
the JAX package's own rule, default_block_config("int8", ...).clamp_rep(rep).
Checked here for rep 1-16 on ragged, cross and one-token shapes: the port's
grain equals the JAX rule's, no 128-key tile straddles a kv grain or runs
past the padded payload, a block's rows hold the whole GQA group, and one
block's shared memory fits an H100.
"""

import pytest
import torch

from quantizedattention_tpu.tune.config import default_block_config
from quantizedattention_tpu_torch.ops import int8_fwd as tfwd
from quantizedattention_tpu_torch.ops import int8_tiling as tiling
from quantizedattention_tpu_torch.tune.config import int8_grain

torch.set_num_threads(2)

# (t, s): ragged lengths, cross lengths both ways, one token, a single
# 128-key tile, and the training and config 3 lengths
SHAPES = [(1000, 1000), (200, 330), (330, 200), (77, 201), (1, 1), (1, 300), (128, 128),
          (2048, 2048), (8192, 8192)]
REPS = list(range(1, 17))


def _jax_grain(t, s, rep):
    cfg = default_block_config("int8", t, s, 64).clamp_rep(rep)
    kv_pad = -(-s // cfg.block_kv) * cfg.block_kv
    return cfg.block_q, min(cfg.kv_compute, kv_pad), -(-t // cfg.block_q) * cfg.block_q, kv_pad


@pytest.mark.parametrize("rep", REPS)
def test_key_tiles_stay_inside_one_jax_grain(rep):
    for t, s in SHAPES:
        q_grain, kv_grain, q_pad, kv_pad = int8_grain(t, s, rep)
        assert (q_grain, kv_grain, q_pad, kv_pad) == _jax_grain(t, s, rep)
        tiling.check_grain(kv_grain, kv_pad)
        # the tiles [k0, k0 + 128) up to the last key each lie in one grain
        # and inside the padded payload
        for k0 in range(0, s, tiling.KV_TILE):
            k1 = k0 + tiling.KV_TILE
            assert k1 <= kv_pad and k0 // kv_grain == (k1 - 1) // kv_grain, (t, s, rep, k0)
        assert q_pad >= t and q_pad % q_grain == 0


def test_shared_memory_fits_one_block():
    n = tiling.shared_bytes()
    assert n <= tiling.SMEM_LIMIT
    # Q, the K/V ring and the bf16 V ring alone
    floor = (tiling.BLOCK_ROWS * 64 + tiling.KV_STAGES * 2 * tiling.KV_TILE * 64
             + tiling.V_STAGES * tiling.KV_TILE * 64 * 2)
    assert floor < n <= floor + 4096
    assert tiling.KV_STAGES >= 2 and tiling.V_STAGES >= 2 and tiling.BLOCK_ROWS == 2 * 64


@pytest.mark.parametrize("rep", [1, 2, 3, 5, 16, 64, 128])
def test_geometry_block_rows(rep):
    """rep * bq rows hold the whole GQA group for bq positions, and one more
    position would not fit: no q head is split across blocks."""
    bq = tiling.block_positions(2, rep)
    assert rep * bq <= tiling.BLOCK_ROWS < rep * (bq + 1)


def test_geometry_refusals():
    with pytest.raises(ValueError, match="rep <= 128"):
        tiling.block_positions(1, 129)
    with pytest.raises(ValueError, match="b\\*h_kv"):
        tiling.block_positions(65536, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        tiling.check_grain(64, 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tiling.check_grain(256, 384)
    # the wrappers check the geometry before they ask for CUDA tensors
    q = torch.zeros((1, 129, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rep <= 128"):
        tfwd._fused_launch_args(q, k, k, None)
    res = tfwd.quantize_qkv(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="rep <= 128"):
        tfwd._launch_args(res, (1, 129, 4, 4, 64))
