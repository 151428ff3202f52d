"""The fp32 flash forward's launch geometry and 3xTF32 split (B1 fp32,
csrc/flash_fwd.cu) and the launch geometry and operand prep of the
second-order backward's fast dK/dV kernel (B11 fast, csrc/jvp.cu).

`ops.flash_tiling` (its fp32 section) and `ops.jvp_tiling` hold what the
wrappers pass to the kernels and the kernels' shared bytes. Checked here:
B1 fp32's blocks (128 positions of one q head) cover every (q head,
position < t) exactly once; the K/V prep's split gives big + small == x
with big rounded to nearest TF32 (ties away from zero) and small exact, and
its V^T holds each group of 8 keys in the order the kernel's P fragments
hold them, zeros past s; B11 fast's 128-key blocks and the 32-row q tiles
they walk cover every (key, position) pair attention computes exactly once;
the row terms' stride starts each row on 16 bytes; each block's shared
memory fits an H100; the grids' limits raise. B11's plain prep is the
rounding the plain fast path applies, byte for byte, and the row terms of
`jvp_bwd_operands`. A numpy emulation of 3xTF32 (the split, the low 13 bits
of every operand dropped, the small-small term left out) keeps fp32
attention within 1e-5 of max|float64| on (2, 2, 300, 64) over 8 seeds: the
accuracy argument for the kernel's design, on record.
"""

import numpy as np
import pytest
import torch

from quantizedattention_tpu_torch.ops import flash_tiling, jvp_tiling
from quantizedattention_tpu_torch.ops.flash_fwd import kv_split_tf32_plain, tf32_split
from quantizedattention_tpu_torch.ops.jvp_bwd import (
    jvp_bwd_dkv_plain,
    jvp_bwd_operands,
    jvp_bwd_prep,
    jvp_bwd_prep_plain,
)
from quantizedattention_tpu_torch.ops.jvp_fwd import attention_jvp_fwd_plain

torch.set_num_threads(2)

TS = [1, 31, 32, 33, 63, 64, 127, 128, 129, 200, 300, 1000, 4096]


# --------------------------------------------------------------------------
# B1 fp32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t", TS)
def test_fp32_blocks_cover_every_position_once(t):
    """Grid row y holds positions (n_qt - 1 - y) * 128 .. + 127 of its q
    head (the last positions first); the live ones cover 0 .. t - 1 once."""
    bh, n_qt = flash_tiling.fp32_grid(6, t)
    assert bh == 6
    q0 = (n_qt - 1 - np.arange(n_qt)) * flash_tiling.FP32_ROWS
    pos = (q0[:, None] + np.arange(flash_tiling.FP32_ROWS)).ravel()
    counts = np.bincount(pos[pos < t], minlength=t)
    assert (counts == 1).all() and q0.min() == 0


def test_fp32_shared_memory_fits_one_block():
    n = flash_tiling.fp32_shared_bytes()
    assert n <= flash_tiling.SMEM_LIMIT
    # Q small of two warpgroups and the ring of K big/small, V^T big/small alone
    floor = 128 * 64 * 4 + flash_tiling.FP32_STAGES * 4 * flash_tiling.FP32_KEYS * 64 * 4
    assert floor < n <= floor + 2048


@pytest.mark.parametrize("bh, t", [(0, 10), (65536, 10), (1, 0), (1, 128 * 65535 + 1)])
def test_fp32_grid_limits_raise(bh, t):
    with pytest.raises(ValueError, match="kernel takes"):
        flash_tiling.fp32_grid(bh, t)


def test_tf32_fragment_order():
    """An accumulator pair (2c, 2c + 1) lands on fragment columns c, c + 4:
    column j of a group holds key TF32_A_COLUMNS[j], a permutation of 0..7."""
    cols = flash_tiling.TF32_A_COLUMNS
    assert sorted(cols) == list(range(8))
    for c in range(4):
        assert cols[c] == 2 * c and cols[c + 4] == 2 * c + 1


@pytest.mark.parametrize("seed", range(4))
def test_tf32_split_rounds_to_nearest(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
        -6, 6, 4096).astype(np.float32))
    big, small = tf32_split(x)
    bits = big.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()  # big is a TF32 value
    assert torch.equal(big + small, x)  # small is exact
    # nearest: |small| at most half a TF32 ulp of big (2^-11 of its binade)
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(big)[1] - 11)
    assert (small.abs() <= ulp / 2).all()


def test_tf32_split_ties_away_from_zero():
    base = 1.0 + 2.0 ** -10  # a TF32 value; + half its ulp is a tie
    x = torch.tensor([base + 2.0 ** -11, -(base + 2.0 ** -11), 1.0 + 2.0 ** -11], dtype=torch.float32)
    big, _ = tf32_split(x)
    assert big.tolist() == [base + 2.0 ** -10, -(base + 2.0 ** -10), 1.0 + 2.0 ** -10]


@pytest.mark.parametrize("s", [1, 7, 8, 13, 64, 65, 201])
def test_kv_split_layout(s):
    gen = torch.Generator().manual_seed(s)
    k, v = (torch.randn((2, 3, s, 64), generator=gen) for _ in range(2))
    kb, ks, vbt, vst = kv_split_tf32_plain(k, v)
    s8 = flash_tiling.fp32_kv_cols(s)
    assert s8 % 8 == 0 and s <= s8 < s + 8
    assert kb.shape == ks.shape == (6, s, 64) and vbt.shape == vst.shape == (6, 64, s8)
    assert torch.equal(kb + ks, k.reshape(6, s, 64))
    vt = vbt + vst  # [bh, d, s8]: column 8g + j holds key 8g + TF32_A_COLUMNS[j]
    for col in range(s8):
        key = col // 8 * 8 + flash_tiling.TF32_A_COLUMNS[col % 8]
        want = v.reshape(6, s, 64)[:, key] if key < s else torch.zeros(6, 64)
        assert torch.equal(vt[:, :, col], want), col


def _tf32(x):
    """What the tensor core reads of an f32 array: its low 13 bits dropped."""
    return (x.view(np.int32) & np.int32(-0x2000)).view(np.float32)


def _split(x):
    big = ((x.view(np.int32) + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)
    return big, x - big


def _mm3(a, b):
    """a @ b as 3xTF32: big.big + big.small + small.big, each operand as the
    tensor core reads it, the products summed in float64."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    a_b, a_s, b_b, b_s = (_tf32(x).astype(np.float64) for x in (ab, as_, bb, bs))
    return a_b @ b_s + a_s @ b_b + a_b @ b_b


def _mm1(a, b):
    """a @ b with the big terms alone (1xTF32), in float64."""
    return _tf32(_split(a)[0]).astype(np.float64) @ _tf32(_split(b)[0]).astype(np.float64)


def _emulated_errors(mm, causal):
    """Worst max|dO| / max|O| and max|dlse| of fp32 attention with both
    products taken as `mm`, against float64, over 8 seeds at (2, 2, 300,
    64)."""
    b, h, t, d = 2, 2, 300, 64
    qk_scale = 0.125 * 1.44269504
    worst_o = worst_lse = 0.0
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        q, k, v = (rng.standard_normal((b, h, t, d), np.float32) for _ in range(3))
        qs = (q * np.float32(qk_scale)).astype(np.float32)
        mask = np.tril(np.ones((t, t), bool)) if causal else np.ones((t, t), bool)
        ref, emu = {}, {}
        for name, s_ in (("f64", qs.astype(np.float64) @ np.swapaxes(k, -1, -2).astype(np.float64)),
                         ("emu", mm(qs, np.swapaxes(k, -1, -2)).astype(np.float32))):
            s_ = np.where(mask, s_, -30000.0)
            m = s_.max(-1, keepdims=True) + 1.0 / 256
            p = np.where(mask, np.exp2(s_ - m), 0.0)
            if name == "f64":
                l = p.sum(-1, keepdims=True)
                ref = ((p @ v.astype(np.float64)) / l, (m + np.log2(l))[..., 0])
            else:
                p = p.astype(np.float32)
                l = p.sum(-1, keepdims=True, dtype=np.float64)
                emu = (mm(p, v) / l, (m + np.log2(l))[..., 0])
        worst_o = max(worst_o, np.abs(emu[0] - ref[0]).max() / np.abs(ref[0]).max())
        worst_lse = max(worst_lse, np.abs(emu[1] - ref[1]).max())
    return worst_o, worst_lse


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_emulation_keeps_fp32_accuracy(causal):
    worst_o, worst_lse = _emulated_errors(_mm3, causal)
    assert worst_o <= 1e-5 and worst_lse <= 1e-5, (worst_o, worst_lse)


@pytest.mark.parametrize("causal", [False, True])
def test_1xtf32_emulation_does_not(causal):
    """The split is what keeps the accuracy: the big terms alone are more
    than ten times further off."""
    assert max(_emulated_errors(_mm1, causal)) > 1e-4


# --------------------------------------------------------------------------
# B11 fast
# --------------------------------------------------------------------------

def _walk(t, s, causal):
    """(key, position) pairs every B11 fast block computes, as the kernel
    walks: block y takes keys y * 128 .. + 127, the q tiles from
    first_q_tile on, each tile's 32 positions."""
    pairs = []
    _, n_kt = jvp_tiling.dkv_grid(1, t, s)
    n_qt = -(-t // jvp_tiling.Q_ROWS)
    for y in range(n_kt):
        k0 = y * jvp_tiling.DKV_KEYS
        keys = np.arange(k0, min(k0 + jvp_tiling.DKV_KEYS, s))
        for j in range(jvp_tiling.first_q_tile(k0, t, causal), n_qt):
            pos = np.arange(j * jvp_tiling.Q_ROWS, min((j + 1) * jvp_tiling.Q_ROWS, t))
            kk, pp = np.meshgrid(keys, pos, indexing="ij")
            pairs.append(np.stack([kk.ravel(), pp.ravel()], 1))
    return np.concatenate(pairs) if pairs else np.zeros((0, 2), int)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t, s", [(1, 1), (33, 130), (77, 201), (128, 128), (200, 330),
                                  (330, 200), (300, 300), (1024, 1024)])
def test_dkv_walk_covers_every_visible_pair_once(t, s, causal):
    pairs = _walk(t, s, causal)
    visible = {(k, p) for k in range(s) for p in range(t) if not causal or k <= p}
    walked = [tuple(x) for x in pairs]
    assert len(set(walked)) == len(walked)  # each pair once
    assert visible <= set(walked)  # every visible pair is walked
    if causal:  # a walked tile is never wholly before the block's keys
        for y in range(-(-s // jvp_tiling.DKV_KEYS)):
            k0 = y * jvp_tiling.DKV_KEYS
            j0 = jvp_tiling.first_q_tile(k0, t, causal)
            assert j0 == min(k0 // jvp_tiling.Q_ROWS, -(-t // jvp_tiling.Q_ROWS))
            assert j0 * jvp_tiling.Q_ROWS + jvp_tiling.Q_ROWS - 1 >= k0 or j0 * 32 >= t


def test_dkv_shared_memory_fits_one_block():
    n = jvp_tiling.dkv_shared_bytes()
    assert n <= flash_tiling.SMEM_LIMIT
    floor = 4 * 128 * 64 * 2 + jvp_tiling.DKV_STAGES * 4 * jvp_tiling.Q_ROWS * 64 * 2
    assert floor < n <= floor + jvp_tiling.DKV_STAGES * 512 + 2048


@pytest.mark.parametrize("t", TS)
def test_row_stride_starts_rows_on_16_bytes(t):
    ld = jvp_tiling.row_stride(t)
    assert ld >= t and ld * 4 % 16 == 0 and ld < t + 4


@pytest.mark.parametrize("bh, t, s", [(0, 8, 8), (65536, 8, 8), (1, 0, 8), (1, 8, 128 * 65535 + 1)])
def test_dkv_grid_limits_raise(bh, t, s):
    with pytest.raises(ValueError, match="kernel takes"):
        jvp_tiling.dkv_grid(bh, t, s)


def _jvp_ops(b, h, t, s, causal, seed=0):
    rng = np.random.default_rng(seed)
    q, tq, do, dto = (torch.from_numpy(rng.standard_normal((b, h, t, 64), np.float32))
                      for _ in range(4))
    k, v, tk, tv = (torch.from_numpy(rng.standard_normal((b, h, s, 64), np.float32))
                    for _ in range(4))
    fwd = attention_jvp_fwd_plain(q, k, v, tq, tk, tv, causal=causal, fast=True)
    return jvp_bwd_operands(q, k, v, tq, tk, tv, *fwd, do, dto, causal=causal, fast=True)


@pytest.mark.parametrize("t, s, causal", [(77, 201, False), (33, 130, True), (1, 1, True)])
def test_prep_plain_matches_operands(t, s, causal):
    """B11's plain prep: each operand of `jvp_bwd_operands` rounded to bf16
    (the rounding the plain fast path applies), and its row terms stacked;
    the CPU wrapper takes it and counts no launch."""
    ops = _jvp_ops(1, 2, t, s, causal)
    before = jvp_bwd_prep.launches
    (q, k, v, tq, tk, tv, do, dto), rows = jvp_bwd_prep(ops)
    assert jvp_bwd_prep.launches == before
    for got, x in zip((q, k, v, tq, tk, tv, do, dto), ops[:8]):
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert torch.equal(got.view(torch.int16), x.to(torch.bfloat16).view(torch.int16))
    assert rows.shape == (4, 2, t) and torch.equal(rows, torch.stack(ops[8:12]))
    # the plain dK/dV path on the prep's operands is the plain path itself
    widened = ops._replace(**{n: x.float() for n, x in zip(
        ("q", "k", "v", "tq", "tk", "tv", "do", "dto"), (q, k, v, tq, tk, tv, do, dto))})
    for got, want in zip(jvp_bwd_dkv_plain(widened), jvp_bwd_dkv_plain(ops)):
        assert torch.equal(got, want)
