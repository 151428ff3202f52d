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

B9 fast and B12 fast (csrc/jvp.cu): their 128-row blocks and the key
tiles they walk (64 keys for B9, 32 for B12) cover every visible (position,
key) pair exactly once, and causal blocks stop at their last visible tile; their shared memory fits an
H100; their grids' limits raise. B9's K-side prep (plain) is .to(bfloat16)
of the model's transposed views, laid out contiguous; on the CPU,
`attention_jvp_bwd`'s fast route through one shared prep gives the separate
plain calls' results bit for bit. A numpy emulation of B9 fast's tiled
online softmax (P and H rounded to bf16 against the running max of 64-key
tiles, the kernel's, and of 32-key ones) stays within chip_smoke.py's
JVP_FWD_FAST_TOL (5e-3) of the plain version on causal and ragged cases:
the tile width's effect on the rounding, answered before the card.

B10 exact (csrc/jvp.cu, 3xTF32): its 128-row blocks and the ranges of
32-key tiles they split the keys into cover every visible (position, key)
pair exactly once, causal and not, split or not; the keys are split only
where the q blocks alone fill fewer SMs than the card has; its shared memory
fits an H100 and its grid's limits raise; its prep (plain) is B1 fp32's
K/V split of both pairs; and a numpy emulation of its five products as
3xTF32 keeps tO within 1e-5 of max|float64| where the big terms alone
(1xTF32) are more than 1e-4 off.
"""

import numpy as np
import pytest
import torch

from quantizedattention_tpu_torch.ops import flash_tiling, jvp_tiling
from quantizedattention_tpu_torch.ops.flash_fwd import kv_split_tf32_plain, tf32_split
from quantizedattention_tpu_torch.ops.jvp_bwd import (
    attention_jvp_bwd,
    jvp_bwd_dkv,
    jvp_bwd_dkv_plain,
    jvp_bwd_dq,
    jvp_bwd_dq_plain,
    jvp_bwd_operands,
    jvp_bwd_prep,
    jvp_bwd_prep_plain,
)
from quantizedattention_tpu_torch.ops.jvp_fwd import (
    attention_jvp_fwd_plain,
    jvp_fwd_prep,
    jvp_fwd_prep_plain,
)

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
    n = flash_tiling.fp32_shared_bytes(64)
    assert n <= flash_tiling.SMEM_LIMIT
    # Q small of two warpgroups and the ring of K big/small, V^T big/small alone
    floor = 128 * 64 * 4 + flash_tiling.fp32_stages(64) * 4 * flash_tiling.fp32_keys(64) * 64 * 4
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
    n = jvp_tiling.dkv_shared_bytes(64)
    assert n <= flash_tiling.SMEM_LIMIT
    floor = 4 * 128 * 64 * 2 + jvp_tiling.dkv_stages(64) * 4 * jvp_tiling.Q_ROWS * 64 * 2
    assert floor < n <= floor + jvp_tiling.dkv_stages(64) * 512 + 2048


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


# --------------------------------------------------------------------------
# B9 fast and B12 fast
# --------------------------------------------------------------------------

JVP_FWD_FAST_TOL = 5e-3  # chip_smoke.py's B9 fast gate, max|diff| / max|plain| (lse: max|diff|)
QB_SHAPES = [(1, 1), (1, 300), (300, 1), (33, 130), (77, 201), (128, 128), (129, 31),
             (200, 330), (330, 200), (300, 300), (1024, 1024), (4096, 64)]


def _q_block_walk(t, s, causal, width):
    """(position, key) pairs every B9 / B12 fast block computes, as the
    kernels walk: grid row y takes positions block_rows(y) .. + 127 and the
    key tiles 0 .. key_tiles - 1, each `width` keys."""
    pairs = []
    _, n_qb = jvp_tiling.q_blocks(3, t)
    for y in range(n_qb):
        q0 = jvp_tiling.block_rows(y, n_qb)
        pos = np.arange(q0, min(q0 + jvp_tiling.Q_BLOCK, t))
        n_kt = jvp_tiling.key_tiles(q0, t, s, causal, width)
        keys = np.arange(0, min(n_kt * width, s))
        pp, kk = np.meshgrid(pos, keys, indexing="ij")
        pairs.append(np.stack([pp.ravel(), kk.ravel()], 1))
        last_seen = min(t - 1, q0 + jvp_tiling.Q_BLOCK - 1) if causal else s - 1
        assert (n_kt - 1) * width <= last_seen  # the last walked tile holds a key a row sees
        assert n_kt * width >= s or n_kt * width > last_seen  # the next would hold none
    return np.concatenate(pairs)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t, s", QB_SHAPES)
@pytest.mark.parametrize("width", [jvp_tiling.fwd_keys(64), jvp_tiling.DQ_KEYS], ids=["b9", "b12"])
def test_q_block_walk_covers_every_visible_pair_once(width, t, s, causal):
    """B9 fast (fwd_keys(64)-key tiles) and B12 fast (DQ_KEYS) walk every
    visible pair once, the blocks with the most key tiles first."""
    pairs = _q_block_walk(t, s, causal, width)
    walked = [tuple(x) for x in pairs]
    assert len(set(walked)) == len(walked)
    visible = {(p, k) for p in range(t) for k in range(s) if not causal or k <= p}
    assert visible <= set(walked)
    _, n_qb = jvp_tiling.q_blocks(3, t)
    tiles = [jvp_tiling.key_tiles(jvp_tiling.block_rows(y, n_qb), t, s, causal, width)
             for y in range(n_qb)]
    assert tiles == sorted(tiles, reverse=True)


@pytest.mark.parametrize("shared_bytes, resident", [
    (jvp_tiling.fwd_shared_bytes, 2 * 128 * 64 * 2 + jvp_tiling.FWD_STAGES * 4 * 64 * 64 * 2),
    (jvp_tiling.dq_shared_bytes, 4 * 128 * 64 * 2 + jvp_tiling.dq_stages(64) * 4 * 32 * 64 * 2)],
    ids=["b9", "b12"])
def test_q_block_shared_memory_fits_one_block(shared_bytes, resident):
    n = shared_bytes(64)
    assert resident < n <= resident + 2048
    assert n <= flash_tiling.SMEM_LIMIT


@pytest.mark.parametrize("bh, t", [(0, 10), (65536, 10), (1, 0), (1, 128 * 65535 + 1)])
def test_q_blocks_limits_raise(bh, t):
    with pytest.raises(ValueError, match="kernel takes"):
        jvp_tiling.q_blocks(bh, t)


@pytest.mark.parametrize("bh, s", [(0, 8), (65536, 8), (1, 0)])
def test_fwd_prep_grid_limits_raise(bh, s):
    with pytest.raises(ValueError, match="kernel takes"):
        jvp_tiling.fwd_prep_grid(bh, s, 64)


@pytest.mark.parametrize("s", [1, 31, 257])
def test_fwd_prep_plain_is_bf16_of_the_views(s):
    """B9's K-side prep on the DiT's [b, h, s, d] views of [b, s, h, d]
    storage: each operand .to(bfloat16), laid out contiguous [b * h, s, d];
    the CPU wrapper takes it and counts no launch."""
    gen = torch.Generator().manual_seed(s)
    views = [torch.randn((2, s, 3, 64), generator=gen).transpose(1, 2) for _ in range(4)]
    assert s == 1 or not views[0].is_contiguous()
    before = jvp_fwd_prep.launches
    got = jvp_fwd_prep(*views)
    assert jvp_fwd_prep.launches == before
    assert jvp_tiling.fwd_prep_grid(6, s, 64) == (-(-s // 256), 6, 4)
    for g, x, w in zip(got, views, jvp_fwd_prep_plain(*views)):
        assert g.dtype == torch.bfloat16 and g.shape == (6, s, 64) and g.is_contiguous()
        want = x.to(torch.bfloat16).reshape(6, s, 64)
        assert torch.equal(g.view(torch.int16), want.view(torch.int16))
        assert torch.equal(w.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("t, s, causal", [(77, 201, False), (33, 130, True), (1, 1, True),
                                          (130, 33, True)])
def test_shared_prep_route_matches_separate_plain_calls(t, s, causal):
    """attention_jvp_bwd in fast mode runs one prep for B11 and B12; on the
    CPU that route (the plain versions on the plain prep's operands) gives
    the separate plain calls' results bit for bit, and launches nothing."""
    rng = np.random.default_rng(t + s)
    q, tq, do, dto = (torch.from_numpy(rng.standard_normal((1, 2, t, 64), np.float32))
                      for _ in range(4))
    k, v, tk, tv = (torch.from_numpy(rng.standard_normal((1, 2, s, 64), np.float32))
                    for _ in range(4))
    fwd = attention_jvp_fwd_plain(q, k, v, tq, tk, tv, causal=causal, fast=True)
    counts = [fn.launches for fn in (jvp_bwd_prep, jvp_bwd_dkv, jvp_bwd_dq)]
    got = attention_jvp_bwd(q, k, v, tq, tk, tv, *fwd, do, dto, causal=causal, fast=True)
    assert [fn.launches for fn in (jvp_bwd_prep, jvp_bwd_dkv, jvp_bwd_dq)] == counts
    ops = jvp_bwd_operands(q, k, v, tq, tk, tv, *fwd, do, dto, causal=causal, fast=True)
    dk, dv, dtk, dtv = jvp_bwd_dkv_plain(ops)
    dq, dtq = jvp_bwd_dq_plain(ops)
    for g, w in zip(got, (dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(k.shape),
                          dtq.reshape(q.shape), dtk.reshape(k.shape), dtv.reshape(k.shape))):
        assert torch.equal(g, w)


def _bf16(x):
    """x rounded to bf16 (nearest even) and back, in numpy."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)).view(np.float32)


def _b9_fast_emulated(q, k, v, tq, tk, tv, causal, keys):
    """B9 fast's arithmetic as the kernel orders it, in numpy f32: the
    operands rounded to bf16; per tile of `keys` keys the running max m, p =
    exp2(S qk_scale - m) (0 where masked) and h = p tS sm_scale, l and r
    summing the unrounded p and h, and O, A = P tV, B = H V accumulating the
    bf16-rounded P and H, all rescaled by exp2(m_old - m_new)."""
    sm_scale = np.float32(0.125)
    qk_scale = np.float32(0.125 * 1.44269504)
    qf, kf, vf, tqf, tkf, tvf = (_bf16(x) for x in (q, k, v, tq, tk, tv))
    t, s = q.shape[-2], k.shape[-2]
    sc = (qf @ np.swapaxes(kf, -1, -2)) * qk_scale
    ts = (tqf @ np.swapaxes(kf, -1, -2) + qf @ np.swapaxes(tkf, -1, -2)) * sm_scale
    valid = np.ones((t, s), bool)
    if causal:
        valid = np.arange(s)[None, :] <= np.arange(t)[:, None]
    sc = np.where(valid, sc, np.float32(-30000.0)).astype(np.float32)
    lead = q.shape[:-2]
    m = np.full(lead + (t, 1), -np.inf, np.float32)
    l, r = np.zeros(lead + (t, 1), np.float32), np.zeros(lead + (t, 1), np.float32)
    o, a, b = (np.zeros(lead + (t, 64), np.float32) for _ in range(3))
    for k0 in range(0, s, keys):
        cols = slice(k0, min(k0 + keys, s))
        new = np.maximum(m, sc[..., cols].max(-1, keepdims=True))
        alpha = np.exp2(m - new).astype(np.float32)
        m = new
        p = np.where(valid[:, cols], np.exp2(sc[..., cols] - m), 0.0).astype(np.float32)
        h = (p * ts[..., cols]).astype(np.float32)
        l = l * alpha + p.sum(-1, keepdims=True)
        r = r * alpha + h.sum(-1, keepdims=True)
        o = o * alpha + _bf16(p) @ vf[..., cols, :]
        a = a * alpha + _bf16(p) @ tvf[..., cols, :]
        b = b * alpha + _bf16(h) @ vf[..., cols, :]
    l_safe = np.where(l == 0, np.float32(1.0), l)
    o = o / l_safe
    return o, (a + b - r * o) / l_safe, (m + np.log2(l_safe))[..., 0], (r / l_safe)[..., 0]


def _b9_case(b, h, t, s, seed=0):
    rng = np.random.default_rng(seed + 1000 * t + s)
    q, tq = (rng.standard_normal((b, h, t, 64), np.float32) for _ in range(2))
    k, v, tk, tv = (rng.standard_normal((b, h, s, 64), np.float32) for _ in range(4))
    return q, k, v, tq, tk, tv


def _rel_to_plain(got, want):
    """chip_smoke.py's measure: max|diff| / max|plain| per tensor, lse by
    max|diff|."""
    return [float(np.abs(g - w.numpy()).max() / (1.0 if n == "lse" else np.abs(w.numpy()).max()))
            for n, g, w in zip(("o", "to", "lse", "mu"), got, want)]


B9_CASES = [(1, 2, 77, 201, False), (1, 2, 77, 201, True), (1, 2, 300, 300, True),
            (1, 3, 33, 130, True), (2, 2, 256, 256, False), (1, 2, 330, 200, True),
            (1, 2, 1, 1, True)]


@pytest.mark.parametrize("keys", [jvp_tiling.fwd_keys(64), 32])
@pytest.mark.parametrize("b, h, t, s, causal", B9_CASES)
def test_b9_fast_tiled_rounding_within_gate(b, h, t, s, causal, keys):
    """Rounding P and H against the running max of each key tile moves an
    entry by at most a bf16 ulp against the plain version's row max: within
    JVP_FWD_FAST_TOL at the kernel's tile width (and at 32 keys)."""
    x = _b9_case(b, h, t, s)
    want = attention_jvp_fwd_plain(*(torch.from_numpy(a) for a in x), causal=causal, fast=True)
    errs = _rel_to_plain(_b9_fast_emulated(*x, causal, keys), want)
    assert max(errs) <= JVP_FWD_FAST_TOL, errs


@pytest.mark.parametrize("causal", [False, True])
def test_b9_emulation_one_tile_is_the_plain_version(causal):
    """With one tile holding every key the emulation rounds where the plain
    version does: only the f32 summation order differs."""
    x = _b9_case(1, 2, 77, 201)
    want = attention_jvp_fwd_plain(*(torch.from_numpy(a) for a in x), causal=causal, fast=True)
    errs = _rel_to_plain(_b9_fast_emulated(*x, causal, 256), want)
    assert max(errs) <= 1e-5, errs


# --------------------------------------------------------------------------
# B10 exact: 3xTF32 q blocks over ranges of key tiles
# --------------------------------------------------------------------------

# (t, s): ragged, cross both ways, one token, one key, the dit_jvp path's,
# a length off a tile and the DiT's
TANGENT_SHAPES = [(1, 1), (1, 300), (300, 1), (33, 130), (77, 201), (129, 31), (512, 512),
                  (1000, 1000), (4096, 4096)]


def _tangent_walk(bh, t, s, causal, sms):
    """(position, key) pairs every B10 exact block computes, as the kernel
    walks: grid column x holds rows (n - 1 - x) * 128 .., range z the key
    tiles `tangent_range` gives, every visible key of each."""
    n_qb, z, per = jvp_tiling.tangent_grid(bh, t, s, sms, 64)
    assert z * per * jvp_tiling.TANGENT_KEYS >= s and (z - 1) * per * jvp_tiling.TANGENT_KEYS < s
    seen = []
    for x in range(n_qb):
        q0 = (n_qb - 1 - x) * jvp_tiling.tangent_rows(64)
        for zi in range(z):
            for tile in jvp_tiling.tangent_range(q0, zi, per, t, s, causal, 64):
                for pos in range(q0, min(q0 + jvp_tiling.tangent_rows(64), t)):
                    seen += [(pos, key) for key in range(tile * 32, min(tile * 32 + 32, s))
                             if not causal or key <= pos]
    return seen


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,s", TANGENT_SHAPES[:-1])
@pytest.mark.parametrize("sms", [1, 132])
def test_tangent_walk_covers_every_visible_pair_once(t, s, causal, sms):
    """Split or not, the blocks and key ranges cover every visible (position,
    key) pair of a head exactly once."""
    seen = _tangent_walk(1, t, s, causal, sms)
    want = [(pos, key) for pos in range(t) for key in range(s) if not causal or key <= pos]
    assert len(seen) == len(want) and sorted(seen) == want


@pytest.mark.parametrize("bh,t,s,want", [
    (16, 4096, 4096, (32, 1, 128)),   # the DiT's: 512 blocks fill the card unsplit
    (64, 4096, 4096, (32, 1, 128)),   # bench_jvp's
    (8, 512, 512, (4, 4, 4)),         # the dit_jvp path's: 32 q blocks, 4 key ranges of 4 tiles
    (2, 4096, 4096, (32, 3, 43)),     # (1, 2, 4096) as the oracle phase: 64 q blocks, 3 ranges
    (1, 1, 1, (1, 1, 1)),
])
def test_tangent_grid_splits_keys_only_to_fill_the_card(bh, t, s, want):
    assert jvp_tiling.tangent_grid(bh, t, s, 132, 64) == want


def test_tangent_shared_memory_fits_one_block():
    smem = jvp_tiling.tangent_shared_bytes(64)
    # tQ small of both warpgroups (32 KB), three 64 KB stages of eight f32 operands
    assert smem == 2 * 16384 + 3 * 65536 + 128 + 1024
    assert smem <= flash_tiling.SMEM_LIMIT


@pytest.mark.parametrize("bh,t,s", [(0, 1, 1), (65536, 1, 1), (1, 0, 1), (1, 1, 0)])
def test_tangent_grid_limits_raise(bh, t, s):
    with pytest.raises(ValueError, match="kernel takes"):
        jvp_tiling.tangent_grid(bh, t, s, 132, 64)


def test_tangent_prep_plain_is_the_split_of_both_pairs():
    """B10 exact's prep is B1 fp32's K/V split of (k, v) and of (tk, tv)."""
    from quantizedattention_tpu_torch.ops.jvp_tangent import tangent_prep, tangent_prep_plain
    rng = np.random.default_rng(3)
    k, v, tk, tv = (torch.from_numpy(rng.standard_normal((2, 3, 77, 64), np.float32))
                    for _ in range(4))
    got = tangent_prep_plain(k, v, tk, tv)
    want = (*kv_split_tf32_plain(k, v), *kv_split_tf32_plain(tk, tv))
    assert len(got) == 8 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(tangent_prep(k, v, tk, tv), got))  # CPU: plain


def _tangent_emulated_error(mm, causal):
    """Worst max|dtO| / max|tO| of B10's tangent with its five products taken
    as `mm` (p and h computed in f32 from the emulated S and tS), against
    float64, over 4 seeds at (1, 2, 300, 64); O and lse from float64."""
    b, h, t, d = 1, 2, 300, 64
    sm_scale = np.float32(0.125)
    qk_scale = np.float32(0.125 * 1.44269504)
    mask = np.tril(np.ones((t, t), bool)) if causal else np.ones((t, t), bool)
    worst = 0.0
    for seed in range(4):
        rng = np.random.default_rng(200 + seed)
        q, k, v, tq, tk, tv = (rng.standard_normal((b, h, t, d), np.float32) for _ in range(6))
        kt, tkt = np.swapaxes(k, -1, -2), np.swapaxes(tk, -1, -2)
        s64 = np.where(mask, q.astype(np.float64) @ kt * float(qk_scale), -np.inf)
        m = s64.max(-1, keepdims=True)
        l = np.exp2(s64 - m).sum(-1, keepdims=True)
        lse = (m + np.log2(l)).astype(np.float32)
        o = ((np.exp2(s64 - m) / l) @ v.astype(np.float64)).astype(np.float32)
        ref = {}
        for name, dot in (("f64", lambda a, c: a.astype(np.float64) @ c.astype(np.float64)),
                          ("emu", mm)):
            s_ = dot(q, kt)
            ts = dot(tq, kt) + dot(q, tkt)
            if name == "emu":
                s_, ts = s_.astype(np.float32), ts.astype(np.float32)
            p = np.where(mask, np.exp2(s_ * qk_scale - lse), 0.0)
            hp = p * (ts * sm_scale)
            if name == "emu":
                p, hp = p.astype(np.float32), hp.astype(np.float32)
            ref[name] = dot(hp, v) + dot(p, tv) - hp.sum(-1, keepdims=True, dtype=np.float64) * o
        worst = max(worst, np.abs(ref["emu"] - ref["f64"]).max() / np.abs(ref["f64"]).max())
    return worst


@pytest.mark.parametrize("causal", [False, True])
def test_b10_3xtf32_emulation_keeps_fp32_accuracy(causal):
    """B10 exact's design on record: its five products as 3xTF32 (the split,
    the low 13 bits of every operand dropped, the small-small term left out)
    keep tO within 1e-4 of max|float64|, and the big terms alone do not."""
    assert _tangent_emulated_error(_mm3, causal) <= 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_b10_1xtf32_emulation_does_not(causal):
    assert _tangent_emulated_error(_mm1, causal) > 1e-4
