"""PyTorch port vs the JAX package: attention kernels' plain versions and
the int8 KV-cache writes.

The same numpy inputs (np.random.default_rng) go to the JAX function (Pallas
kernels in interpret mode on the CPU, as the JAX package's own tests run
them) and to its counterpart in quantizedattention_tpu_torch, which on CPU
tensors runs the kernel's plain PyTorch version. The CUDA kernels themselves
are checked against those plain versions on the card by chip_smoke.py.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu.ops.common import tile_mask as jax_tile_mask
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd as jax_flash_fwd
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu_torch.ops import (
    flash_attention_bf16,
    flash_attention_fwd,
    pad_tokens,
    qk_scales,
    tile_mask,
)
from quantizedattention_tpu_torch.parallel import kv_cache as tkv

torch.set_num_threads(2)

# Only summation order and the place where P is rounded to bf16 differ
# between the tiled JAX kernel and the whole-row plain version, which can
# flip a P entry across a bf16 rounding boundary: O moves by a few 1e-3 at
# most on unit-normal inputs, lse (a log of a sum) by far less.
O_TOL, LSE_TOL = 5e-3, 1e-3
DECODE_TOL = 5e-3


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ids(cases):
    """pytest's own ids for the head-dim-64 cases; the others end in -d<d>."""
    return ["-".join(map(str, c[:-1])) + ("" if c[-1] == 64 else f"-d{c[-1]}") for c in cases]


FWD_CASES = [  # (b, h, h_kv, t, s, causal, head_dim)
    (1, 2, 2, 128, 128, True, 64),    # rep 1
    (1, 4, 2, 128, 128, True, 64),    # GQA rep 2
    (2, 4, 1, 96, 96, True, 64),      # GQA rep 4, ragged t
    (1, 4, 2, 77, 201, False, 64),    # odd cross length
    (1, 2, 1, 77, 77, True, 64),      # ragged causal
    (1, 2, 2, 128, 128, True, 128),   # head dim 128: rep 1
    (2, 4, 1, 96, 96, True, 128),     # GQA rep 4, ragged t
    (1, 4, 2, 77, 201, False, 128),   # odd cross length
]


@pytest.mark.parametrize("b,h,h_kv,t,s,causal,d", FWD_CASES, ids=_ids(FWD_CASES))
def test_flash_fwd_plain_matches_jax(b, h, h_kv, t, s, causal, d):
    rng = np.random.default_rng(1000 * t + s + h)
    q = rng.standard_normal((b, h, t, d), np.float32)
    k = rng.standard_normal((b, h_kv, s, d), np.float32)
    v = rng.standard_normal((b, h_kv, s, d), np.float32)
    o_j, lse_j = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o_t, lse_t = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    assert o_t.dtype == torch.float32 and o_t.shape == (b, h, t, d)
    assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= O_TOL
    assert np.abs(lse_t.numpy() - np.asarray(lse_j)).max() <= LSE_TOL


def test_flash_wrapper_cpu_uses_plain_and_counts_nothing():
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.standard_normal((1, 2, 16, 64), np.float32)) for _ in range(3))
    before = flash_attention_fwd.launches
    o = flash_attention_bf16(q, k, v, causal=True)
    assert torch.isfinite(o).all()
    assert flash_attention_fwd.launches == before
    with pytest.raises(ValueError, match="correction"):
        flash_attention_fwd(q, k, v, correction="gamma")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1))


def test_flash_bf16_gradients_flow():
    rng = np.random.default_rng(2)
    q, k, v = (_t(rng.standard_normal((1, 2, 8, 64), np.float32)).requires_grad_(True)
               for _ in range(3))
    o = flash_attention_bf16(q, k, v, causal=True)
    assert o.requires_grad
    o.square().sum().backward()
    for x in (q, k, v):
        assert x.grad is not None and x.grad.shape == x.shape and x.grad.dtype == x.dtype
        assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_start,k_start,kv_len", [(0, 0, 40), (32, 16, 20), (5, 0, 64)])
def test_tile_mask_matches_jax(q_start, k_start, kv_len, causal):
    want = np.asarray(jax_tile_mask(q_start, k_start, 16, 32, kv_len, causal))
    got = tile_mask(q_start, k_start, 16, 32, kv_len, causal).numpy()
    np.testing.assert_array_equal(got, want)


def test_qk_scales_and_pad_tokens():
    assert qk_scales(64, None) == pytest.approx((0.125, 0.125 * 1.44269504))
    x = torch.ones((2, 5, 3))
    y = pad_tokens(x, 4, 1)
    assert y.shape == (2, 8, 3) and y[:, 5:].abs().sum() == 0 and y[:, :5].eq(1).all()
    assert pad_tokens(x, 5, 1) is x


# --------------------------------------------------------------------------
# int8 KV cache
# --------------------------------------------------------------------------

def _random_cache(rng, b, h_kv, max_len, d, lengths):
    k_i8 = rng.integers(-127, 128, (b, h_kv, max_len, d), dtype=np.int8)
    v_i8 = rng.integers(-127, 128, (b, h_kv, max_len, d), dtype=np.int8)
    sk = rng.uniform(0.002, 0.03, (b, h_kv, max_len)).astype(np.float32)
    sv = rng.uniform(0.002, 0.03, (b, h_kv, max_len)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    jc = jkv.QuantizedKVCache(*(jnp.asarray(a) for a in (k_i8, sk, v_i8, sv, length)))
    tc = tkv.QuantizedKVCache(*(torch.from_numpy(a.copy()) for a in (k_i8, sk, v_i8, sv, length)))
    return jc, tc


DECODE_CASES = [(2, 2, 64), (4, 2, 64), (8, 2, 64),
                (4, 2, 128)]  # head dim 128 with GQA, as the JAX package's test_kv_cache.py


@pytest.mark.parametrize("n_q,h_kv,d", DECODE_CASES, ids=_ids(DECODE_CASES))
def test_decode_plain_matches_jax(n_q, h_kv, d):
    rng = np.random.default_rng(n_q + d - 64)
    lengths = [0, 1, 127, 256]
    jc, tc = _random_cache(rng, 4, h_kv, 256, d, lengths)
    q = rng.standard_normal((4, n_q, d), np.float32)
    o_j, lse_j = jkv.decode_attention(jnp.asarray(q), jc, return_lse=True)
    o_t, lse_t = tkv.decode_attention(_t(q), tc, return_lse=True)
    assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= DECODE_TOL
    live = np.asarray(lengths) > 0
    assert np.abs(lse_t.numpy()[live] - np.asarray(lse_j)[live]).max() <= DECODE_TOL
    # length 0: O = 0 and lse = -inf, in both packages
    assert (o_t[0] == 0).all() and torch.isneginf(lse_t[0]).all()
    assert np.isneginf(np.asarray(lse_j)[0]).all()


def test_decode_plain_ignores_stale_entries_past_length():
    """Non-finite scales and junk payloads past a row's length must not
    reach the output (0 * NaN would)."""
    rng = np.random.default_rng(7)
    _, clean = _random_cache(rng, 3, 2, 128, 64, [1, 50, 128])
    stale = tkv.QuantizedKVCache(*(x.clone() for x in clean))
    for row, n in enumerate([1, 50, 128]):
        stale.sk[row, :, n:] = float("nan")
        stale.sv[row, :, n:] = float("inf")
        stale.k_i8[row, :, n:] = 127
    q = _t(rng.standard_normal((3, 4, 64), np.float32))
    o_clean = tkv.decode_attention(q, clean)
    o_stale = tkv.decode_attention(q, stale)
    assert torch.isfinite(o_stale).all()
    torch.testing.assert_close(o_stale, o_clean, rtol=0, atol=0)


def _assert_cache_equal(tc, jc):
    """The JAX cache writers run under jit (absmax * f32(1/127)): the port's
    payloads, scales and lengths equal theirs byte for byte."""
    for got, want in zip(tc, jc):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t_new,use_active", [(1, False), (1, True), (5, False), (200, False)])
def test_append_kv_matches_jax(t_new, use_active):
    rng = np.random.default_rng(t_new)
    b, h_kv, max_len, d = 4, 2, 256, 64
    lengths = [0, 3, 100, 255]  # the last overflows for t_new > 1: write shifts left
    jc = jkv.init_kv_cache(b, h_kv, max_len, d)._replace(length=jnp.asarray(lengths, jnp.int32))
    tc = tkv.init_kv_cache(b, h_kv, max_len, d, "cpu")
    tc.length.copy_(torch.tensor(lengths, dtype=torch.int32))
    k = rng.standard_normal((b, h_kv, t_new, d), np.float32)
    v = rng.standard_normal((b, h_kv, t_new, d), np.float32)
    active = np.asarray([True, False, True, True]) if use_active else None
    jc = jkv.append_kv(jc, jnp.asarray(k), jnp.asarray(v),  # jitted in the JAX package
                       active=None if active is None else jnp.asarray(active))
    tc = tkv.append_kv(tc, _t(k), _t(v), active=None if active is None else _t(active))
    _assert_cache_equal(tc, jc)


@pytest.mark.parametrize("t,true_len", [(16, 9), (128, 128), (300, 256)])
def test_write_kv_slot_matches_jax(t, true_len):
    rng = np.random.default_rng(t)
    b, h_kv, max_len, d = 3, 2, 256, 64
    jc = jkv.init_kv_cache(b, h_kv, max_len, d)
    tc = tkv.init_kv_cache(b, h_kv, max_len, d, "cpu")
    write = jax.jit(jkv.write_kv_slot)  # it runs inside the jitted prefills
    for slot in (2, 0):
        k = rng.standard_normal((h_kv, t, d), np.float32)
        v = rng.standard_normal((h_kv, t, d), np.float32)
        jc = write(jc, jnp.int32(slot), jnp.asarray(k), jnp.asarray(v), jnp.int32(true_len))
        tc = tkv.write_kv_slot(tc, slot, _t(k), _t(v), true_len)
    _assert_cache_equal(tc, jc)


def test_row_quant_matches_jax():
    """Byte-equal to the jitted quantizer, whose scales differ from eager
    JAX's division on a few percent of rows."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 256, 64), np.float32)
    x[0, 0, 0] = 0.0  # all-zero row: the 1e-12 scale floor
    q_j, s_j = jax.jit(jkv._row_quant)(jnp.asarray(x))
    q_t, s_t = tkv._row_quant(_t(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert q_t.abs().max() <= 127
    _, s_eager = jkv._row_quant(jnp.asarray(x))
    assert (np.asarray(s_eager) != np.asarray(s_j)).any()  # the gap this test closes


# --------------------------------------------------------------------------
# Package boundary
# --------------------------------------------------------------------------

PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / "quantizedattention_tpu_torch"


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) >= 10
    names = {str(f.relative_to(PORT_DIR)) for f in files}
    assert {"ops/int8_fwd.py", "ops/int8_bwd.py", "quantize/int8.py", "quantize/smoothing.py",
            "tune/config.py", "ops/int8_linear.py", "ops/int4_linear.py",
            "quantize/weights.py"} <= names
    # the smoke run on the card stands alone too
    files.append(PORT_DIR.parent / "chip_smoke.py")
    bad = {str(f): sorted(_imported_roots(f) & {"jax", "jaxlib", "quantizedattention_tpu"})
           for f in files}
    assert not {f: r for f, r in bad.items() if r}
