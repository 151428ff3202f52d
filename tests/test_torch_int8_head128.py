"""PyTorch port vs the JAX package at head dim 128: the int8 family.

The same numpy inputs, drawn from a seed, go to the JAX package (Pallas
kernels in interpret mode on the CPU, as its own tests run them) and to the
port, which on CPU tensors runs its kernels' plain versions. The CUDA
kernels themselves (B4-B8 and B14 at head dim 128) are held against those
plain versions on the card by chip_smoke.py's phase 30.

Covered at head dim 128, each at the tolerance of its head-dim-64 test
(tests/test_torch_int8.py, test_torch_int8_inference.py,
test_torch_kv_caches.py, test_torch_kernels.py): the quantizers (B4's plain
version) byte for byte; B5, B7 and B8's plain versions on the JAX
package's own residuals; autograd through `sage_attention_int8` against
jax.grad; `sage_attention_int8_inference` (B6's path) against the JAX one;
the slotted and paged int8 decode plain versions (B13's and B14's) against
the JAX kernels; and a small LM with attention="int8" at 2 heads x 128: its
loss and gradients (the train step's) and its int8 prefill against the
JAX model, with the weights carried over by `params_from_jax`.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantizedattention_tpu import sage_attention_int8 as jax_sage_int8
from quantizedattention_tpu import sage_attention_int8_inference as jax_sage_inference
from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd as jax_int8_bwd
from quantizedattention_tpu.ops.int8_fwd import (
    int8_attention_fwd_from_quantized as jax_int8_fwd_from_quantized,
)
from quantizedattention_tpu.ops.int8_fwd import quantize_qkv as jax_quantize_qkv
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu.parallel import paged_cache as jpc
from quantizedattention_tpu.quantize import int8 as jq
from quantizedattention_tpu.tune.config import default_block_config
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    lm_loss,
    make_train_step,
    param_leaves,
    params_from_jax,
    prefill_batched,
    transformer_forward,
)
from quantizedattention_tpu_torch.ops import (
    int8_attention_bwd,
    int8_attention_fwd_from_quantized,
    quantize_qkv,
    sage_attention_int8,
    sage_attention_int8_inference,
)
from quantizedattention_tpu_torch.parallel import kv_cache as tkv
from quantizedattention_tpu_torch.parallel import paged_cache as tpc
from quantizedattention_tpu_torch.quantize import int8 as tq

torch.set_num_threads(2)

D = 128
# B5 plain vs the JAX kernel on the same residuals (test_torch_int8.py):
# only the summation order and where P is rounded to bf16 differ.
O_TOL, LSE_TOL = 5e-3, 1e-3
# B7/B8 plain vs the JAX kernels, max |diff| / max |JAX| per tensor
# (test_torch_int8.py): the same rounding points, another f32 order.
BWD_REL = 1e-3
# Autograd against jax.grad, relative L2 (test_torch_int8.py): k_mean's
# summation order can move a K payload entry by one step.
GRAD_REL_L2 = 1e-3
# Decode plain versions vs the Pallas kernels (test_torch_kv_caches.py).
DECODE_TOL = 5e-3
# The int8 LM (test_torch_int8.py, test_torch_int8_inference.py): loss
# relative error, each gradient's relative L2, and prefill logits.
LOSS_REL, LM_GRAD_REL_L2, LOGIT_TOL = 1e-4, 1e-2, 2e-2


def _t(a):
    """numpy (f32, bf16 or int) -> torch, keeping the dtype."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _inputs(b, h, h_kv, t, s, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, D), np.float32)
    k = rng.standard_normal((b, h_kv, s, D), np.float32) + np.float32(shift)
    v = rng.standard_normal((b, h_kv, s, D), np.float32)
    do = rng.standard_normal((b, h, t, D), np.float32)
    return q, k, v, do


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# --------------------------------------------------------------------------
# B4: the quantizers, byte for byte
# --------------------------------------------------------------------------

def _half_step_blocks():
    """[3, 256, 128]: an all-zero block (the 1e-12 scale floor), a block whose
    scale is exactly 1 (absmax 127) holding values at exact half steps
    (round half to even), and unit-normal blocks around a large mean."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((3, 256, D)).astype(np.float32) + 4.0
    x[0, :128] = 0.0
    x[1, :128] = rng.integers(-126, 126, (128, D)).astype(np.float32) + 0.5
    x[1, 0, 0] = 127.0
    x[1, 1, :6] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    return x


@pytest.mark.parametrize("with_sub", [False, True])
def test_quant_plain_matches_jax_fused_quantizer(with_sub):
    x = _half_step_blocks()
    sub = x.mean(axis=1, keepdims=True) if with_sub else None
    xi_j, s_j = jq.quantize_int8_blocks_fused(
        jnp.asarray(x), 128, sub=None if sub is None else jnp.asarray(sub), interpret=True)
    job = tq.QuantJob(_t(x), 256, 128, None if sub is None else _t(sub[:, 0]))
    ((xi_t, s_t),) = tq.quant_int8_plain([job])
    assert xi_t.shape == (3, 256, D) and s_t.shape == (3, 2)
    assert np.array_equal(xi_t.numpy(), np.asarray(xi_j))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    if not with_sub:
        assert s_t[1, 0] == 1.0
        assert xi_t[1, 1, :6].tolist() == [0, 2, 2, 0, -2, -2]


# --------------------------------------------------------------------------
# B4, B5, B7 and B8 on the same inputs as the JAX kernels
# --------------------------------------------------------------------------

CASES = [  # (b, h, h_kv, t, s, causal, K mean)
    (1, 4, 2, 256, 256, True, 0.0),     # GQA rep 2
    (1, 4, 2, 256, 256, False, 0.0),
    (1, 4, 2, 384, 384, True, 4.0),     # three K grains of 128, large K mean
    (1, 4, 2, 384, 384, False, 0.0),
    (1, 2, 2, 200, 200, True, 4.0),     # ragged: the padded K rows set the last K scale
    (1, 4, 1, 77, 201, False, 4.0),     # rep 4, odd cross length
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "h{}kv{}t{}s{}{}{}".format(
    *c[1:5], "c" if c[5] else "", "m" if c[6] else ""))
def int8_case(request):
    """Inputs, k_mean (numpy f32, handed to both sides), and the JAX side's
    residuals, O, lse and (dq, dk, dv)."""
    b, h, h_kv, t, s, causal, shift = request.param
    q, k, v, do = _inputs(b, h, h_kv, t, s, seed=1000 * t + s + h, shift=shift)
    k_mean = k.mean(axis=2, keepdims=True)
    cfg = default_block_config("int8", t, s, D)
    res = jax_quantize_qkv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg,
                           k_sub=jnp.asarray(k_mean))
    dims = (b, h, t, s, D)
    o, lse = jax_int8_fwd_from_quantized(res, dims, causal=causal, config=cfg)
    grads = jax_int8_bwd(res, jnp.asarray(k_mean), o, lse, jnp.asarray(do), dims, causal=causal)
    return {"inputs": (q, k, v, do), "k_mean": k_mean, "dims": dims, "causal": causal,
            "res": [(np.asarray(x), np.asarray(sc)) for x, sc in res],
            "o": np.asarray(o), "lse": np.asarray(lse), "grads": [np.asarray(g) for g in grads]}


def test_quantize_qkv_plain_is_byte_equal_to_jax(int8_case):
    q, k, v, _ = int8_case["inputs"]
    got = quantize_qkv(_t(q), _t(k), _t(v), k_sub=_t(int8_case["k_mean"]))
    for (x_t, s_t), (x_j, s_j) in zip(got, int8_case["res"]):
        assert x_t.shape == x_j.shape and x_t.shape[-1] == D and s_t.shape == s_j.shape
        assert np.array_equal(x_t.numpy(), x_j)
        assert np.array_equal(s_t.numpy(), s_j)


def test_int8_fwd_plain_matches_jax(int8_case):
    res = tuple((_t(x), _t(sc)) for x, sc in int8_case["res"])
    o, lse = int8_attention_fwd_from_quantized(res, int8_case["dims"], causal=int8_case["causal"])
    b, h, t, _, _ = int8_case["dims"]
    assert o.shape == (b, h, t, D) and lse.shape == (b, h, t)
    assert np.abs(o.numpy() - int8_case["o"]).max() <= O_TOL
    assert np.abs(lse.numpy() - int8_case["lse"]).max() <= LSE_TOL


def test_int8_bwd_plain_matches_jax(int8_case):
    res = tuple((_t(x), _t(sc)) for x, sc in int8_case["res"])
    got = int8_attention_bwd(res, _t(int8_case["k_mean"]), _t(int8_case["o"]),
                             _t(int8_case["lse"]), _t(int8_case["inputs"][3]),
                             int8_case["dims"], causal=int8_case["causal"])
    for g, w in zip(got, int8_case["grads"]):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= BWD_REL * np.abs(w).max()


@pytest.mark.parametrize("t", [256, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(t, causal):
    """sage_attention_int8 at (1, 4 q / 2 kv heads, t, 128): O and dQ, dK,
    dV against jax.grad of the JAX package's."""
    q, k, v, do = _inputs(1, 4, 2, t, t, seed=t + causal)
    k = k + 2.0

    def jax_loss(q_, k_, v_):
        return jnp.sum(jax_sage_int8(q_, k_, v_, causal=causal) * do)

    o_j = jax_sage_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o = sage_attention_int8(*leaves, causal=causal)
    assert np.abs(o.detach().numpy() - np.asarray(o_j)).max() <= O_TOL
    got = torch.autograd.grad((o * _t(do)).sum(), leaves)
    for g, w, x in zip(got, want, leaves):
        assert g.shape == x.shape
        assert _rel_l2(g.numpy(), w) <= GRAD_REL_L2


@pytest.mark.parametrize("causal", [False, True])
def test_sage_attention_int8_inference_matches_jax_on_bf16(causal):
    """B6's path at head dim 128 on bf16 inputs (both sides take the K mean
    in bf16), GQA rep 2, against the JAX entry point."""
    q, k, v, _ = _inputs(1, 4, 2, 256, 256, seed=11 + causal, shift=3.0)
    q, k, v = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v))
    o_j = jax_sage_inference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o = sage_attention_int8_inference(_t(q), _t(k), _t(v), causal=causal)
    assert o.dtype == torch.float32 and o.shape == (1, 4, 256, D)
    assert np.abs(o.numpy() - np.asarray(o_j)).max() <= O_TOL


# --------------------------------------------------------------------------
# B13 and B14's plain versions: the slotted and paged int8 decode
# --------------------------------------------------------------------------

LENGTHS = [0, 1, 127, 128, 300, 384]
PS = 128  # the JAX paged caches take 128-multiples


@pytest.mark.parametrize("n_q", [2, 8])
def test_decode_plain_matches_jax(n_q):
    rng = np.random.default_rng(40 + n_q)
    b, h_kv, max_len = len(LENGTHS), 2, 384
    fields = [rng.integers(-127, 128, (b, h_kv, max_len, D), dtype=np.int8),
              rng.uniform(0.002, 0.03, (b, h_kv, max_len)).astype(np.float32),
              rng.integers(-127, 128, (b, h_kv, max_len, D), dtype=np.int8),
              rng.uniform(0.002, 0.03, (b, h_kv, max_len)).astype(np.float32),
              np.asarray(LENGTHS, np.int32)]
    jc = jkv.QuantizedKVCache(*(jnp.asarray(a) for a in fields))
    tc = tkv.QuantizedKVCache(*(_t(a) for a in fields))
    q = rng.standard_normal((b, n_q, D), np.float32)
    o_j, lse_j = jkv.decode_attention(jnp.asarray(q), jc, return_lse=True)
    o_t, lse_t = tkv.decode_attention(_t(q), tc, return_lse=True)
    _assert_decode_close(o_t, lse_t, o_j, lse_j)


@pytest.mark.parametrize("n_q", [2, 8])
def test_paged_decode_plain_matches_jax(n_q):
    """The paged pool with its pages shuffled across sequences; page 0 and
    every page past a row's length hold junk payloads."""
    rng = np.random.default_rng(50 + n_q)
    n, max_pages = len(LENGTHS), 3
    n_pages = 1 + n * max_pages
    jc = jpc.init_paged_cache(2, n_pages, n, max_pages, D, PS)
    fields = [rng.integers(-128, 128, x.shape, dtype=np.int8) if x.dtype == jnp.int8
              else rng.uniform(0.002, 0.03, x.shape).astype(np.float32) for x in jc[:4]]
    assert fields[0].shape == (2, n_pages, PS, D)
    table = rng.permutation(np.arange(1, n_pages)).reshape(n, max_pages).astype(np.int32)
    for row, length in enumerate(LENGTHS):
        table[row, -(-length // PS):] = 0
    fields += [table, np.asarray(LENGTHS, np.int32)]
    jc = type(jc)(*(jnp.asarray(a) for a in fields))
    tc = tpc.PagedKVCache(*(_t(a) for a in fields))
    q = rng.standard_normal((n, n_q, D), np.float32)
    o_j, lse_j = jpc.paged_decode_attention(jnp.asarray(q), jc, return_lse=True)
    o_t, lse_t = tpc.paged_decode_attention(_t(q), tc, return_lse=True)
    _assert_decode_close(o_t, lse_t, o_j, lse_j)


def _assert_decode_close(o_t, lse_t, o_j, lse_j):
    assert o_t.shape[-1] == D
    assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= DECODE_TOL
    live = np.asarray(LENGTHS) > 0
    assert np.abs(lse_t.numpy()[live] - np.asarray(lse_j)[live]).max() <= DECODE_TOL
    assert (o_t[~torch.from_numpy(live)] == 0).all()
    assert torch.isneginf(lse_t[~torch.from_numpy(live)]).all()


# --------------------------------------------------------------------------
# An int8 LM at head dim 128: the train step's loss and gradients, prefill
# --------------------------------------------------------------------------

LM_CFG = dict(vocab_size=64, d_model=256, n_heads=2, n_kv_heads=2, head_dim=D, n_layers=2,
              max_seq=128, attention="int8")


def _flat_jax(tree):
    top = [tree[key] for key in ("embed", "unembed", "final_norm")]
    keys = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")
    return [np.asarray(x) for x in top + [layer[k] for layer in tree["layers"] for k in keys]]


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**LM_CFG)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, TransformerConfig(**LM_CFG)


def test_int8_lm_loss_and_grads_match_jax(lm):
    jcfg, jparams, cfg = lm
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 64, (2, 128)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    loss_j, grads_j = jax.value_and_grad(jtr.lm_loss)(jparams, jnp.asarray(tokens),
                                                      jnp.asarray(targets), jcfg)
    params = params_from_jax(jparams, "cpu")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm_loss(params, _t(tokens), _t(targets), cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(loss_j)) <= LOSS_REL * float(loss_j)
    for g, w in zip(grads, _flat_jax(grads_j)):
        assert g.shape == w.shape
        assert _rel_l2(g.numpy(), w) <= LM_GRAD_REL_L2


def test_int8_lm_train_step_matches_jax(lm):
    """One step of each side's make_train_step from the same params: the
    loss it returns, and the gradients it leaves, against the JAX step's loss
    and jax.grad."""
    jcfg, jparams, cfg = lm
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 64, (2, 128)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    optimizer, jstep = jtr.make_train_step(jcfg)
    _, _, loss_j = jstep(jparams, optimizer.init(jparams), jnp.asarray(tokens),
                         jnp.asarray(targets))
    grads_j = jax.grad(jtr.lm_loss)(jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    params = params_from_jax(jparams, "cpu")
    _, step = make_train_step(cfg, params)
    loss = step(_t(tokens), _t(targets))
    assert abs(loss.item() - float(loss_j)) <= LOSS_REL * float(loss_j)
    for leaf, w in zip(param_leaves(params), _flat_jax(grads_j)):
        assert _rel_l2(leaf.grad.numpy(), w) <= LM_GRAD_REL_L2


def test_int8_lm_prefill_matches_jax(lm):
    """transformer_forward's logits and the batched int8 prefill (B4 + B5's
    plain versions, then the slotted cache) against the JAX model's."""
    jcfg, jparams, cfg = lm
    tparams = params_from_jax(jparams, "cpu")
    prompt = np.random.default_rng(0).integers(0, 64, (2, 40), dtype=np.int32)
    jl = np.asarray(jtr.transformer_forward(jparams, jnp.asarray(prompt), jcfg))
    with torch.no_grad():
        tl = transformer_forward(tparams, torch.from_numpy(prompt).long(), cfg)
    assert np.abs(tl.numpy() - jl).max() <= LOGIT_TOL
    jcaches = [jkv.init_kv_cache(2, 2, 128, D) for _ in range(2)]
    jtok, jcaches = jtr.prefill_batched(jparams, jcaches, jnp.asarray(prompt), jcfg)
    tcaches = [tkv.init_kv_cache(2, 2, 128, D, "cpu") for _ in range(2)]
    ttok, tcaches = prefill_batched(tparams, tcaches, torch.from_numpy(prompt).long(), cfg)
    np.testing.assert_array_equal(np.asarray(jtok), jl[:, -1].argmax(-1))
    top2 = np.sort(jl[:, -1], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-2
    np.testing.assert_array_equal(ttok.numpy()[clear], jl[:, -1].argmax(-1)[clear])
    for tc, jc in zip(tcaches, jcaches):
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        assert tc.k_i8.shape[-1] == D
        got = tc.k_i8.float().numpy() * tc.sk.numpy()[..., None]
        want = np.asarray(jc.k_i8, np.float32) * np.asarray(jc.sk)[..., None]
        assert np.abs(got - want).max() <= 3e-2
