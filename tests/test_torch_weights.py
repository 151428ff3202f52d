"""PyTorch port vs the JAX package: weight-only int8/int4 quantized serving.

The same numpy inputs go to the JAX package (its Pallas kernels in interpret
mode on the CPU) and to the port, which on CPU tensors runs its kernels'
plain versions. The CUDA kernels B17 and B18 are held against those plain
versions on the card by chip_smoke.py.

Covered: the weight quantizers byte for byte against the JAX package's eager
ones (`quantize_weight`, `quantize_weight_int4`, `pack_int4`/`unpack_int4`,
`quantize_lm_weights` at bits 8 and 4 as its serving engine calls it, after
the bf16 cast); B17 and B18's plain versions against the JAX kernels,
including odd m/k/n and the padded contraction; `mm` against both of the
JAX package's arms, and `embedding_lookup`; `params_from_jax` on quantized leaves; the quantized LM's
prefill and decode logits against the JAX LM; and the engine with
`weight_quant` against the engine on pre-quantized params and `generate`.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.ops.int4_linear import int4_weight_matmul as jax_int4_matmul
from quantizedattention_tpu.ops.int4_linear import pack_int4 as jax_pack_int4
from quantizedattention_tpu.ops.int4_linear import unpack_int4 as jax_unpack_int4
from quantizedattention_tpu.ops.int8_linear import int8_weight_matmul as jax_int8_matmul
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu.quantize import weights as jw
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    generate,
    params_from_jax,
    prefill_batched,
    transformer_forward,
)
from quantizedattention_tpu_torch.models.transformer import _decode_logits
from quantizedattention_tpu_torch.ops import (
    int4_weight_matmul,
    int4_weight_matmul_plain,
    int8_weight_matmul,
    int8_weight_matmul_plain,
    pack_int4,
    unpack_int4,
)
from quantizedattention_tpu_torch.ops import int4_linear as t4
from quantizedattention_tpu_torch.ops import int8_linear as t8
from quantizedattention_tpu_torch.parallel.kv_cache import init_kv_cache
from quantizedattention_tpu_torch.quantize import weights as tw
from quantizedattention_tpu_torch.serve import ServingEngine

torch.set_num_threads(2)

# Kernel plain version vs the JAX kernel with an f32 output: the same bf16
# operands and f32 accumulation, only the summation order differs (the JAX
# package's own kernel test holds its kernel to 2e-4 of max|ref|,
# tests/test_int8_weights.py:54).
F32_REL = 2e-4


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _within_bf16_ulp(got, want):
    """|got - want| at most one bf16 ulp of want (f32 sums in another order
    can round to the neighbouring bf16 value)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return bool((np.abs(got - want) <= ulp).all())


def _weight(k, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n), np.float32) * np.exp(rng.standard_normal((1, n), np.float32))
    return w.astype(dtype)


# --------------------------------------------------------------------------
# The quantizers, byte for byte against the JAX package's eager ones
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("axis", [1, 0])
def test_quantize_weight_is_byte_equal_to_jax(axis, dtype):
    w = _weight(96, 200, 0, dtype)
    w[:, 3] = 0  # an all-zero column: the 1e-12 scale floor
    want = jw.quantize_weight(jnp.asarray(w), axis=axis)
    got = tw.quantize_weight(_t(w), axis=axis)
    assert got.w_i8.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.axis == axis
    np.testing.assert_array_equal(got.w_i8.numpy(), np.asarray(want.w_i8))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))


@pytest.mark.parametrize("k,n,group", [(512, 96, 128), (200, 40, 64), (1000, 30, 128)])
def test_quantize_weight_int4_is_byte_equal_to_jax(k, n, group):
    w = _weight(k, n, k + n)
    want = jw.quantize_weight_int4(jnp.asarray(w), group=group)
    got = tw.quantize_weight_int4(_t(w), group=group)
    assert (got.k, got.group, got.packed.dtype) == (k, group, torch.int8)
    assert got.shape == (k, n) and got.packed.shape == want.packed.shape
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))


def test_pack_unpack_int4_match_jax():
    rng = np.random.default_rng(1)
    w4 = rng.integers(-8, 8, (64, 24)).astype(np.int8)
    w4[:16, 0] = np.arange(-8, 8)
    w4[32:48, 0] = np.arange(-8, 8)
    packed = pack_int4(_t(w4))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack_int4(jnp.asarray(w4))))
    lo, hi = unpack_int4(packed)
    lo_j, hi_j = jax_unpack_int4(jnp.asarray(packed.numpy()))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))
    np.testing.assert_array_equal(torch.cat([lo, hi]).numpy(), w4.astype(np.int32))
    with pytest.raises(ValueError, match="even"):
        pack_int4(_t(w4[:3]))


# the serving LM (test_torch_serving.py's config)
CFG = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, n_layers=2,
           max_seq=128)


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**CFG)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    # the JAX engine's param_dtype cast, before it quantizes
    jbf16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams)
    return jcfg, jbf16, TransformerConfig(**CFG), params_from_jax(jbf16, "cpu", torch.bfloat16)


def _leaves(tree):
    top = [tree[k] for k in ("embed", "unembed", "final_norm")]
    return top + [layer[k] for layer in tree["layers"] for k in sorted(layer)]


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_lm_weights_is_byte_equal_to_jax(lm, bits):
    """As the JAX engine calls it: eagerly, on the bf16-cast params."""
    _, jbf16, _, tparams = lm
    want = jw.quantize_lm_weights(jbf16, bits=bits)
    got = tw.quantize_lm_weights(tparams, bits=bits)
    assert isinstance(got["embed"], tw.QuantizedWeight) and got["embed"].axis == 0
    for g, w in zip(_leaves(got), _leaves(want)):
        if isinstance(w, jw.QuantizedWeight4):
            assert isinstance(g, tw.QuantizedWeight4) and bits == 4
            np.testing.assert_array_equal(g.packed.numpy(), np.asarray(w.packed))
        elif isinstance(w, jw.QuantizedWeight):
            assert isinstance(g, tw.QuantizedWeight)
            np.testing.assert_array_equal(g.w_i8.numpy(), np.asarray(w.w_i8))
        else:
            np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))
            continue
        assert g.scale.dtype == torch.float32
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    with pytest.raises(ValueError, match="bits"):
        tw.quantize_lm_weights(tparams, bits=2)


# --------------------------------------------------------------------------
# B17 and B18: plain versions against the JAX kernels
# --------------------------------------------------------------------------

MATMUL_SHAPES = [(1, 128, 128), (5, 1000, 300), (8, 1024, 512), (64, 256, 384)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_int8_matmul_plain_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k), np.float32)
    qw = tw.quantize_weight(_t(_weight(k, n, k)))
    w_i8, scale = jnp.asarray(qw.w_i8.numpy()), jnp.asarray(qw.scale.numpy())
    want = np.asarray(jax_int8_matmul(jnp.asarray(x), w_i8, scale, out_dtype=jnp.float32))
    got = int8_weight_matmul(_t(x), qw.w_i8, qw.scale, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert np.abs(got.numpy() - want).max() <= F32_REL * np.abs(want).max()
    # the default output dtype is x's: bf16 in, bf16 out
    xb = x.astype(ml_dtypes.bfloat16)
    want_b = np.asarray(jax_int8_matmul(jnp.asarray(xb), w_i8, scale), np.float32)
    got_b = int8_weight_matmul(_t(xb), qw.w_i8, qw.scale)
    assert got_b.dtype == torch.bfloat16 and _within_bf16_ulp(_np(got_b), want_b)


INT4_SHAPES = [(1, 256, 128, 128), (5, 1000, 300, 128), (8, 1024, 512, 128), (64, 256, 96, 64)]


@pytest.mark.parametrize("m,k,n,group", INT4_SHAPES)
def test_int4_matmul_plain_matches_jax(m, k, n, group):
    rng = np.random.default_rng(m + k + n + group)
    qw = tw.quantize_weight_int4(_t(_weight(k, n, n)), group=group)
    kp = 2 * qw.packed.shape[0]
    x = np.zeros((m, kp), np.float32)
    x[:, :k] = rng.standard_normal((m, k), np.float32)  # zero-padded contraction
    packed, scale = jnp.asarray(qw.packed.numpy()), jnp.asarray(qw.scale.numpy())
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), packed, scale, group=group,
                                      out_dtype=jnp.float32))
    got = int4_weight_matmul(_t(x), qw.packed, qw.scale, group=group, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert np.abs(got.numpy() - want).max() <= F32_REL * np.abs(want).max()
    xb = x.astype(ml_dtypes.bfloat16)
    want_b = np.asarray(jax_int4_matmul(jnp.asarray(xb), packed, scale, group=group), np.float32)
    got_b = int4_weight_matmul(_t(xb), qw.packed, qw.scale, group=group)
    assert got_b.dtype == torch.bfloat16 and _within_bf16_ulp(_np(got_b), want_b)


@pytest.mark.parametrize("bits", [8, 4])
def test_mm_both_arms_match_jax(bits):
    """mm flattens leading dims (and pads the int4 contraction) for the
    kernels: within a bf16 ulp of the JAX kernel arm, and within 2e-2 of
    max|out| of the JAX dequantize-then-dot arm (via="xla", whose weights
    params_from_jax carries into the same kernels)."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((4, 7, 200), np.float32).astype(ml_dtypes.bfloat16)
    w = _weight(200, 256, 5)
    jq = jw.quantize_weight(jnp.asarray(w)) if bits == 8 else \
        jw.quantize_weight_int4(jnp.asarray(w))
    tq_ = tw.quantize_weight(_t(w)) if bits == 8 else tw.quantize_weight_int4(_t(w))
    got = tw.mm(_t(x), tq_)
    assert got.shape == (4, 7, 256) and got.dtype == torch.bfloat16
    want = np.asarray(jw.mm(jnp.asarray(x), jq), np.float32)
    assert _within_bf16_ulp(_np(got), want)
    want_xla = np.asarray(jw.mm(jnp.asarray(x), jq, via="xla"), np.float32)
    assert np.abs(_np(got) - want_xla).max() <= 2e-2 * np.abs(want_xla).max()
    plain = torch.from_numpy(w)
    assert torch.equal(tw.mm(_t(x).float(), plain), _t(x).float() @ plain)


def test_embedding_lookup_matches_jax():
    e = _weight(64, 32, 6)
    toks = np.array([[0, 3], [63, 1]])
    jq = jw.quantize_weight(jnp.asarray(e), axis=0)
    tq_ = tw.quantize_weight(_t(e), axis=0)
    got = tw.embedding_lookup(tq_, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, 32)
    want = np.asarray(jw.embedding_lookup(jq, jnp.asarray(toks)), np.float32)
    np.testing.assert_array_equal(_np(got), want)
    with pytest.raises(ValueError, match="per-row"):
        tw.embedding_lookup(tw.quantize_weight(_t(e), axis=1), torch.from_numpy(toks))


def test_params_from_jax_carries_quantized_leaves(lm):
    """QuantizedWeight / QuantizedWeight4 leaves cross as the same int8 and
    f32 arrays with their static fields (not `via`: the port's quantized
    matmuls always run its kernels); nothing is re-quantized."""
    _, jbf16, _, _ = lm
    for bits in (8, 4):
        jq = jw.quantize_lm_weights(jbf16, bits=bits, via="xla" if bits == 4 else "pallas")
        tq_ = params_from_jax(jq, "cpu", torch.bfloat16)
        for g, w in zip(_leaves(tq_), _leaves(jq)):
            if isinstance(w, jw.QuantizedWeight4):
                assert isinstance(g, tw.QuantizedWeight4)
                assert (g.k, g.group) == (w.k, w.group) == (w.k, 128) and w.via == "xla"
                assert not hasattr(g, "via")
                np.testing.assert_array_equal(g.packed.numpy(), np.asarray(w.packed))
            elif isinstance(w, jw.QuantizedWeight):
                assert isinstance(g, tw.QuantizedWeight) and g.axis == w.axis
                np.testing.assert_array_equal(g.w_i8.numpy(), np.asarray(w.w_i8))
            else:
                assert g.dtype == torch.bfloat16
                continue
            assert g.scale.dtype == torch.float32
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))


# --------------------------------------------------------------------------
# The quantized LM against the JAX one, and the engine
# --------------------------------------------------------------------------

# Logits of the quantized LM against the JAX one on the same (converted)
# quantized params, both in bf16 activations: the kernels agree to a bf16
# ulp per projection, and the attention's bf16-P rounding differs as in the
# bf16 serving tests; through two layers that is a few bf16 ulps of O(1)
# logits.
QLOGIT_TOL = 5e-2


def _jax_decode_logits(params, caches, last_tok, pos, active, cfg):
    """One JAX decode step up to its logits, composed of the JAX package's own
    functions (as test_torch_serving.py does)."""
    x = jw.embedding_lookup(params["embed"], last_tok)[:, None, :]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = jtr.rmsnorm(x, layer["ln1"])
        q, k, v = jtr._project_qkv(layer, h, cfg, pos[:, None])
        cache = jkv.append_kv(cache, k, v, active=active)
        o = jkv.decode_attention(q[:, :, 0, :], cache)
        o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim)
        x = jtr._mlp_residual(layer, x + jw.mm(o.astype(x.dtype), layer["wo"]))
        new_caches.append(cache)
    x = jtr.rmsnorm(x, params["final_norm"])
    return jw.mm(x[:, 0], params["unembed"]), new_caches


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_lm_prefill_and_decode_match_jax(lm, bits):
    jcfg, jbf16, cfg, _ = lm
    jq = jw.quantize_lm_weights(jbf16, bits=bits)
    tq_ = params_from_jax(jq, "cpu", torch.bfloat16)
    rng = np.random.default_rng(bits)
    prompt = rng.integers(0, 64, (2, 20), dtype=np.int32)
    jl = np.asarray(jtr.transformer_forward(jq, jnp.asarray(prompt), jcfg), np.float32)
    with torch.no_grad():
        tl = transformer_forward(tq_, torch.from_numpy(prompt).long(), cfg)
    assert tl.dtype == torch.bfloat16
    assert np.abs(_np(tl) - jl).max() <= QLOGIT_TOL
    # decode: two teacher-forced steps after the same prefill
    jcaches = [jkv.init_kv_cache(2, 2, 128, 64) for _ in range(2)]
    _, jcaches = jtr.prefill_batched(jq, jcaches, jnp.asarray(prompt), jcfg)
    tcaches = [init_kv_cache(2, 2, 128, 64, "cpu") for _ in range(2)]
    _, tcaches = prefill_batched(tq_, tcaches, torch.from_numpy(prompt).long(), cfg)
    active = np.array([True, True])
    for step, tok in enumerate(rng.integers(0, 64, (2, 2), dtype=np.int32)):
        pos = np.full((2,), 20 + step, np.int32)
        jd, jcaches = _jax_decode_logits(jq, jcaches, jnp.asarray(tok), jnp.asarray(pos),
                                         jnp.asarray(active), jcfg)
        td, tcaches = _decode_logits(tq_, tcaches, torch.from_numpy(tok).long(),
                                     torch.from_numpy(pos).long(), torch.from_numpy(active), cfg)
        assert np.abs(_np(td) - np.asarray(jd, np.float32)).max() <= QLOGIT_TOL, f"step {step}"


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_engine_weight_quant_matches_prequantized_and_generate(lm, weight_quant):
    """ServingEngine(weight_quant=...) == the engine on quantize_lm_weights
    of the same params == generate on them, token for token (the JAX test's
    design, tests/test_int8_weights.py:204-246); the payloads keep their
    dtypes through the engine's move."""
    _, _, cfg, tparams = lm
    bits = 4 if weight_quant == "int4" else 8
    prompts = [[1, 2, 3, 4, 5], [7, 6, 5], [9, 9, 9, 1]]

    def run(p, **kw):
        eng = ServingEngine(p, cfg, "cpu", n_slots=2, scheduler="python", decode_horizon=2, **kw)
        rids = [eng.submit(x, 6) for x in prompts]
        res = eng.run()
        return eng, [res[r].tokens for r in rids]

    before = (int8_weight_matmul.launches, int4_weight_matmul.launches)
    eng, auto = run(tparams, param_dtype=torch.bfloat16, weight_quant=weight_quant)
    qtype = tw.QuantizedWeight4 if bits == 4 else tw.QuantizedWeight
    assert isinstance(eng.params["layers"][0]["wq"], qtype)
    assert eng.params["embed"].w_i8.dtype == torch.int8
    assert eng.params["unembed"].scale.dtype == torch.float32
    qparams = tw.quantize_lm_weights(tparams, bits=bits)
    _, manual = run(qparams, param_dtype=torch.bfloat16)
    assert auto == manual
    for p, toks in zip(prompts, auto):
        want = generate(qparams, torch.tensor([p]), cfg, max_new_tokens=6)
        assert toks == want[0, len(p):].tolist()
    # on the CPU the wrappers ran their plain versions: no launch counted
    assert (int8_weight_matmul.launches, int4_weight_matmul.launches) == before
    with pytest.raises(ValueError, match="weight_quant"):
        ServingEngine(tparams, cfg, "cpu", weight_quant="fp4")


# --------------------------------------------------------------------------
# Wrappers: no fallback
# --------------------------------------------------------------------------

def test_weight_kernel_paths_check_their_arguments_and_never_fall_back():
    x = torch.randn(8, 256)
    qw = tw.quantize_weight(torch.randn(256, 64))
    q4 = tw.quantize_weight_int4(torch.randn(256, 64))
    with pytest.raises(ValueError, match="CUDA"):
        t8._launch_args(x, qw.w_i8, qw.scale, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        t4._launch_args(x, q4.packed, q4.scale, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="output"):
        t8._launch_args(x, qw.w_i8, qw.scale, torch.int32)
    with pytest.raises(ValueError, match="multiple of 64"):
        t4._launch_args(x, q4.packed, q4.scale, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        int8_weight_matmul(x[:, :100], qw.w_i8, qw.scale)
    with pytest.raises(ValueError, match="shape mismatch"):
        int4_weight_matmul(x, q4.packed, q4.scale[:1], group=128)
    before = (int8_weight_matmul.launches, int4_weight_matmul.launches)
    assert torch.equal(int8_weight_matmul(x, qw.w_i8, qw.scale),
                       int8_weight_matmul_plain(x, qw.w_i8, qw.scale))
    assert torch.equal(int4_weight_matmul(x, q4.packed, q4.scale),
                       int4_weight_matmul_plain(x, q4.packed, q4.scale))
    assert (int8_weight_matmul.launches, int4_weight_matmul.launches) == before
