"""PyTorch port vs the JAX package: B18 at scale groups that are not
multiples of 64, and the weight entry points' `include_embed` and `group`.

The same numpy inputs go to the JAX functions (its Pallas int4 kernel in
interpret mode on the CPU) and to the port's, which on CPU tensors run the
kernel's plain version. The CUDA kernel's ANY instances (csrc/int4_linear.cu)
are held against that plain version on the card by chip_smoke.py (phase 31).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantizedattention_tpu.models import sharded_train as jst
from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.ops.int4_linear import int4_weight_matmul as jax_int4_matmul
from quantizedattention_tpu.quantize import weights as jw
from quantizedattention_tpu_torch.models import TransformerConfig, params_from_jax
from quantizedattention_tpu_torch.models import sharded_train as tst
from quantizedattention_tpu_torch.models.transformer import transformer_forward
from quantizedattention_tpu_torch.ops import int4_weight_matmul
from quantizedattention_tpu_torch.ops import linear_tiling as lt
from quantizedattention_tpu_torch.quantize import weights as tw

torch.set_num_threads(2)

# tests/test_torch_weights.py's tolerances: an f32 output differs only in the
# order of the f32 sums (the JAX package's own kernel test, 2e-4 of max|want|);
# a bf16 output rounds that once more, so it may land one bf16 ulp away on
# top of the f32 difference, which matters only for results near 0 (as
# chip_smoke.py holds B18's bf16 outputs; small groups add many scaled
# sub-dots, so their sums cancel more). Logits: its QLOGIT_TOL.
F32_REL = 2e-4
QLOGIT_TOL = 5e-2


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _within_bf16_ulp(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return bool((np.abs(got - want) <= ulp + F32_REL * np.abs(want).max()).all())


GROUP_CASES = [  # (m, k, n, group): a group below 16, multiples of 16 but not of 64
    (8, 384, 96, 8), (8, 1000, 40, 32), (70, 256, 130, 32), (8, 384, 96, 96),
]


@pytest.mark.parametrize("m,k,n,group", GROUP_CASES)
def test_int4_plain_matches_jax_at_any_group(m, k, n, group):
    rng = np.random.default_rng(m + k + n + group)
    w = rng.standard_normal((k, n), np.float32)
    qw = tw.quantize_weight_int4(_t(w), group=group)
    kp = 2 * qw.packed.shape[0]
    x = np.zeros((m, kp), np.float32)
    x[:, :k] = rng.standard_normal((m, k), np.float32)
    packed, scale = jnp.asarray(qw.packed.numpy()), jnp.asarray(qw.scale.numpy())
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), packed, scale, group=group,
                                      out_dtype=jnp.float32))
    got = int4_weight_matmul(_t(x), qw.packed, qw.scale, group=group, out_dtype=torch.float32)
    assert np.abs(got.numpy() - want).max() <= F32_REL * np.abs(want).max()
    xb = x.astype(ml_dtypes.bfloat16)
    want_b = np.asarray(jax_int4_matmul(jnp.asarray(xb), packed, scale, group=group), np.float32)
    got_b = int4_weight_matmul(_t(xb), qw.packed, qw.scale, group=group)
    assert got_b.dtype == torch.bfloat16 and _within_bf16_ulp(_np(got_b), want_b)


@pytest.mark.parametrize("group", [1, 8, 24, 32, 48, 96, 160])
def test_int4_geometry_takes_any_group(group):
    """plan_int4 takes every group dividing the packed rows; the chunks
    cover them with a ragged last one."""
    for m in (1, 8, 40, 64, 65, 2048):
        for half in (group * 3, group * 40):
            plan = lt.plan_int4(m, half, 512, group)
            assert plan.chunks == -(-half // lt.CHUNK)
            assert plan.chunk_ranges()[-1][1] == plan.chunks
            assert plan.shared_bytes == lt.shared_bytes(m, plan.bn, 2)
    with pytest.raises(ValueError, match="divides"):
        lt.plan_int4(8, 3 * group, 64, 2 * group)


# the serving LM (test_torch_weights.py's config)
CFG = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, n_layers=2,
           max_seq=128)


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**CFG)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    jbf16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams)
    return jcfg, jbf16, TransformerConfig(**CFG), params_from_jax(jbf16, "cpu", torch.bfloat16)


def _leaves(tree):
    top = [tree[k] for k in ("embed", "unembed", "final_norm")]
    return top + [layer[k] for layer in tree["layers"] for k in sorted(layer)]


@pytest.mark.parametrize("bits,group", [(4, 32), (4, 8), (8, 128)])
def test_quantize_lm_weights_group_and_embed_match_jax(lm, bits, group):
    """quantize_lm_weights(include_embed=False, group=) leaf for leaf: the
    payloads and scales byte-equal to JAX's, the embedding left float."""
    _, jbf16, _, tparams = lm
    want = jw.quantize_lm_weights(jbf16, include_embed=False, bits=bits, group=group)
    got = tw.quantize_lm_weights(tparams, include_embed=False, bits=bits, group=group)
    assert got["embed"] is tparams["embed"]
    for g, w in zip(_leaves(got), _leaves(want)):
        if isinstance(w, jw.QuantizedWeight4):
            assert isinstance(g, tw.QuantizedWeight4) and (g.group, g.k) == (group, w.k)
            np.testing.assert_array_equal(g.packed.numpy(), np.asarray(w.packed))
        elif isinstance(w, jw.QuantizedWeight):
            assert isinstance(g, tw.QuantizedWeight) and g.axis == w.axis
            np.testing.assert_array_equal(g.w_i8.numpy(), np.asarray(w.w_i8))
        else:
            np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))
            continue
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))


@pytest.mark.parametrize("include_embed", [True, False])
def test_quantize_lm_specs_include_embed_matches_jax(include_embed):
    jcfg = jtr.TransformerConfig(**CFG)
    want = jw.quantize_lm_specs(jst.param_specs(jcfg), include_embed=include_embed)
    got = tw.quantize_lm_specs(tst.param_specs(TransformerConfig(**CFG)),
                               include_embed=include_embed)
    pairs = [(got["embed"], want["embed"]), (got["unembed"], want["unembed"])]
    pairs += [(g[key], w[key]) for g, w in zip(got["layers"], want["layers"]) for key in w]
    for g, w in pairs:
        if isinstance(w, jw.QuantizedWeight):
            assert isinstance(g, tw.QuantizedWeight) and g.axis == w.axis
            assert tuple(g.w_i8) == tuple(w.w_i8) and tuple(g.scale) == tuple(w.scale)
        else:
            assert not isinstance(g, tw.QuantizedWeight) and tuple(g) == tuple(w)
    assert isinstance(got["embed"], tw.QuantizedWeight) == include_embed


def test_group32_lm_logits_match_jax(lm):
    """A tiny LM quantized at group 32 with a float embedding: its prefill
    logits against the JAX forward on the same tree (JAX's int4 kernel at
    group 32, interpret mode)."""
    jcfg, jbf16, cfg, _ = lm
    jq = jw.quantize_lm_weights(jbf16, include_embed=False, bits=4, group=32)
    tq = params_from_jax(jq, "cpu", torch.bfloat16)
    assert tq["layers"][0]["wq"].group == 32 and not isinstance(tq["embed"], tw.QuantizedWeight)
    prompt = np.random.default_rng(32).integers(0, 64, (2, 20), dtype=np.int32)
    jl = np.asarray(jtr.transformer_forward(jq, jnp.asarray(prompt), jcfg), np.float32)
    with torch.no_grad():
        tl = transformer_forward(tq, torch.from_numpy(prompt).long(), cfg)
    assert np.abs(_np(tl) - jl).max() <= QLOGIT_TOL
