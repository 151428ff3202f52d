"""PyTorch port vs the JAX package: int8 inference and int8-attention serving.

The same numpy inputs go to the JAX package (Pallas kernels in interpret
mode on the CPU, as its own tests run them) and to the port, which on CPU
tensors runs its kernels' plain versions. The CUDA kernel B6 itself is held
against its plain version, and against B4 then B5, on the card by
chip_smoke.py.

Covered: the fused inference forward (B6's plain version) against the JAX
`int8_attention_fwd_fused` (causal and not, GQA rep 2 and 4, cross and ragged
lengths, f32 and bf16 inputs, with and without a K shift);
`sage_attention_int8_inference` against the JAX one on bf16 inputs, where
the K mean is taken in bf16; the JAX package's own criteria for the fused
forward (tests/test_int8_attention.py:94-130); the wrapper's CPU behaviour;
and the LM with attention="int8" through prefill, generate and the engine.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantizedattention_tpu import int8_attention_fwd_fused as jax_int8_fused
from quantizedattention_tpu import sage_attention_int8_inference as jax_sage_inference
from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    generate,
    params_from_jax,
    prefill_batched,
    prefill_slot,
    prefill_slots,
    transformer_forward,
)
from quantizedattention_tpu_torch.ops import (
    int8_attention_fwd,
    int8_attention_fwd_from_quantized,
    int8_attention_fwd_fused,
    int8_attention_fwd_fused_plain,
    sage_attention_int8,
    sage_attention_int8_inference,
)
from quantizedattention_tpu_torch.ops import int8_fwd as tfwd
from quantizedattention_tpu_torch.parallel.kv_cache import init_kv_cache
from quantizedattention_tpu_torch.quantize import int8 as tq
from quantizedattention_tpu_torch.reference import reference_attention
from quantizedattention_tpu_torch.serve import ServingEngine
from quantizedattention_tpu_torch.utils.testing import mismatch_report

torch.set_num_threads(2)

# B6's plain version vs the JAX fused kernel: B5's tolerances
# (test_torch_int8.py). The payloads and scales agree, so only the summation
# order and where P is rounded to bf16 differ (per kv grain in JAX, per row
# here).
O_TOL, LSE_TOL = 5e-3, 1e-3
# The JAX package's criteria for the fused forward against the fp32 oracle.
ORACLE_ATOL, ORACLE_RATE = 5e-2, 2e-3

DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def _inputs(b, h, h_kv, t, s, dtype="f32", shift=0.0, seed=None):
    """numpy q, k, v in `dtype` (bf16 inputs are f32 draws rounded once)."""
    rng = np.random.default_rng(100 * t + s + h if seed is None else seed)
    q = rng.standard_normal((b, h, t, 64), np.float32)
    k = rng.standard_normal((b, h_kv, s, 64), np.float32) + np.float32(shift)
    v = rng.standard_normal((b, h_kv, s, 64), np.float32)
    return q.astype(DTYPES[dtype]), k.astype(DTYPES[dtype]), v.astype(DTYPES[dtype])


def _t(a):
    """numpy (f32 or bf16) -> torch, keeping the dtype."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


# --------------------------------------------------------------------------
# B6 against the JAX fused kernel
# --------------------------------------------------------------------------

FUSED_CASES = [  # (b, h, h_kv, t, s, causal, dtype, K shift, with k_sub)
    (1, 2, 2, 256, 256, True, "f32", 0.0, False),     # rep 1, causal
    (1, 2, 2, 256, 256, False, "f32", 4.0, True),     # not causal, smoothed K
    (1, 4, 2, 256, 256, True, "f32", 4.0, True),      # GQA rep 2
    (1, 4, 1, 200, 200, True, "f32", 0.0, False),     # GQA rep 4, ragged
    (1, 2, 2, 128, 384, False, "f32", 0.0, False),    # cross 128 x 384
    (1, 2, 2, 300, 300, True, "bf16", 4.0, True),     # ragged bf16, smoothed K
    (1, 4, 1, 256, 256, False, "bf16", 0.0, False),   # GQA rep 4, bf16
    (1, 4, 2, 77, 201, False, "f32", 4.0, True),      # odd cross length
]


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: "b{}h{}kv{}t{}s{}{}-{}{}".format(
    *c[:5], "c" if c[5] else "", c[6], "-sub" if c[8] else ""))
def test_fused_plain_matches_jax(case):
    b, h, h_kv, t, s, causal, dtype, shift, with_sub = case
    q, k, v = _inputs(b, h, h_kv, t, s, dtype, shift)
    # the K mean as both sides' inference paths take it: in k's own dtype
    k_sub = k.astype(np.float32).mean(axis=2, keepdims=True).astype(k.dtype) if with_sub else None
    o_j, lse_j = jax_int8_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                k_sub=None if k_sub is None else jnp.asarray(k_sub))
    o, lse = int8_attention_fwd_fused(_t(q), _t(k), _t(v), causal=causal,
                                      k_sub=None if k_sub is None else _t(k_sub))
    assert o.shape == (b, h, t, 64) and lse.shape == (b, h, t) and o.dtype == torch.float32
    assert np.abs(o.numpy() - np.asarray(o_j)).max() <= O_TOL
    assert np.abs(lse.numpy() - np.asarray(lse_j)).max() <= LSE_TOL


@pytest.mark.parametrize("case", FUSED_CASES[:4] + FUSED_CASES[5:6],
                         ids=lambda c: "t{}s{}{}".format(c[3], c[4], c[6]))
def test_fused_plain_is_the_materialized_forward(case):
    """B6's plain version is B4's then B5's on the same inputs, bit for bit
    (the JAX package holds its fused kernel to its materialized forward with
    lse equal, tests/test_int8_attention.py:95-108)."""
    b, h, h_kv, t, s, causal, dtype, shift, with_sub = case
    q, k, v = (_t(x) for x in _inputs(b, h, h_kv, t, s, dtype, shift))
    k_sub = k.float().mean(-2, keepdim=True) if with_sub else None
    o, lse = int8_attention_fwd_fused(q, k, v, causal=causal, k_sub=k_sub)
    o_m, lse_m, _ = int8_attention_fwd(q, k, v, causal=causal, k_sub=k_sub)
    assert torch.equal(o, o_m) and torch.equal(lse, lse_m)


@pytest.mark.parametrize("causal", [False, True])
def test_sage_attention_int8_inference_matches_jax_on_bf16(causal):
    """On bf16 inputs both sides take the K mean in bf16 (jnp.mean keeps the
    input dtype; sage_attention_int8 would take it in f32)."""
    q, k, v = _inputs(1, 4, 2, 256, 256, "bf16", shift=3.0, seed=11)
    o_j = jax_sage_inference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o = sage_attention_int8_inference(_t(q), _t(k), _t(v), causal=causal)
    assert o.dtype == torch.float32 and o.shape == (1, 4, 256, 64)
    assert np.abs(o.numpy() - np.asarray(o_j)).max() <= O_TOL
    # the port's K shift is the bf16 mean; an f32 mean quantizes K otherwise
    k_mean = _t(k).float().mean(-2, keepdim=True)
    o_bf16_mean, _ = int8_attention_fwd_fused(_t(q), _t(k), _t(v), causal=causal,
                                              k_sub=k_mean.to(torch.bfloat16))
    o_f32_mean, _ = int8_attention_fwd_fused(_t(q), _t(k), _t(v), causal=causal, k_sub=k_mean)
    assert torch.equal(o, o_bf16_mean) and not torch.equal(o, o_f32_mean)
    o_raw = sage_attention_int8_inference(_t(q), _t(k), _t(v), causal=causal, smooth_k=False)
    o_raw_j = jax_sage_inference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                 smooth_k=False)
    assert np.abs(o_raw.numpy() - np.asarray(o_raw_j)).max() <= O_TOL


# --------------------------------------------------------------------------
# The JAX package's criteria for the fused forward, on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_fused_matches_materialized_and_oracle(causal):
    q, k, v = (_t(x) for x in _inputs(1, 2, 2, 512, 512, seed=21))
    o_f, lse_f = int8_attention_fwd_fused(q, k, v, causal=causal)
    o_m, lse_m, _ = int8_attention_fwd(q, k, v, causal=causal)
    assert (o_f - o_m).abs().max().item() <= 1e-6
    assert (lse_f - lse_m).abs().max().item() == 0.0
    rep = mismatch_report("int8 fused", o_f, reference_attention(q, k, v, causal=causal),
                          ORACLE_ATOL)
    assert rep.mismatch_rate <= ORACLE_RATE, rep


def test_fused_cross_lengths_and_smoothing_vs_oracle():
    q, k, v = (_t(x) for x in _inputs(1, 2, 2, 128, 384, seed=22))
    o, _ = int8_attention_fwd_fused(q, k, v)
    rep = mismatch_report("int8 fused cross", o, reference_attention(q, k, v), ORACLE_ATOL)
    assert rep.mismatch_rate <= ORACLE_RATE, rep
    k8 = k + 8.0
    o_s = sage_attention_int8_inference(q, k8, v)
    rep_s = mismatch_report("int8 fused smoothed", o_s, reference_attention(q, k8, v), ORACLE_ATOL)
    assert rep_s.mismatch_rate <= ORACLE_RATE, rep_s


# --------------------------------------------------------------------------
# Wrapper
# --------------------------------------------------------------------------

def test_fused_wrapper_cpu_plain_no_launches_and_kernel_checks():
    q, k, v = (_t(x) for x in _inputs(1, 4, 2, 70, 70, "bf16"))
    before = (int8_attention_fwd_fused.launches, tq.quant_int8.launches,
              int8_attention_fwd_from_quantized.launches)
    o, lse = int8_attention_fwd_fused(q, k, v, causal=True)
    o_p, lse_p = int8_attention_fwd_fused_plain(q, k, v, causal=True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    sage_attention_int8_inference(q, k, v, causal=True)
    assert (int8_attention_fwd_fused.launches, tq.quant_int8.launches,
            int8_attention_fwd_from_quantized.launches) == before
    # the kernel path checks first, then wants CUDA tensors: no fallback
    with pytest.raises(ValueError, match="CUDA"):
        tfwd._fused_launch_args(q, k, v, k.float().mean(-2, keepdim=True))
    with pytest.raises(ValueError, match="head_dim"):
        tfwd._fused_launch_args(q[..., :32], k[..., :32], v[..., :32], None)
    with pytest.raises(ValueError, match="one type"):
        tfwd._fused_launch_args(q, k.float(), v, None)
    with pytest.raises(ValueError, match="k_sub"):
        tfwd._fused_launch_args(q, k, v, k[:, :, :2])
    # B6 quantizes with one uncounted B4 launch, on f32 or bf16 rows, CUDA only
    rows = q.reshape(4, 70, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tq.quant_int8_uncounted([tq.QuantJob(rows, 128, 128)])
    with pytest.raises(ValueError, match="one type"):
        tq.quant_int8_uncounted([tq.QuantJob(rows.half(), 128, 128)])
    with pytest.raises(ValueError, match="multiple"):
        int8_attention_fwd_fused(q[:, :3], k, v)


def test_sage_attention_int8_saves_nothing_without_grad():
    """Under no_grad (prefill), or with no input that needs a gradient,
    autograd saves no residual: the output carries no graph, and it equals
    the differentiable forward's, which saves exactly the JAX package's nine
    (payloads, scales, k_mean, O, lse)."""
    q, k, v = (_t(x) for x in _inputs(1, 4, 2, 96, 96, seed=5))
    saved = []

    def pack(x):
        saved.append(x)
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        with torch.no_grad():
            o = sage_attention_int8(q, k, v, causal=True)
        o_plain_inputs = sage_attention_int8(q, k, v, causal=True)
        assert saved == [] and o.grad_fn is None and o_plain_inputs.grad_fn is None
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o_g = sage_attention_int8(*leaves, causal=True)
    assert o_g.grad_fn is not None and len(saved) == 9
    assert torch.equal(o, o_g.detach()) and torch.equal(o, o_plain_inputs)


# --------------------------------------------------------------------------
# The LM with attention="int8": prefill, generate and the engine
# --------------------------------------------------------------------------

CFG = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, n_layers=2,
           max_seq=128, attention="int8")
# Logits of the int8-attention LM against the JAX one on the same params:
# both quantize at the same grain, so the payloads match but for rounding
# ties from summation order in k_mean, and the outputs differ where P is
# rounded (B5 vs its plain version) through two layers; random-init logits
# are O(1). The bf16 serving tests hold 2e-2 (test_torch_serving.py).
LOGIT_TOL = 2e-2
# argmax is compared only where the JAX top-2 gap exceeds this
GAP = 1e-2


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**CFG)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, TransformerConfig(**CFG), params_from_jax(jparams, "cpu")


def _assert_same_argmax(tokens, jax_logits):
    jl = np.asarray(jax_logits, np.float32)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > GAP
    assert clear.mean() >= 0.5
    np.testing.assert_array_equal(np.asarray(tokens)[clear], jl.argmax(-1)[clear])


def test_int8_lm_prefill_batched_and_forward_match_jax(lm):
    jcfg, jparams, cfg, tparams = lm
    prompt = np.random.default_rng(0).integers(0, 64, (2, 24), dtype=np.int32)
    jl = np.asarray(jtr.transformer_forward(jparams, jnp.asarray(prompt), jcfg))
    with torch.no_grad():
        tl = transformer_forward(tparams, torch.from_numpy(prompt).long(), cfg)
    assert np.abs(tl.numpy() - jl).max() <= LOGIT_TOL
    jcaches = [jkv.init_kv_cache(2, 2, 128, 64) for _ in range(2)]
    jtok, jcaches = jtr.prefill_batched(jparams, jcaches, jnp.asarray(prompt), jcfg)
    tcaches = [init_kv_cache(2, 2, 128, 64, "cpu") for _ in range(2)]
    ttok, tcaches = prefill_batched(tparams, tcaches, torch.from_numpy(prompt).long(), cfg)
    np.testing.assert_array_equal(np.asarray(jtok), jl[:, -1].argmax(-1))
    _assert_same_argmax(ttok.numpy(), jl[:, -1])
    for tc, jc in zip(tcaches, jcaches):
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        got = tc.k_i8.float().numpy() * tc.sk.numpy()[..., None]
        want = np.asarray(jc.k_i8, np.float32) * np.asarray(jc.sk)[..., None]
        assert np.abs(got - want).max() <= 3e-2


def test_int8_lm_prefill_slot_and_slots_match_jax(lm):
    jcfg, jparams, cfg, tparams = lm
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, n, dtype=np.int32) for n in (20, 9)]
    padded = np.zeros((2, 32), np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
    # the JAX prefill of each padded request: its logits at the last real row
    want = []
    for i, p in enumerate(prompts):
        jl = np.asarray(jtr.transformer_forward(jparams, jnp.asarray(padded[i:i + 1]), jcfg))
        want.append(jl[0, len(p) - 1])
        jcaches = [jkv.init_kv_cache(1, 2, 128, 64) for _ in range(2)]
        jtok, _ = jtr.prefill_slot(jparams, jcaches, jnp.asarray(padded[i]),
                                   jnp.int32(len(p)), jnp.int32(0), jcfg)
        assert int(jtok) == int(want[-1].argmax())
    single = [init_kv_cache(2, 2, 128, 64, "cpu") for _ in range(2)]
    toks = []
    for i, slot in ((0, 1), (1, 0)):
        tok, single = prefill_slot(tparams, single, torch.from_numpy(padded[i]).long(),
                                   len(prompts[i]), slot, cfg)
        toks.append(int(tok))
    _assert_same_argmax(np.asarray(toks), np.stack(want))
    # both requests in one batched call: each request is its own attention
    # row, so the tokens and caches equal the one-by-one prefills
    batched = [init_kv_cache(2, 2, 128, 64, "cpu") for _ in range(2)]
    btoks, batched = prefill_slots(tparams, batched, torch.from_numpy(padded).long(),
                                   torch.tensor([20, 9]), torch.tensor([1, 0]), cfg)
    assert btoks.tolist() == toks
    for a, b in zip(single, batched):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_int8_lm_generate_matches_jax(lm):
    jcfg, jparams, cfg, tparams = lm
    prompt = np.random.default_rng(4).integers(0, 64, (2, 16), dtype=np.int32)
    want = np.asarray(jtr.generate(jparams, jnp.asarray(prompt), jcfg, max_new_tokens=6))
    got = generate(tparams, torch.from_numpy(prompt).long(), cfg, max_new_tokens=6)
    assert got.shape == (2, 22)
    # greedy tokens agree until a near-tie flips one (then the streams part)
    first = got[:, 16].numpy()
    np.testing.assert_array_equal(first, want[:, 16])
    assert (got.numpy() == want).mean() >= 0.9


def test_int8_engine_matches_generate(lm):
    """The engine with attention="int8" prefills through B4 + B5 and decodes
    through B13; every request's tokens equal its own `generate` run."""
    _, _, cfg, tparams = lm
    prompts = [[1, 2, 3], [10, 20, 30, 40, 50, 60, 7], [5] * 12]
    budgets = [4, 6, 3]
    eng = ServingEngine(tparams, cfg, "cpu", n_slots=2, scheduler="python", decode_horizon=2)
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    results = eng.run()
    for rid, p, b in zip(rids, prompts, budgets):
        want = generate(tparams, torch.tensor([p]), cfg, max_new_tokens=b)
        assert results[rid].tokens == want[0, len(p):].tolist()
