"""PyTorch port vs the JAX package: top-k / top-p sampling.

`_filter_logits` is held equal to the jitted JAX function bit for bit
(ties included), `Sampling` validates as JAX's does, and the filter reaches
every path: `sample_token`, `generate(top_k=, top_p=)`, the engine's
prefill, decode banks and chunks, and the verify pass's Gumbel draws, whose
filtered law is checked by chi-square. Draws themselves cannot equal JAX's
(a torch.Generator and the counter hash are not JAX's PRNG), so sampled
runs are held by exactness properties: top_k = 1 gives the greedy tokens,
the same seed the same tokens, every draw inside the filtered set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.serve import ServingEngine as JaxEngine
from quantizedattention_tpu_torch.models import (
    Sampling,
    TransformerConfig,
    generate,
    params_from_jax,
    sample_token,
    sampling_temperature,
)
from quantizedattention_tpu_torch.models.transformer import _filter_logits, gumbel_draws
from quantizedattention_tpu_torch.serve import ServingEngine

torch.set_num_threads(2)

SPECS = [Sampling(1.0, 5, 1.0), Sampling(0.7, 0, 0.9), Sampling(1.3, 8, 0.5),
         Sampling(1.0, 0, 1e-9), Sampling(1.0, 1, 1.0), Sampling(0.5, 64, 0.999),
         Sampling(1.0, 100, 0.3), Sampling(2.0, 3, 0.05)]


def _j(spec: Sampling):
    return jtr.Sampling(spec.temperature, spec.top_k, spec.top_p)


_J_FILTER = jax.jit(jtr._filter_logits, static_argnums=(1,))


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_filter_logits_matches_jax_bit_for_bit(spec):
    """Random logits [6, 64] with ties planted at the top-k cut and across
    the nucleus boundary, scaled by the temperature in f32 as both packages
    do: every entry equal to the jitted JAX filter's (kept values and the
    -inf mask)."""
    rng = np.random.default_rng(int(spec.top_k * 1000 + spec.top_p * 100))
    logits = rng.standard_normal((6, 64)).astype(np.float32) * 2
    logits[1, :8] = logits[1, 0]              # a tie of 8 at one value
    order = np.argsort(-logits[2])
    logits[2, order[5]] = logits[2, order[4]]  # a tie at the 5th / 6th place
    logits[3] = np.round(logits[3])            # many ties
    logits[4, :] = 1.0                         # all equal
    scaled = logits / np.float32(spec.temperature)
    got = _filter_logits(torch.from_numpy(scaled), spec).numpy()
    want = np.asarray(_J_FILTER(jnp.asarray(scaled), _j(spec)))
    np.testing.assert_array_equal(got, want)
    kept = np.isfinite(got).sum(-1)
    assert (kept >= 1).all()
    if spec.top_k:
        assert (kept[[0, 5]] <= spec.top_k).all()


@pytest.mark.parametrize("args,match", [((1.0, 0, 0.0), "top_p"), ((1.0, 0, 1.5), "top_p"),
                                        ((1.0, -1, 1.0), "top_k"), ((-0.5,), "temperature")])
def test_sampling_validates_as_jax(args, match):
    for cls in (Sampling, jtr.Sampling):
        with pytest.raises(ValueError, match=match):
            cls(*args)
    assert hash(Sampling(0.7, 50, 0.9)) == hash(Sampling(0.7, 50, 0.9))
    assert sampling_temperature(Sampling(0.7, 50, 0.9)) == 0.7 == sampling_temperature(0.7)


def test_sample_token_filters():
    """top_k = 1 and a tiny top_p give the argmax; every top-k draw lies in
    the top k; a Sampling at temperature 0 is greedy."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 64), generator=g)
    want = logits.argmax(-1)
    for _ in range(8):
        assert torch.equal(sample_token(logits, Sampling(1.0, top_k=1), g), want)
        assert torch.equal(sample_token(logits, Sampling(1.0, top_p=1e-9), g), want)
    top5 = logits.topk(5).indices
    seen = set()
    for _ in range(20):
        got = sample_token(logits, Sampling(0.8, top_k=5), g)
        assert (got[:, None] == top5).any(-1).all()
        seen.update(got.tolist())
    assert len(seen) > 4
    assert torch.equal(sample_token(logits, Sampling(0.0, top_k=5), g), want)
    peaked = torch.tensor([8.0, 7.9, 0.0, -1.0, -2.0, -3.0])
    draws = {int(sample_token(peaked, Sampling(1.0, top_p=0.6), g)) for _ in range(24)}
    assert draws <= {0, 1}


def test_gumbel_draws_follow_the_filtered_softmax():
    """The verify pass's draws under a Sampling spec: chi-square of 30,000
    draws against softmax of the filtered logits (ids outside the set never
    drawn), and the same (seed, row, position) the same token."""
    logits = torch.tensor([1.0, 0.0, -0.5, 2.0, 0.3, -1.0, 1.5, -2.0])
    spec = Sampling(0.7, top_k=6, top_p=0.95)
    rows, positions = 3000, 10
    lg = logits.expand(rows, positions, 8)
    pos = torch.arange(positions)[None].expand(rows, -1)
    draws = gumbel_draws(lg, spec, 99, torch.arange(rows), pos)
    counts = torch.bincount(draws.flatten(), minlength=8).double()
    filtered = _filter_logits(logits / spec.temperature, spec).double()
    kept = torch.isfinite(filtered)
    assert 1 < int(kept.sum()) < 6
    assert (counts[~kept] == 0).all()
    expect = torch.softmax(filtered, 0)[kept] * rows * positions
    chi2 = ((counts[kept] - expect) ** 2 / expect).sum().item()
    df = int(kept.sum()) - 1
    assert chi2 < {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47}[df]  # p = 0.001
    assert torch.equal(draws, gumbel_draws(lg, spec, 99, torch.arange(rows), pos))
    # no filter: the unfiltered law's draws are unchanged by the spec route
    plain = gumbel_draws(lg, 0.7, 99, torch.arange(rows), pos)
    assert torch.equal(plain, gumbel_draws(lg, Sampling(0.7), 99, torch.arange(rows), pos))


# --------------------------------------------------------------------------
# generate and the engine
# --------------------------------------------------------------------------

# the JAX package's sampling LM (tests/test_sampling.py)
SMALL = dict(vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=64, n_layers=2,
             max_seq=128)


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(**SMALL)
    jparams = jtr.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, TransformerConfig(**SMALL), params_from_jax(jparams, "cpu")


def test_generate_top_k_one_is_greedy_and_nucleus_repeats(lm):
    """JAX tests/test_sampling.py:107-126: generate(top_k=1) at temperature
    1 equals greedy; a top-k / top-p run repeats under the same seed and
    stays in the vocab."""
    _, _, cfg, tparams = lm
    prompt = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]])
    greedy = generate(tparams, prompt, cfg, 8)
    k1 = generate(tparams, prompt, cfg, 8, temperature=1.0,
                  generator=torch.Generator().manual_seed(9), top_k=1)
    assert torch.equal(greedy, k1)
    runs = [generate(tparams, torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]]), cfg, 8,
                     temperature=0.9, generator=torch.Generator().manual_seed(1), top_k=8,
                     top_p=0.9) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert 0 <= int(runs[0].min()) and int(runs[0].max()) < cfg.vocab_size
    with pytest.raises(ValueError, match="Generator"):
        generate(tparams, prompt, cfg, 2, temperature=0.5, top_k=3)


def _serve(params, cfg, prompts, budget, jax_engine=False, **kw):
    if jax_engine:
        eng = JaxEngine(params, cfg, n_slots=2, scheduler="python", **kw)
    else:
        eng = ServingEngine(params, cfg, "cpu", n_slots=2, scheduler="python", **kw)
    rids = [eng.submit(p, budget) for p in prompts]
    out = eng.run()
    return [out[r].tokens for r in rids]


def test_engine_top_k_one_matches_greedy_and_jax(lm):
    """JAX tests/test_sampling.py:129: the engine at temperature 1 with
    top_k = 1 gives the greedy engine's tokens on every path (prefill token
    and horizon banks), and the JAX engine's."""
    jcfg, jparams, cfg, tparams = lm
    prompts = [[1, 2, 3, 4, 5], [7, 6, 5, 4, 3, 2, 1]]
    greedy = _serve(tparams, cfg, prompts, 6, decode_horizon=4)
    k1 = _serve(tparams, cfg, prompts, 6, decode_horizon=4, temperature=1.0, top_k=1)
    jax_k1 = _serve(jparams, jcfg, prompts, 6, jax_engine=True, decode_horizon=4,
                    temperature=1.0, top_k=1)
    assert greedy == k1 == jax_k1


def test_engine_nucleus_sampling_is_seeded(lm):
    """JAX tests/test_sampling.py:149, with the filtered set checked: the
    same seed gives the same tokens, in the vocab."""
    _, _, cfg, tparams = lm

    def run(seed):
        return _serve(tparams, cfg, [[5, 4, 3, 2, 1], [9, 9, 8]], 8, temperature=1.0, top_k=16,
                      top_p=0.9, seed=seed, decode_horizon=3)

    a = run(0)
    assert a == run(0)
    assert all(0 <= t < cfg.vocab_size for toks in a for t in toks)


def test_engine_sampling_filters_chunks_and_spec(lm):
    """The filter on the chunked prefill's token and on the verify pass's
    draws (a long prompt in chunks of 128 at max_seq 256): top_k = 1 with
    spec decoding at temperature 1 gives the greedy chunked engine's tokens,
    and a top-k / top-p spec run repeats under its seed."""
    _, _, _, tparams = lm
    cfg = TransformerConfig(**{**SMALL, "max_seq": 256})
    prompts = [[5, 6, 7, 5, 6, 7] * 30, [12, 33, 2, 47]]
    greedy = _serve(tparams, cfg, prompts, 12, prefill_chunk=128)
    k1 = _serve(tparams, cfg, prompts, 12, prefill_chunk=128, spec_decode=3, temperature=1.0,
                top_k=1)
    assert k1 == greedy
    runs = [_serve(tparams, cfg, prompts, 12, prefill_chunk=128, spec_decode=3,
                   temperature=0.8, top_k=8, top_p=0.9, seed=4) for _ in range(2)]
    assert runs[0] == runs[1]


def test_engine_sampling_options_validate(lm):
    _, _, cfg, tparams = lm
    for options, match in (({"top_k": -1}, "top_k"), ({"top_p": 0.0}, "top_p"),
                           ({"temperature": -1.0}, "temperature")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(tparams, cfg, "cpu", **options)
    eng = ServingEngine(tparams, cfg, "cpu", temperature=0.5, top_k=4, top_p=0.8)
    assert eng.temperature == Sampling(0.5, 4, 0.8) and eng._generator is not None
    assert ServingEngine(tparams, cfg, "cpu", temperature=0.5).temperature == 0.5
    assert ServingEngine(tparams, cfg, "cpu", top_k=4)._generator is None  # greedy
