"""PyTorch port vs the JAX package: utils/checkpoint.py.

Mirrors the checkpoint tests of tests/test_utils.py (round trip, shape
mismatch, the numpy backend, the sharded resume) on both of the port's
backends ("dcp", torch.distributed.checkpoint, the default; "numpy", the
JAX package's layout), reads a numpy checkpoint that the JAX package wrote,
and resumes both multi-rank train steps from a checkpoint on 4 gloo ranks
(one RankPool for the module): make_sharded_train_step on (data 1, model 2,
context 2), whose model ranks hold other shards of wq, wk, wv, wo, w1, w2
and their AdamW moments (DTensors), and make_pipeline_train_step on the
pipe mesh, whose stages hold other blocks. The resumed loss must be within
JAX's 1e-6 (tests/test_utils.py:98) of the uninterrupted run's.
"""

import jax
import numpy as np
import pytest
import torch

from quantizedattention_tpu.models import transformer as jtr
from quantizedattention_tpu.utils import save_checkpoint as j_save_checkpoint
from quantizedattention_tpu_torch.models import (
    TransformerConfig,
    init_transformer,
    make_train_step,
    param_leaves,
    params_from_jax,
)
from quantizedattention_tpu_torch.models import sharded_jobs
from quantizedattention_tpu_torch.parallel.launch import RankPool
from quantizedattention_tpu_torch.utils import (
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
    train_state,
)

torch.set_num_threads(2)

RESUME_TOL = 1e-6  # tests/test_utils.py:98
SMALL = dict(vocab_size=32, d_model=64, n_heads=1, n_kv_heads=1, head_dim=64, n_layers=1,
             max_seq=64)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _params(seed, cfg=SMALL):
    return init_transformer(TransformerConfig(**cfg), torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_checkpoint_roundtrip(tmp_path, backend):
    params = _params(42)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params, backend=backend)
    like = _params(9)  # different values, same shapes
    restored = load_checkpoint(path, like)
    assert restored.keys() == params.keys()
    for a, b, w in zip(_leaves(params), _leaves(restored), _leaves(like)):
        assert torch.equal(a, b) and b.dtype == w.dtype and b.device == w.device
    assert not torch.equal(like["embed"], params["embed"])  # `like` is not written to


@pytest.mark.parametrize("backend", ["dcp", "numpy"])
def test_checkpoint_shape_mismatch(tmp_path, backend):
    save_checkpoint(str(tmp_path / "c"), {"w": torch.ones((4, 4))}, backend=backend)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "c"), {"w": torch.ones((8, 8))})


@pytest.mark.parametrize("backend", ["dcp", "numpy"])
def test_checkpoint_numpy_backend_roundtrip(tmp_path, backend):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones((4,)), 3, 0.1, True, None]}
    save_checkpoint(str(tmp_path / "np"), tree, backend=backend)
    like = {"a": torch.zeros((2, 3)), "b": [torch.zeros((4,)), 0, 0.0, False, None]}
    got = load_checkpoint(str(tmp_path / "np"), like)
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"][0], tree["b"][0])
    assert got["b"][1:] == [3, 0.1, True, None]
    assert [type(x) for x in got["b"][1:4]] == [int, float, bool]


def test_checkpoint_refuses_other_directories(tmp_path):
    (tmp_path / "junk").mkdir()
    (tmp_path / "junk" / "weights.bin").write_bytes(b"\0" * 8)
    with pytest.raises(ValueError, match="not a checkpoint directory"):
        load_checkpoint(str(tmp_path / "junk"), {"w": torch.ones(1)})
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        save_checkpoint(str(tmp_path / "x"), {"w": torch.ones(1)}, backend="orbax")


def test_jax_numpy_checkpoint_loads_into_the_port(tmp_path):
    """The JAX package's numpy layout, leaves numbered in jax.tree_util's
    order, reads into the port's params tree."""
    jcfg = jtr.TransformerConfig(**SMALL, attention="bf16")
    jparams = jtr.init_transformer(jax.random.key(3), jcfg)
    j_save_checkpoint(str(tmp_path / "jax"), jparams, backend="numpy")
    got = load_checkpoint(str(tmp_path / "jax"), _params(0))
    want = params_from_jax(jparams, "cpu")
    for a, b in zip(param_leaves(got), param_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["dcp", "numpy"])
def test_train_state_resumes_one_device(tmp_path, backend):
    """train_state / restore_train_state on one process: params and AdamW
    state (step, moments, hyperparameters) restored into fresh ones, and the
    next step's loss equal to the uninterrupted run's."""
    cfg = TransformerConfig(**SMALL)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    targets = torch.roll(tokens, -1, 1)

    def build(seed):
        params = _params(seed)
        opt, step = make_train_step(cfg, params)
        names = [f"leaf{i}" for i in range(len(param_leaves(params)))]
        return dict(zip(names, param_leaves(params))), opt, step

    named, opt, step = build(0)
    step(tokens, targets)
    save_checkpoint(str(tmp_path / "s"), train_state(named, opt), backend=backend)
    want = float(step(tokens, targets))
    named2, opt2, step2 = build(5)
    opt2.param_groups[0]["lr"] = 1.0  # restored from the checkpoint
    restore_train_state(load_checkpoint(str(tmp_path / "s"), train_state(named2, opt2)), named2,
                        opt2)
    assert opt2.param_groups[0]["lr"] == 3e-4
    assert float(opt2.state[named2["leaf0"]]["step"]) == 1.0
    assert abs(float(step2(tokens, targets)) - want) < RESUME_TOL


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


def _hold_resume(outs):
    losses = [o["losses"] for o in outs]
    assert all(x == losses[0] for x in losses), losses
    for o in outs:
        assert o["restored_equal"]
        assert abs(o["resumed_loss"] - o["losses"][1]) < RESUME_TOL


def test_checkpoint_sharded_resume(pool, tmp_path):
    """(data 1, model 2, context 2): ranks 0-1 hold model shard 0, ranks
    2-3 shard 1 of every column- and row-parallel weight; each rank's
    restored shards and moments equal what it saved, bit for bit."""
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                            n_layers=1, max_seq=256)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    outs = pool.run(sharded_jobs.train, cfg, (1, 2, 2), None, tokens, torch.roll(tokens, -1, 1),
                    2, "bf16", "ring", "cpu", False, False, str(tmp_path / "state"))
    _hold_resume(outs)
    sums = [o["saved_sums"] for o in outs]
    for name in ("layers.0.wq", "layers.0.w2"):
        assert sums[0][name] == sums[1][name] != sums[2][name] == sums[3][name], name
    assert sums[0]["embed"] == sums[3]["embed"]


def test_checkpoint_pipeline_resume(pool, tmp_path):
    """The pipe mesh: each stage saves its own block under its global index
    and the replicated leaves once."""
    cfg = TransformerConfig(vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                            n_layers=4, max_seq=128)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 128)))
    outs = pool.run(sharded_jobs.pipeline_train, cfg, None, tokens, torch.roll(tokens, -1, 1), 4,
                    2, "cpu", False, str(tmp_path / "state"))
    _hold_resume(outs)
    for rank, o in enumerate(outs):
        assert [n for n in o["saved_sums"] if n.startswith("layers.")][0] == f"layers.{rank}.ln1"
