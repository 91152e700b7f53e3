"""``TorchPredictor`` and ``BatchPredictor``: the port's
``ray_tpu_torch/train/predictor.py`` against ``ray_tpu/train/predictor.py``.

The predictor tests of tests/test_train.py, mirrored with TorchPredictor
in JaxPredictor's place and held to JaxPredictor on the same inputs;
gpt-tiny's logits from the JAX package's parameters against JaxPredictor
over gpt's forward; a predictor restored from a ShardedCheckpoint of the
port's train state; ``device=None`` is the card and raises without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint
from ray_tpu.models import gpt as jgpt
from ray_tpu.train import BatchPredictor as JaxBatchPredictor
from ray_tpu.train import JaxPredictor
from ray_tpu_torch import data as rdata
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train import (BatchPredictor, CheckpointManager,
                                 TorchPredictor, save_train_state)

# fp32 logits through gpt-tiny: tests/test_torch_gpt.py's bound.
LOGIT_TOL = 1e-4


@pytest.fixture
def ray_start_regular():
    """A fresh small cluster of the port per test."""
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


def test_torch_predictor_from_checkpoint(ray_start_regular):
    w = np.asarray([[2.0], [3.0]], np.float32)
    x = np.asarray([[1.0, 1.0], [2.0, 0.0]], np.float32)
    pred = TorchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": {"w": w}}),
        apply_fn=lambda p, x: x @ p["w"], device="cpu")
    out = pred.predict(x)
    np.testing.assert_allclose(out, [[5.0], [4.0]])
    want = JaxPredictor.from_checkpoint(
        JaxCheckpoint.from_dict({"params": {"w": jnp.asarray(w)}}),
        apply_fn=lambda p, x: x @ p["w"]).predict(x)
    assert isinstance(out, np.ndarray) and out.dtype == want.dtype
    np.testing.assert_array_equal(out, want)


def test_batch_predictor_over_dataset(ray_start_regular):
    def apply_fn(p, batch):
        return {"out": batch["x"] * p["scale"]}

    ckpt = Checkpoint.from_dict({"params": {"scale": np.float32(10.0)}})
    bp = BatchPredictor.from_checkpoint(ckpt, TorchPredictor,
                                        apply_fn=apply_fn, device="cpu")
    ds = rdata.from_numpy(np.arange(8, dtype=np.float32), column="x")
    out = bp.predict(ds, batch_size=4, max_scoring_workers=2)
    vals = sorted(v for b in out.iter_batches(batch_size=None)
                  for v in b["out"])
    assert vals == [float(10 * i) for i in range(8)]


def test_batch_predictor_matches_jax(ray_start_regular):
    """The same rows through both packages' BatchPredictor (the JAX
    package's on its own cluster, started after the port's is down)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 2)).astype(np.float32)
    xs = rng.normal(size=(10, 3)).astype(np.float32)

    def apply_fn(p, batch):
        return {"y": batch["x"] @ p["w"]}

    got = BatchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": {"w": w}}), TorchPredictor,
        apply_fn=apply_fn, device="cpu").predict(
            rdata.from_numpy(xs, column="x"), batch_size=4)
    got = np.concatenate([b["y"] for b in got.iter_batches(batch_size=None)])
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0, _memory=1e9)
    try:
        from ray_tpu import data as jdata
        want = JaxBatchPredictor.from_checkpoint(
            JaxCheckpoint.from_dict({"params": {"w": jnp.asarray(w)}}),
            JaxPredictor, apply_fn=apply_fn).predict(
                jdata.from_numpy(xs, column="x"), batch_size=4)
        want = np.concatenate([np.asarray(b["y"]) for b in
                               want.iter_batches(batch_size=None)])
    finally:
        ray_tpu.shutdown()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _gpt_apply(model, batch):
    return model(batch["tokens"])


def test_gpt_tiny_logits_match_jax_predictor():
    cfg = jgpt.config("gpt-tiny")
    params = jax.tree_util.tree_map(
        np.asarray, jgpt.init(cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32),
                                               dtype=np.int32)
    model = tgpt.from_jax_params(params, tgpt.config("gpt-tiny"), "cpu")
    got = TorchPredictor(model, _gpt_apply, device="cpu").predict(
        {"tokens": tokens})
    with jax.default_matmul_precision("highest"):
        want = JaxPredictor(params, lambda p, b: jgpt.forward(
            p, cfg, b["tokens"])).predict({"tokens": tokens})
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (2, 32, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("optimizer", ["default_optimizer",
                                       "memory_efficient_optimizer"])
def test_from_a_sharded_train_state(tmp_path, optimizer):
    """A ShardedCheckpoint of the port's train state, whatever its
    optimizer, restores into a model of another seed, which then gives
    the saved model's logits."""
    cfg = tgpt.config("gpt-micro")
    state = tts.init_train_state(cfg, optimizer=getattr(tts, optimizer)(),
                                 seed=3, device="cpu")
    handle = save_train_state(state, CheckpointManager(str(tmp_path), "p"))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    with torch.no_grad():
        want = state["params"](torch.from_numpy(tokens)).numpy()
    other = tgpt.init(cfg, torch.Generator().manual_seed(9), "cpu")
    pred = TorchPredictor.from_checkpoint(handle, model=other,
                                          apply_fn=_gpt_apply, device="cpu")
    np.testing.assert_array_equal(pred.predict({"tokens": tokens}), want)
    with pytest.raises(ValueError, match="model="):
        TorchPredictor.from_checkpoint(handle, apply_fn=_gpt_apply,
                                       device="cpu")


def test_device_none_is_the_card():
    model = torch.nn.Linear(2, 1)
    if torch.cuda.is_available():
        assert TorchPredictor(model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchPredictor(model)
