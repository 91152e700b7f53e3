"""The port's examples: ``ray_tpu_torch/examples/gptj_finetune.py``, the
counterpart of the JAX package's ``examples/gptj_finetune.py``.

gpt-tiny through ``main`` on the CPU (``--cpu``: one worker process,
gloo), 2 steps: the JAX example's keys each step, and the first loss
bit-equal to the same seed's state stepped by ``make_train_step`` on the
same 1-rank mesh outside the trainer. The JAX example reads no
``approx_mfu`` on the CPU, and neither does the port's.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import ray_tpu_torch
from ray_tpu_torch.examples import gptj_finetune
from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel import MeshConfig
from ray_tpu_torch.parallel.sharding import ShardingRules
from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                               init_train_state,
                                               make_train_step)
from ray_tpu_torch.train import prepare_mesh

# What the JAX example's train_loop reports each step on the CPU.
JAX_KEYS = {"step", "loss", "tokens_per_s", "n_params"}


@pytest.fixture
def port_cluster():
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=4, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


def _first_loss_outside_the_trainer(steps, lr):
    """The example's first step in this process: the same seed's state on
    the same 1-rank mesh, and rank 0's first batch."""
    batch, seq = gptj_finetune.SIZES["gpt-tiny"]
    cfg = gpt.config("gpt-tiny")
    mesh = prepare_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1), device="cpu")
    try:
        rules = ShardingRules(sequence=None)
        opt = default_optimizer(learning_rate=lr, total_steps=steps)
        state = init_train_state(cfg, mesh, rules, opt, seed=0,
                                 device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                 (batch, seq + 1))
        data = {"tokens": torch.tensor(toks[:, :-1], dtype=torch.int32),
                "targets": torch.tensor(toks[:, 1:], dtype=torch.int32)}
        _, metrics = make_train_step(cfg, mesh, rules, opt)(state, data)
        return float(metrics["loss"])
    finally:
        dist.destroy_process_group()


def test_gptj_finetune_on_the_cpu(port_cluster, monkeypatch):
    # The reference step's 1-rank group is this process's own, whatever
    # rendezvous variables an earlier test left here.
    for name in ("MASTER_ADDR", "MASTER_PORT", "RAY_TPU_WORLD_SIZE",
                 "RAY_TPU_RANK"):
        monkeypatch.delenv(name, raising=False)
    result = gptj_finetune.main(
        ["--preset", "gpt-tiny", "--steps", "2", "--num-workers", "1",
         "--dp", "1", "--fsdp", "1", "--tp", "1", "--cpu"])
    history = result.metrics_history
    assert [m["step"] for m in history] == [0, 1]
    for m in history:
        assert set(m) == JAX_KEYS | {"kernel_launches"}
        assert m["kernel_launches"] == [0, 0, 0]  # the plain versions
        assert np.isfinite(m["loss"]) and m["tokens_per_s"] > 0
        assert m["n_params"] == gpt.config("gpt-tiny").num_params()
    assert history[0]["loss"] == _first_loss_outside_the_trainer(2, 1e-5)
