"""BC: behavior cloning from offline data.

The port of ``ray_tpu/rllib/algorithms/bc.py`` (the reference's
rllib/algorithms/bc, the offline-RL entry point over rllib/offline/):
supervised imitation of logged actions read from JSON experience files —
no environment interaction at all. The canonical consumer of JsonWriter
output (`config.offline_data(input_=dir)`), of either package. The
learner runs on ``config.device`` (the CUDA card unless the config asks
for the CPU) with optax's Adam.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BC)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_rollout_workers = 0  # offline: WorkerSet stays empty
        self.num_train_batches_per_iteration = 16

    def training(self, *, num_train_batches_per_iteration=None,
                 **kwargs) -> "BCConfig":
        super().training(**kwargs)
        if num_train_batches_per_iteration is not None:
            self.num_train_batches_per_iteration = \
                num_train_batches_per_iteration
        return self


class BC(Algorithm):
    _default_config_class = BCConfig
    _learner_trees = ()
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ()

    def __init__(self, config=None, **kwargs):
        # Validate BEFORE Algorithm.__init__ spawns anything: a setup()-time
        # failure would leak the already-created rollout actors.
        cfg = config or self.get_default_config()
        if not cfg.input_:
            raise ValueError(
                "BC is offline-only: set config.offline_data(input_=<dir "
                "of JSON experience files written by JsonWriter>)")
        super().__init__(config=config, **kwargs)

    def setup(self, config: BCConfig) -> None:
        from ray_tpu_torch.rllib.offline.json_reader import JsonReader
        self._reader = JsonReader(config.input_)
        policy = self.local_policy
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, policy.params)

        def loss_fn(params, mb):
            logp = policy.logp(params, mb["obs"], mb["actions"])
            return -logp.mean(), {}

        self._loss_fn = loss_fn

    def learn_on_batch(self, mb: SampleBatch) -> float:
        """One update on a minibatch of logged rows; returns the loss."""
        policy = self.local_policy
        device_mb = {
            "obs": as_tensor(np.asarray(mb[SampleBatch.OBS], np.float32),
                             policy.device),
            "actions": as_tensor(mb[SampleBatch.ACTIONS], policy.device),
        }
        grads, metrics = loss_grads(self._loss_fn, policy.params, device_mb)
        self._opt_state = apply_grads(self._optimizer, policy.params,
                                      self._opt_state, grads)
        return float(metrics["total_loss"])

    def training_step(self) -> Dict[str, Any]:
        config: BCConfig = self.config
        batch_size = config.train_batch_size
        losses = []
        for _ in range(config.num_train_batches_per_iteration):
            mb = self._reader.next_batch(batch_size)
            self._timesteps_total += batch_size
            losses.append(self.learn_on_batch(mb))
        return {"loss": float(np.mean(losses)),
                "num_batches": len(losses)}
