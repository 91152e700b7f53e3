"""A2C: synchronous advantage actor-critic.

The port of ``ray_tpu/rllib/algorithms/a2c.py`` (the reference's
rllib/algorithms/a2c): the PPO machinery without the clipped surrogate —
one vanilla policy-gradient + value + entropy update per sampled batch
(single epoch, whole batch), with optax's ``chain(clip_by_global_norm,
adam)`` (``parallel/optim.py``). The learner runs on ``config.device``
(the CUDA card unless the config asks for the CPU); the samplers on the
CPU. :meth:`A2C.learn_on_batch` is the update from a sampled batch.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor


class A2CConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or A2C)
        self.lr = 1e-3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0

    def training(self, *, vf_loss_coeff=None, entropy_coeff=None,
                 grad_clip=None, **kwargs) -> "A2CConfig":
        super().training(**kwargs)
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        if grad_clip is not None:
            self.grad_clip = grad_clip
        return self


def make_a2c_loss(policy, vf_coeff: float, ent_coeff: float,
                  adv_key: str = "advantages",
                  target_key: str = "value_targets"):
    """The policy-gradient + value + entropy loss bound to ``policy``
    (A2C's; IMPALA's over its V-trace columns): ``loss_fn(params, mb) ->
    (total, metrics)``."""

    def loss_fn(params, mb):
        logp = policy.logp(params, mb["obs"], mb["actions"])
        pg_loss = -(logp * mb[adv_key]).mean()
        values = policy._value(params, mb["obs"])
        vf_loss = torch.mean((values - mb[target_key]) ** 2)
        entropy = torch.mean(policy.entropy(params, mb["obs"]))
        total = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss_fn


class A2C(Algorithm):
    _default_config_class = A2CConfig
    _learner_trees = ()
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ()

    def setup(self, config: A2CConfig) -> None:
        policy = self.local_policy
        self._optimizer = optim.chain(
            optim.clip_by_global_norm(config.grad_clip),
            optim.adam(config.lr))
        self._opt_state = init_optimizer(self._optimizer, policy.params)
        self._loss_fn = make_a2c_loss(policy, config.vf_loss_coeff,
                                      config.entropy_coeff)

    def _device_minibatch(self, batch: SampleBatch):
        """Normalize advantages and stage the A2C loss inputs on the
        learner's device (shared with A3C's per-worker async updates)."""
        adv = batch[SampleBatch.ADVANTAGES]
        batch[SampleBatch.ADVANTAGES] = (
            (adv - adv.mean()) / max(adv.std(), 1e-8)).astype(np.float32)
        return {k: as_tensor(v, self.local_policy.device)
                for k, v in batch.items()
                if k in ("obs", "actions", "advantages", "value_targets")}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        """One update from a sampled, GAE-complete batch."""
        params = self.local_policy.params
        grads, metrics = loss_grads(self._loss_fn, params,
                                    self._device_minibatch(batch))
        self._opt_state = apply_grads(self._optimizer, params,
                                      self._opt_state, grads)
        return {k: float(v) for k, v in metrics.items()}

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: A2CConfig = self.config
        weights_ref = ray_tpu_torch.put(self.get_weights())
        self.workers.sync_weights(weights_ref)
        per_worker = max(
            config.train_batch_size // self.workers.num_workers(), 1)
        batch = self.workers.sample(per_worker)
        self._timesteps_total += len(batch)
        return self.learn_on_batch(batch)
