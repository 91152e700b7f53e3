"""APPO: asynchronous PPO — clipped surrogate over V-trace corrections.

The port of ``ray_tpu/rllib/algorithms/appo.py`` (the reference's
rllib/algorithms/appo, IMPALA's architecture with PPO's clipped loss):
workers sample with slightly stale weights, V-trace
(``algorithms/impala.py``) corrects the off-policyness into value targets
and advantages, and the update applies the PPO clip against the behavior
log-probs instead of a plain policy gradient. The learner runs on
``config.device`` (the CUDA card unless the config asks for the CPU).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.impala import compute_vtrace_targets
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor


class APPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or APPO)
        self.lr = 5e-4
        self.clip_param = 0.3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_sgd_iter = 2
        self.sgd_minibatch_size = 256
        self.vtrace_rho_clip = 1.0
        self.vtrace_c_clip = 1.0

    def training(self, *, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, num_sgd_iter=None,
                 sgd_minibatch_size=None, vtrace_rho_clip=None,
                 vtrace_c_clip=None, **kwargs) -> "APPOConfig":
        super().training(**kwargs)
        for name, val in (("clip_param", clip_param),
                          ("vf_loss_coeff", vf_loss_coeff),
                          ("entropy_coeff", entropy_coeff),
                          ("num_sgd_iter", num_sgd_iter),
                          ("sgd_minibatch_size", sgd_minibatch_size),
                          ("vtrace_rho_clip", vtrace_rho_clip),
                          ("vtrace_c_clip", vtrace_c_clip)):
            if val is not None:
                setattr(self, name, val)
        return self


def make_appo_loss(policy, clip: float, vf_coeff: float, ent_coeff: float):
    """The clipped surrogate against the behavior log-probs, over V-trace's
    advantages and targets: ``loss_fn(params, mb) -> (total, metrics)``."""

    def loss_fn(params, mb):
        logp = policy.logp(params, mb["obs"], mb["actions"])
        ratio = torch.exp(logp - mb["behavior_logp"])
        adv = mb["pg_advantages"]
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        values = policy._value(params, mb["obs"])
        vf_loss = torch.mean((values - mb["vs"]) ** 2)
        entropy = torch.mean(policy.entropy(params, mb["obs"]))
        total = (-torch.mean(surrogate) + vf_coeff * vf_loss
                 - ent_coeff * entropy)
        return total, {"policy_loss": -torch.mean(surrogate),
                       "vf_loss": vf_loss, "entropy": entropy}

    return loss_fn


class APPO(Algorithm):
    _default_config_class = APPOConfig
    _learner_trees = ()
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ()

    def setup(self, config: APPOConfig) -> None:
        policy = self.local_policy
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, policy.params)
        self._loss_fn = make_appo_loss(policy, config.clip_param,
                                       config.vf_loss_coeff,
                                       config.entropy_coeff)

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        """V-trace targets against the current policy, then
        ``num_sgd_iter`` epochs of minibatch updates (each epoch's
        permutation seeded by the iteration, as in the JAX package)."""
        config: APPOConfig = self.config
        policy = self.local_policy
        obs, vs, pg_adv = compute_vtrace_targets(
            policy, batch, config.gamma, config.vtrace_rho_clip,
            config.vtrace_c_clip)
        full = SampleBatch({
            "obs": obs,
            "actions": np.asarray(batch[SampleBatch.ACTIONS]),
            "behavior_logp": np.asarray(batch[SampleBatch.ACTION_LOGP],
                                        np.float32),
            "vs": vs,
            "pg_advantages": pg_adv,
        })
        metrics = {}
        for epoch in range(config.num_sgd_iter):
            for mb in full.minibatches(
                    min(config.sgd_minibatch_size, len(full)),
                    seed=self.iteration * 97 + epoch):
                device_mb = {k: as_tensor(v, policy.device)
                             for k, v in mb.items()}
                grads, metrics = loss_grads(self._loss_fn, policy.params,
                                            device_mb)
                self._opt_state = apply_grads(self._optimizer,
                                              policy.params,
                                              self._opt_state, grads)
        return {k: float(v) for k, v in metrics.items()}

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: APPOConfig = self.config
        weights_ref = ray_tpu_torch.put(self.get_weights())
        self.workers.sync_weights(weights_ref)
        per_worker = max(
            config.train_batch_size // self.workers.num_workers(), 1)
        batch = self.workers.sample(per_worker)
        self._timesteps_total += len(batch)
        return self.learn_on_batch(batch)
