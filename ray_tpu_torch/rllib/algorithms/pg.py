"""PG: vanilla policy gradient (REINFORCE).

The port of ``ray_tpu/rllib/algorithms/pg.py`` (the reference's
rllib/algorithms/pg): the plain on-policy policy-gradient loss -logp(a|s)
* R_t with discounted reward-to-go returns (no critic baseline, no
surrogate clipping), with optax's Adam on ``config.device`` (the CUDA
card unless the config asks for the CPU). The rollout workers still
attach GAE fields, but PG trains on pure reward-to-go returns
(:func:`discounted_returns`, numpy on the host, as the JAX package
computes them; MARWIL shares it).
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


def discounted_returns(batch: SampleBatch, gamma: float,
                       bootstrap_values=None) -> np.ndarray:
    """Per-episode discounted reward-to-go (the PG return target).

    Resets at every episode boundary: termination, truncation (TimeLimit),
    and eps_id seams — a concatenated multi-worker batch places unrelated
    episodes back to back, and rewards must never bleed across them.

    ``bootstrap_values`` (optional, aligned with ``new_obs``): at a
    *non-terminal* boundary (truncation, eps_id seam, or an unterminated
    batch tail) the return continues with gamma * V(new_obs[t]) instead of
    0 — callers with a value head (MARWIL) pass V(new_obs); pure
    Monte-Carlo PG leaves it None.
    """
    n = len(batch)
    out = np.zeros(n, np.float64)
    rewards = batch[SampleBatch.REWARDS].astype(np.float64)
    terminated = np.asarray(batch[SampleBatch.TERMINATEDS])
    truncated = batch.get(SampleBatch.TRUNCATEDS)
    eps_id = batch.get(SampleBatch.EPS_ID)

    def bootstrap(t):
        return (0.0 if bootstrap_values is None
                else float(bootstrap_values[t]))

    acc = bootstrap(n - 1) if n and not terminated[n - 1] else 0.0
    for t in reversed(range(n)):
        if terminated[t]:
            acc = 0.0
        elif ((truncated is not None and truncated[t])
              or (eps_id is not None and t + 1 < n
                  and eps_id[t] != eps_id[t + 1])):
            acc = bootstrap(t)
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out.astype(np.float32)


class PGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or PG)
        self.lr = 4e-3


class PG(Algorithm):
    _default_config_class = PGConfig
    _learner_trees = ()
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ()

    def setup(self, config: PGConfig) -> None:
        policy = self.local_policy
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, policy.params)

        def loss_fn(params, mb):
            logp = policy.logp(params, mb["obs"], mb["actions"])
            return -(logp * mb["returns"]).mean(), {}

        self._loss_fn = loss_fn

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        """One update from a sampled batch: its standardized reward-to-go
        returns."""
        config: PGConfig = self.config
        policy = self.local_policy
        returns = discounted_returns(batch, config.gamma)
        # Standardize returns — the classic variance-reduction trick.
        returns = (returns - returns.mean()) / max(returns.std(), 1e-8)
        device_mb = {
            "obs": as_tensor(batch[SampleBatch.OBS], policy.device),
            "actions": as_tensor(batch[SampleBatch.ACTIONS], policy.device),
            "returns": as_tensor(returns.astype(np.float32), policy.device),
        }
        grads, metrics = loss_grads(self._loss_fn, policy.params, device_mb)
        self._opt_state = apply_grads(self._optimizer, policy.params,
                                      self._opt_state, grads)
        return {"policy_loss": float(metrics["total_loss"])}

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: PGConfig = self.config
        weights_ref = ray_tpu_torch.put(self.get_weights())
        self.workers.sync_weights(weights_ref)
        per_worker = max(
            config.train_batch_size // self.workers.num_workers(), 1)
        batch = self.workers.sample(per_worker)
        self._timesteps_total += len(batch)
        return self.learn_on_batch(batch)
