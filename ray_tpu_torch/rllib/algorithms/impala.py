"""IMPALA: importance-weighted actor-learner with V-trace corrections.

The port of ``ray_tpu/rllib/algorithms/impala.py`` (the reference's
rllib/algorithms/impala): rollout workers sample with (slightly) stale
weights; the learner corrects the off-policyness with V-trace (Espeholt
et al. 2018) — clipped importance ratios rho/c reweight the TD errors
into corrected value targets ``vs`` and policy-gradient advantages. The
per-fragment V-trace recursion runs on host numpy (tiny, in the JAX
package's arithmetic and dtypes); the gradient update runs on
``config.device`` (the CUDA card unless the config asks for the CPU)
with optax's Adam.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.a2c import make_a2c_loss
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor


def vtrace(behavior_logp: np.ndarray, target_logp: np.ndarray,
           rewards: np.ndarray, values: np.ndarray, bootstrap: float,
           gamma: float, rho_clip: float = 1.0, c_clip: float = 1.0):
    """Single-fragment V-trace: returns (vs, pg_advantages)."""
    T = len(rewards)
    rho = np.minimum(np.exp(target_logp - behavior_logp), rho_clip)
    c = np.minimum(np.exp(target_logp - behavior_logp), c_clip)
    values_tp1 = np.append(values[1:], bootstrap)
    deltas = rho * (rewards + gamma * values_tp1 - values)
    acc = 0.0
    vs_minus_v = np.zeros(T, np.float32)
    for t in range(T - 1, -1, -1):
        acc = deltas[t] + gamma * c[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    vs_tp1 = np.append(vs[1:], bootstrap)
    pg_adv = rho * (rewards + gamma * vs_tp1 - values)
    return vs.astype(np.float32), pg_adv.astype(np.float32)


def compute_vtrace_targets(policy, batch: SampleBatch, gamma: float,
                           rho_clip: float, c_clip: float):
    """Per-episode-fragment V-trace targets against the CURRENT policy:
    returns (obs, vs, pg_advantages) as numpy arrays. Shared by IMPALA and
    APPO (their losses differ; the correction does not). The policy's
    log-probabilities and values come from its device as float32, as the
    JAX package's do."""
    obs = np.asarray(batch[SampleBatch.OBS], np.float32)
    with torch.no_grad():
        x = as_tensor(obs, policy.device)
        target_logp = policy.logp(
            policy.params, x,
            as_tensor(batch[SampleBatch.ACTIONS], policy.device)
        ).cpu().numpy()
        values = policy._value(policy.params, x).cpu().numpy()
    vs_all: List[np.ndarray] = []
    adv_all: List[np.ndarray] = []
    start = 0
    for frag in batch.split_by_episode():
        n = len(frag)
        terminated = frag[SampleBatch.TERMINATEDS][-1] > 0
        # Truncation bootstrap approximates V(s_T) for V(s_{T+1}) (the
        # post-fragment observation isn't in the batch).
        bootstrap = 0.0 if terminated else float(values[start + n - 1])
        vs, adv = vtrace(
            np.asarray(frag[SampleBatch.ACTION_LOGP], np.float32),
            target_logp[start:start + n],
            np.asarray(frag[SampleBatch.REWARDS], np.float32),
            values[start:start + n], bootstrap, gamma, rho_clip, c_clip)
        vs_all.append(vs)
        adv_all.append(adv)
        start += n
    return obs, np.concatenate(vs_all), np.concatenate(adv_all)


class ImpalaConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or Impala)
        self.lr = 6e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.vtrace_rho_clip = 1.0
        self.vtrace_c_clip = 1.0

    def training(self, *, vf_loss_coeff=None, entropy_coeff=None,
                 vtrace_rho_clip=None, vtrace_c_clip=None,
                 **kwargs) -> "ImpalaConfig":
        super().training(**kwargs)
        for name, val in (("vf_loss_coeff", vf_loss_coeff),
                          ("entropy_coeff", entropy_coeff),
                          ("vtrace_rho_clip", vtrace_rho_clip),
                          ("vtrace_c_clip", vtrace_c_clip)):
            if val is not None:
                setattr(self, name, val)
        return self


class Impala(Algorithm):
    _default_config_class = ImpalaConfig
    _learner_trees = ()
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ()

    def setup(self, config: ImpalaConfig) -> None:
        policy = self.local_policy
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, policy.params)
        self._loss_fn = make_a2c_loss(policy, config.vf_loss_coeff,
                                      config.entropy_coeff,
                                      adv_key="pg_advantages",
                                      target_key="vs")

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        """One update from a sampled batch: V-trace targets against the
        current policy, then the loss's step."""
        config: ImpalaConfig = self.config
        policy = self.local_policy
        obs, vs, pg_adv = compute_vtrace_targets(
            policy, batch, config.gamma, config.vtrace_rho_clip,
            config.vtrace_c_clip)
        device_mb = {
            "obs": as_tensor(obs, policy.device),
            "actions": as_tensor(batch[SampleBatch.ACTIONS], policy.device),
            "vs": as_tensor(vs, policy.device),
            "pg_advantages": as_tensor(pg_adv, policy.device),
        }
        grads, metrics = loss_grads(self._loss_fn, policy.params, device_mb)
        self._opt_state = apply_grads(self._optimizer, policy.params,
                                      self._opt_state, grads)
        return {k: float(v) for k, v in metrics.items()}

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: ImpalaConfig = self.config
        weights_ref = ray_tpu_torch.put(self.get_weights())
        self.workers.sync_weights(weights_ref)
        per_worker = max(
            config.train_batch_size // self.workers.num_workers(), 1)
        batch = self.workers.sample(per_worker)
        self._timesteps_total += len(batch)
        return self.learn_on_batch(batch)
