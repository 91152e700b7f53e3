"""MARWIL: monotonic advantage re-weighted imitation learning.

The port of ``ray_tpu/rllib/algorithms/marwil.py`` (the reference's
rllib/algorithms/marwil, of which its BC is the beta=0 special case):
offline imitation where each logged action's log-likelihood is weighted
by exp(beta * advantage), advantage = (return - V(s)) with a trained
value head, normalized by a running estimate of the squared-advantage
moving average. beta=0 reduces to plain BC with a value head; larger beta
biases cloning toward better-than-average actions. The learner runs on
``config.device`` (the CUDA card unless the config asks for the CPU);
the returns are numpy on the host (``pg.discounted_returns``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.learner_state import target_copy
from ray_tpu_torch.rllib.algorithms.pg import discounted_returns
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MARWIL)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_rollout_workers = 0  # offline: WorkerSet stays empty
        self.num_train_batches_per_iteration = 16
        self.beta = 1.0
        self.vf_coeff = 1.0
        # Decay for the running ||adv||^2 estimate (reference:
        # marwil_torch_policy moving_average_sqd_adv_norm, update rate 1e-8
        # per sample there; per-batch here).
        self.moving_average_decay = 0.99

    def training(self, *, beta=None, vf_coeff=None,
                 moving_average_decay=None,
                 num_train_batches_per_iteration=None,
                 **kwargs) -> "MARWILConfig":
        super().training(**kwargs)
        for name, val in (("beta", beta), ("vf_coeff", vf_coeff),
                          ("moving_average_decay", moving_average_decay),
                          ("num_train_batches_per_iteration",
                           num_train_batches_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self


def make_marwil_loss(policy, beta: float, vf_coeff: float):
    """``loss_fn(params, mb) -> (total, metrics)`` with the running
    squared-advantage norm in ``mb["adv_norm"]`` (a 0-d tensor)."""

    def loss_fn(params, mb):
        values = policy._value(params, mb["obs"])
        adv = mb["returns"] - values
        vf_loss = (adv ** 2).mean()
        # Weight uses the *normalized*, gradient-stopped advantage;
        # the exponent is clamped for numerical safety.
        weight = torch.exp(torch.clamp(beta * (
            adv / torch.sqrt(mb["adv_norm"] + 1e-8)).detach(), -10.0, 10.0))
        logp = policy.logp(params, mb["obs"], mb["actions"])
        pi_loss = -(weight * logp).mean()
        return pi_loss + vf_coeff * vf_loss, {
            "policy_loss": pi_loss, "vf_loss": vf_loss,
            "adv_sq": (adv ** 2).mean()}

    return loss_fn


class MARWIL(Algorithm):
    _default_config_class = MARWILConfig
    _learner_trees = ()
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ("_adv_sq_norm",)

    def __init__(self, config=None, **kwargs):
        cfg = config or self.get_default_config()
        if not cfg.input_:
            raise ValueError(
                "MARWIL is offline-only: set "
                "config.offline_data(input_=<dir of JSON experience files>)")
        super().__init__(config=config, **kwargs)

    def setup(self, config: MARWILConfig) -> None:
        from ray_tpu_torch.rllib.offline.json_reader import JsonReader
        self._reader = JsonReader(config.input_)
        # Running E[adv^2] for weight normalization; initialized from the
        # first minibatch so early weights don't explode (exp of a raw
        # CartPole-scale return would overflow against a norm of 1).
        self._adv_sq_norm = None
        policy = self.local_policy
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, policy.params)
        self._loss_fn = make_marwil_loss(policy, config.beta,
                                         config.vf_coeff)

    def attach_returns(self, fragment: SampleBatch,
                       params=None) -> SampleBatch:
        """The fragment's discounted returns, bootstrapped at non-terminal
        tails and truncations with the value estimate of ``params`` (the
        policy's when None), else those steps' returns miss all future
        reward and exp(beta*adv) silently drops them. Datasets logged
        without new_obs fall back to pure reward-to-go."""
        policy = self.local_policy
        next_obs = fragment.get(SampleBatch.NEXT_OBS)
        values_next = None
        if next_obs is not None:
            with torch.no_grad():
                values_next = policy._value(
                    policy.params if params is None else params,
                    as_tensor(np.asarray(next_obs, np.float32),
                              policy.device)).cpu().numpy()
        fragment["returns"] = discounted_returns(
            fragment, self.config.gamma, bootstrap_values=values_next)
        return fragment

    def learn_on_batch(self, mb: SampleBatch) -> Tuple[float, float, float]:
        """One update on a minibatch with returns; updates the running
        squared-advantage norm. Returns (loss, policy_loss, vf_loss)."""
        config: MARWILConfig = self.config
        policy = self.local_policy
        device_mb = {
            "obs": as_tensor(np.asarray(mb[SampleBatch.OBS], np.float32),
                             policy.device),
            "actions": as_tensor(mb[SampleBatch.ACTIONS], policy.device),
            "returns": as_tensor(np.asarray(mb["returns"], np.float32),
                                 policy.device),
        }
        if self._adv_sq_norm is None:
            with torch.no_grad():
                values = policy._value(policy.params,
                                       device_mb["obs"]).cpu().numpy()
            adv0 = np.asarray(mb["returns"], np.float32) - values
            self._adv_sq_norm = max(float((adv0 ** 2).mean()), 1e-8)
        device_mb["adv_norm"] = torch.tensor(
            np.float32(self._adv_sq_norm), device=policy.device)
        grads, metrics = loss_grads(self._loss_fn, policy.params, device_mb)
        self._opt_state = apply_grads(self._optimizer, policy.params,
                                      self._opt_state, grads)
        d = config.moving_average_decay
        self._adv_sq_norm = (d * self._adv_sq_norm
                             + (1 - d) * float(metrics["adv_sq"]))
        return (float(metrics["total_loss"]),
                float(metrics["policy_loss"]), float(metrics["vf_loss"]))

    def training_step(self) -> Dict[str, Any]:
        config: MARWILConfig = self.config
        batch_size = config.train_batch_size
        losses, pi_losses, vf_losses = [], [], []
        # The fragments read during an iteration are bootstrapped by its
        # first parameters, as the JAX package's (which updates a copy and
        # hands it to the policy at the iteration's end).
        start = target_copy(self.local_policy.params)
        for _ in range(config.num_train_batches_per_iteration):
            mb = self._reader.next_batch(
                batch_size,
                transform=lambda f: self.attach_returns(f, start))
            self._timesteps_total += batch_size
            loss, pi_loss, vf_loss = self.learn_on_batch(mb)
            losses.append(loss)
            pi_losses.append(pi_loss)
            vf_losses.append(vf_loss)
        return {"loss": float(np.mean(losses)),
                "policy_loss": float(np.mean(pi_losses)),
                "vf_loss": float(np.mean(vf_losses)),
                "adv_sq_norm": self._adv_sq_norm}
