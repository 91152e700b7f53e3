"""SAC: soft actor-critic with twin Q critics and auto-tuned temperature.

The port of ``ray_tpu/rllib/algorithms/sac.py`` (the reference's
rllib/algorithms/sac): off-policy maximum-entropy RL for continuous
control. The learner, on ``config.device`` (the CUDA card unless the
config asks for the CPU), holds twin Q networks + polyak targets and a
log-temperature tuned toward the -|A| target entropy, each with optax's
Adam; the squashed-Gaussian actor (``policy/sac_policy.py``) samples on
the rollout workers (CPU).

One update keeps the JAX package's order: the critic step; the actor's
loss on the *updated* critics; the temperature's loss on that actor
loss's log-probabilities; Polyak averaging. The JAX update draws its
noise from a split key inside the jit; here the noise is explicit
(:meth:`SAC.draw_noise`, from the learner's generator): standard normals
for the target's next action ("target") and the actor's ("actor"), and
CQL's proposals.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.learner_state import polyak, target_copy
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.models.catalog import mlp_apply, mlp_init
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

_COLUMNS = ("obs", "new_obs", "actions", "rewards", "terminateds")


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or SAC)
        self.policy_class_name = "sac"
        self.lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 500
        self.num_train_batches_per_iteration = 32
        self.tau = 0.005
        self.initial_alpha = 0.1
        self.target_entropy: Any = "auto"

    def training(self, *, tau=None, critic_lr=None, alpha_lr=None,
                 initial_alpha=None, target_entropy=None,
                 replay_buffer_capacity=None,
                 num_train_batches_per_iteration=None,
                 num_steps_sampled_before_learning_starts=None,
                 **kwargs) -> "SACConfig":
        super().training(**kwargs)
        for name, val in (("tau", tau), ("critic_lr", critic_lr),
                          ("alpha_lr", alpha_lr),
                          ("initial_alpha", initial_alpha),
                          ("target_entropy", target_entropy),
                          ("replay_buffer_capacity", replay_buffer_capacity),
                          ("num_train_batches_per_iteration",
                           num_train_batches_per_iteration),
                          ("num_steps_sampled_before_learning_starts",
                           num_steps_sampled_before_learning_starts)):
            if val is not None:
                setattr(self, name, val)
        return self


def q_apply(qparams, obs, act):
    """A Q network over ``[obs, action]`` (flat observations)."""
    x = torch.cat([obs.reshape((obs.shape[0], -1)), act], dim=-1)
    return mlp_apply(qparams, x)[..., 0]


def critic_init(seed: int, q_in: int, hiddens, device) -> Dict[str, Any]:
    """Twin Q networks ``{"q1", "q2"}`` over ``q_in`` inputs, drawn from
    one generator of ``seed`` on the host."""
    gen = torch.Generator().manual_seed(seed)
    sizes = [q_in, *hiddens, 1]
    return {"q1": mlp_init(gen, sizes, device),
            "q2": mlp_init(gen, sizes, device)}


def obs_size(env_creator, env_config) -> int:
    probe = env_creator(env_config)
    size = int(np.prod(probe.observation_space.shape))
    probe.close() if hasattr(probe, "close") else None
    return size


class SAC(Algorithm):
    _default_config_class = SACConfig
    _learner_trees = ("_q_params", "_q_target", "_log_alpha")
    _learner_opts = {"_actor_state": "params", "_critic_state": "_q_params",
                     "_alpha_state": "_log_alpha"}
    _learner_values = ()

    def _conservative_penalty(self, q_params, actor_params, mb, noise):
        """Extra critic-loss term. CQL overrides this with the
        conservative regularizer."""
        return 0.0

    def setup(self, config: SACConfig) -> None:
        policy = self.local_policy
        device = policy.device
        q_in = obs_size(self._env_creator, config.env_config) + policy.act_dim
        self._q_params = critic_init(config.seed + 7, q_in,
                                     list(config.fcnet_hiddens), device)
        self._q_target = target_copy(self._q_params)
        self._log_alpha = torch.tensor(
            np.float32(np.log(config.initial_alpha)), device=device,
            requires_grad=True)
        self._actor_opt = optim.adam(config.lr)
        self._critic_opt = optim.adam(config.critic_lr)
        self._alpha_opt = optim.adam(config.alpha_lr)
        self._actor_state = init_optimizer(self._actor_opt, policy.params)
        self._critic_state = init_optimizer(self._critic_opt, self._q_params)
        self._alpha_state = init_optimizer(self._alpha_opt, self._log_alpha)
        self._buffer = ReplayBuffer(config.replay_buffer_capacity,
                                    seed=config.seed)
        self._target_entropy = (-float(policy.act_dim)
                                if config.target_entropy == "auto"
                                else float(config.target_entropy))
        self._gen = torch.Generator(device=device).manual_seed(
            config.seed + 99)

    def draw_noise(self, batch: int) -> Dict[str, torch.Tensor]:
        """The update's noise for a minibatch of ``batch`` rows, from the
        learner's generator: "target" (the next action's) and "actor"
        ([batch, act_dim] standard normals each)."""
        policy = self.local_policy
        shape = (batch, policy.act_dim)
        return {k: torch.randn(shape, generator=self._gen,
                               device=policy.device)
                for k in ("target", "actor")}

    def _critic_loss(self, q_params, mb, noise):
        config: SACConfig = self.config
        policy = self.local_policy
        actor_params = policy.params
        with torch.no_grad():
            next_a, next_logp = policy.logp_and_sample(
                actor_params, mb["new_obs"], noise["target"])
            q1_t = q_apply(self._q_target["q1"], mb["new_obs"], next_a)
            q2_t = q_apply(self._q_target["q2"], mb["new_obs"], next_a)
            alpha = torch.exp(self._log_alpha)
            q_next = torch.minimum(q1_t, q2_t) - alpha * next_logp
            done = mb["terminateds"].to(q_next.dtype)
            target = mb["rewards"] + config.gamma * (1 - done) * q_next
        q1 = q_apply(q_params["q1"], mb["obs"], mb["actions"])
        q2 = q_apply(q_params["q2"], mb["obs"], mb["actions"])
        td = ((q1 - target) ** 2 + (q2 - target) ** 2).mean()
        # Hook for conservative variants (CQL overrides; 0 for SAC).
        return td + self._conservative_penalty(q_params, actor_params, mb,
                                               noise), {}

    def _actor_loss(self, actor_params, mb, noise):
        a, logp = self.local_policy.logp_and_sample(actor_params, mb["obs"],
                                                    noise["actor"])
        q1 = q_apply(self._q_params["q1"], mb["obs"], a)
        q2 = q_apply(self._q_params["q2"], mb["obs"], a)
        q = torch.minimum(q1, q2)
        alpha = torch.exp(self._log_alpha).detach()
        return (alpha * logp - q).mean(), {"logp": logp}

    def learn_on_batch(self, mb: Dict[str, Any],
                       noise: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, float]:
        """One SAC update on a replay minibatch (numpy columns) on the
        learner's device, with ``noise`` (:meth:`draw_noise`'s layout;
        drawn from the learner's generator when None)."""
        config: SACConfig = self.config
        policy = self.local_policy
        device_mb = {k: as_tensor(v, policy.device) for k, v in mb.items()
                     if k in _COLUMNS}
        if noise is None:
            noise = self.draw_noise(len(mb["obs"]))

        c_grads, c_metrics = loss_grads(
            lambda q, b: self._critic_loss(q, b, noise), self._q_params,
            device_mb)
        self._critic_state = apply_grads(self._critic_opt, self._q_params,
                                         self._critic_state, c_grads)

        a_grads, a_metrics = loss_grads(
            lambda p, b: self._actor_loss(p, b, noise), policy.params,
            device_mb)
        self._actor_state = apply_grads(self._actor_opt, policy.params,
                                        self._actor_state, a_grads)

        logp = a_metrics["logp"]
        target_entropy = self._target_entropy
        al_grads, al_metrics = loss_grads(
            lambda la, _b: ((-la * (logp + target_entropy)).mean(), {}),
            self._log_alpha, None)
        self._alpha_state = apply_grads(self._alpha_opt, self._log_alpha,
                                        self._alpha_state, al_grads)

        polyak(self._q_params, self._q_target, config.tau)
        return {"critic_loss": float(c_metrics["total_loss"]),
                "actor_loss": float(a_metrics["total_loss"]),
                "alpha_loss": float(al_metrics["total_loss"]),
                "alpha": float(torch.exp(self._log_alpha.detach())),
                "entropy": float(-logp.mean())}

    def _train_on_buffer(self, num_batches: int) -> Dict[str, Any]:
        """Run ``num_batches`` SAC updates from the replay buffer (shared
        by SAC's online loop and CQL's offline-only loop)."""
        config: SACConfig = self.config
        metrics: Dict[str, Any] = {}
        for _ in range(num_batches):
            metrics = self.learn_on_batch(
                self._buffer.sample(config.train_batch_size))
        return metrics

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: SACConfig = self.config
        weights_ref = ray_tpu_torch.put(self.get_weights())
        self.workers.sync_weights(weights_ref)
        batch = self.workers.sample(max(config.rollout_fragment_length, 1))
        self._timesteps_total += len(batch)
        self._buffer.add(batch)
        metrics_out: Dict[str, Any] = {}
        if len(self._buffer) >= max(
                config.num_steps_sampled_before_learning_starts,
                config.train_batch_size):
            metrics_out = self._train_on_buffer(
                config.num_train_batches_per_iteration)
        metrics_out["replay_buffer_size"] = len(self._buffer)
        return metrics_out
