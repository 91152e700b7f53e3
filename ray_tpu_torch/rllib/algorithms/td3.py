"""TD3: twin-delayed deep deterministic policy gradient.

The port of ``ray_tpu/rllib/algorithms/td3.py`` (the reference's
rllib/algorithms/td3, built on its DDPG stack): a deterministic actor
with clipped Gaussian exploration noise, twin Q critics with polyak
targets, target-policy smoothing noise, and delayed actor updates.
Rollouts use a deterministic actor with fixed clipped Gaussian noise
(``TD3Policy``, on the CPU); the learner runs on ``config.device`` (the
CUDA card unless the config asks for the CPU) with optax's Adam.

The target-policy smoothing noise, which the JAX update draws from its
key, is explicit: :meth:`TD3.learn_on_batch` takes it as a ``[B, A]``
tensor of standard normals, drawn from the learner's generator when not
given.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.learner_state import polyak, target_copy
from ray_tpu_torch.rllib.algorithms.sac import critic_init, obs_size, q_apply
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)

_COLUMNS = ("obs", "new_obs", "actions", "rewards", "terminateds", "weights",
            "n_step_discount")


class TD3Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or TD3)
        self.policy_class_name = "td3"  # deterministic + fixed noise
        self.lr = 1e-3
        self.critic_lr = 1e-3
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 500
        self.num_train_batches_per_iteration = 32
        self.tau = 0.005
        self.policy_delay = 2
        self.target_noise = 0.2
        self.target_noise_clip = 0.5
        self.prioritized_replay = False
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.n_step = 1  # multi-step returns (learner bootstraps gamma^k)

    def training(self, *, tau=None, critic_lr=None, policy_delay=None,
                 target_noise=None, target_noise_clip=None,
                 replay_buffer_capacity=None,
                 num_train_batches_per_iteration=None,
                 num_steps_sampled_before_learning_starts=None,
                 prioritized_replay=None, n_step=None,
                 **kwargs) -> "TD3Config":
        super().training(**kwargs)
        for name, val in (("tau", tau), ("critic_lr", critic_lr),
                          ("policy_delay", policy_delay),
                          ("target_noise", target_noise),
                          ("target_noise_clip", target_noise_clip),
                          ("replay_buffer_capacity", replay_buffer_capacity),
                          ("num_train_batches_per_iteration",
                           num_train_batches_per_iteration),
                          ("num_steps_sampled_before_learning_starts",
                           num_steps_sampled_before_learning_starts),
                          ("prioritized_replay", prioritized_replay),
                          ("n_step", n_step)):
            if val is not None:
                setattr(self, name, val)
        return self


class TD3(Algorithm):
    _default_config_class = TD3Config
    _learner_trees = ("_q_params", "_q_target", "_actor_target")
    _learner_opts = {"_actor_state": "params", "_critic_state": "_q_params"}
    _learner_values = ("_updates",)

    def setup(self, config: TD3Config) -> None:
        policy = self.local_policy
        device = policy.device
        q_in = obs_size(self._env_creator, config.env_config) + policy.act_dim
        self._q_params = critic_init(config.seed + 17, q_in,
                                     list(config.fcnet_hiddens), device)
        self._q_target = target_copy(self._q_params)
        self._actor_target = target_copy(policy.params)
        self._actor_opt = optim.adam(config.lr)
        self._critic_opt = optim.adam(config.critic_lr)
        self._actor_state = init_optimizer(self._actor_opt, policy.params)
        self._critic_state = init_optimizer(self._critic_opt, self._q_params)
        if config.prioritized_replay:
            self._buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.replay_buffer_capacity,
                alpha=config.prioritized_replay_alpha, seed=config.seed)
        else:
            self._buffer = ReplayBuffer(config.replay_buffer_capacity,
                                        seed=config.seed)
        self._updates = 0
        self._gen = torch.Generator(device=device).manual_seed(
            config.seed + 31)

    def draw_noise(self, batch: int) -> torch.Tensor:
        """The target-policy smoothing noise of a minibatch of ``batch``
        rows: [batch, act_dim] standard normals from the learner's
        generator."""
        policy = self.local_policy
        return torch.randn((batch, policy.act_dim), generator=self._gen,
                           device=policy.device)

    def _critic_loss(self, q_params, mb, noise):
        config: TD3Config = self.config
        policy = self.local_policy
        low, high = policy.low_t, policy.high_t
        with torch.no_grad():
            next_a = policy.deterministic(self._actor_target, mb["new_obs"])
            # Target-policy smoothing: clipped noise on the target action.
            eps = torch.clamp(noise * config.target_noise,
                              -config.target_noise_clip,
                              config.target_noise_clip) * (high - low) * 0.5
            next_a = torch.clamp(next_a + eps, low, high)
            q1_t = q_apply(self._q_target["q1"], mb["new_obs"], next_a)
            q2_t = q_apply(self._q_target["q2"], mb["new_obs"], next_a)
            # n-step rows carry their own bootstrap discount gamma^k.
            disc = mb.get("n_step_discount", config.gamma)
            done = mb["terminateds"].to(q1_t.dtype)
            target = mb["rewards"] + disc * (1 - done) * \
                torch.minimum(q1_t, q2_t)
        q1 = q_apply(q_params["q1"], mb["obs"], mb["actions"])
        q2 = q_apply(q_params["q2"], mb["obs"], mb["actions"])
        td = 0.5 * (q1 - target) + 0.5 * (q2 - target)
        sq = (q1 - target) ** 2 + (q2 - target) ** 2
        if "weights" in mb:
            sq = mb["weights"] * sq
        return sq.mean(), {"td": td}

    def _actor_loss(self, actor_params, mb):
        a = self.local_policy.deterministic(actor_params, mb["obs"])
        return -q_apply(self._q_params["q1"], mb["obs"], a).mean(), {}

    def learn_on_batch(self, mb: Dict[str, Any],
                       noise: Optional[torch.Tensor] = None
                       ) -> Dict[str, Any]:
        """One TD3 update on a replay minibatch (numpy columns) on the
        learner's device: the critic step, and on every
        ``policy_delay``-th update the actor step and both Polyak targets;
        then the minibatch's priorities from the TD errors. Returns the
        losses and the TD errors ("td")."""
        config: TD3Config = self.config
        policy = self.local_policy
        device_mb = {k: as_tensor(v, policy.device) for k, v in mb.items()
                     if k in _COLUMNS}
        if noise is None:
            noise = self.draw_noise(len(mb["obs"]))
        self._updates += 1
        do_actor = self._updates % config.policy_delay == 0

        c_grads, c_metrics = loss_grads(
            lambda q, b: self._critic_loss(q, b, noise), self._q_params,
            device_mb)
        self._critic_state = apply_grads(self._critic_opt, self._q_params,
                                         self._critic_state, c_grads)
        a_loss = 0.0
        if do_actor:
            a_grads, a_metrics = loss_grads(self._actor_loss, policy.params,
                                            device_mb)
            self._actor_state = apply_grads(self._actor_opt, policy.params,
                                            self._actor_state, a_grads)
            a_loss = float(a_metrics["total_loss"])
            # Polyak targets (delayed with the actor, as the JAX package
            # gates them on do_actor).
            polyak(self._q_params, self._q_target, config.tau)
            polyak(policy.params, self._actor_target, config.tau)
        td = c_metrics["td"].cpu().numpy()
        if config.prioritized_replay:
            self._buffer.update_priorities(mb["batch_indexes"], td)
        return {"critic_loss": float(c_metrics["total_loss"]),
                "actor_loss": a_loss, "td": td}

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: TD3Config = self.config
        weights_ref = ray_tpu_torch.put(self.get_weights())
        self.workers.sync_weights(weights_ref)
        batch = self.workers.sample(max(config.rollout_fragment_length, 1))
        self._timesteps_total += len(batch)
        if config.n_step > 1:
            from ray_tpu_torch.rllib.utils.replay_buffers import (
                n_step_transform)
            batch = n_step_transform(batch, config.n_step, config.gamma)
        self._buffer.add(batch)
        metrics_out: Dict[str, Any] = {}
        if len(self._buffer) >= max(
                config.num_steps_sampled_before_learning_starts,
                config.train_batch_size):
            for _ in range(config.num_train_batches_per_iteration):
                if config.prioritized_replay:
                    mb = self._buffer.sample(
                        config.train_batch_size,
                        beta=config.prioritized_replay_beta)
                else:
                    mb = self._buffer.sample(config.train_batch_size)
                metrics = self.learn_on_batch(mb)
            metrics_out = {k: float(v) for k, v in metrics.items()
                           if k != "td"}
        metrics_out["replay_buffer_size"] = len(self._buffer)
        return metrics_out
