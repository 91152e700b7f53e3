"""DQN: double deep Q-learning with target network and replay.

The port of ``ray_tpu/rllib/algorithms/dqn.py`` (the reference's
rllib/algorithms/dqn): epsilon-greedy rollout workers (on the CPU) feed a
(optionally prioritized) replay buffer; the learner, on ``config.device``
(the CUDA card unless the config asks for the CPU), runs the double-DQN
update (online net picks argmax actions, target net scores them) with a
Huber loss and optax's Adam (``parallel/optim.py``), syncing the target
every ``target_network_update_freq`` gradient steps and annealing epsilon
over ``epsilon_timesteps``. Supports offline input (config.offline_data):
the buffer is filled from JSON files instead of rollouts.

:meth:`DQN.learn_on_batch` is one gradient step on a replay minibatch,
with its priority update and target sync: the body of the JAX package's
update loop. The JAX update hands its loss a PRNG key for noisy-net
sampling (Rainbow's); here the loss takes that noise as tensors
(:meth:`DQN.draw_noise`, None for DQN's own loss).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.learner_state import polyak, target_copy
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)

# The replay columns the loss reads.
_COLUMNS = ("obs", "new_obs", "actions", "rewards", "terminateds", "weights",
            "n_step_discount")


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DQN)
        self.policy_class_name = "q"
        self.lr = 5e-4
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # gradient steps
        self.num_train_batches_per_iteration = 32
        self.double_q = True
        self.prioritized_replay = False
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.02
        self.epsilon_timesteps = 10_000
        self.tau = 1.0  # hard target sync by default
        self.dueling = False  # dueling value/advantage streams
        self.n_step = 1  # multi-step returns (learner bootstraps gamma^n)
        self.per_worker_epsilon = False  # APEX exploration ladder

    def training(self, *, replay_buffer_capacity=None,
                 target_network_update_freq=None, double_q=None,
                 prioritized_replay=None, epsilon_timesteps=None,
                 epsilon_final=None, num_train_batches_per_iteration=None,
                 num_steps_sampled_before_learning_starts=None,
                 tau=None, dueling=None, n_step=None,
                 per_worker_epsilon=None, **kwargs) -> "DQNConfig":
        super().training(**kwargs)
        for name, val in (
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("target_network_update_freq", target_network_update_freq),
                ("double_q", double_q),
                ("prioritized_replay", prioritized_replay),
                ("epsilon_timesteps", epsilon_timesteps),
                ("epsilon_final", epsilon_final),
                ("num_train_batches_per_iteration",
                 num_train_batches_per_iteration),
                ("num_steps_sampled_before_learning_starts",
                 num_steps_sampled_before_learning_starts),
                ("tau", tau), ("dueling", dueling), ("n_step", n_step),
                ("per_worker_epsilon", per_worker_epsilon)):
            if val is not None:
                setattr(self, name, val)
        return self

    def policy_config(self) -> dict:
        """DQN-family extensions (dueling heads, APEX epsilon ladder) —
        kept off the generic base per its algo-specific-fields rule."""
        base = super().policy_config()
        base["dueling"] = self.dueling
        base["per_worker_epsilon"] = self.per_worker_epsilon
        return base


def make_dqn_loss(policy, gamma: float, double_q: bool):
    """The double-DQN Huber loss bound to ``policy``: ``loss_fn(params,
    target_params, mb, noise=None) -> (loss, td)``; the noise feeds
    noisy-net sampling and is unused here. The target is computed without
    gradients (JAX's ``stop_gradient``)."""

    def loss_fn(params, target_params, mb, noise=None):
        q_all = policy.q_values(params, mb["obs"])
        q_taken = torch.gather(q_all, -1,
                               mb["actions"][..., None].long())[..., 0]
        with torch.no_grad():
            q_next_target = policy.q_values(target_params, mb["new_obs"])
            if double_q:
                a_star = policy.q_values(params, mb["new_obs"]).argmax(-1)
                q_next = torch.gather(q_next_target, -1,
                                      a_star[..., None])[..., 0]
            else:
                q_next = q_next_target.max(-1).values
            done = torch.clamp_min(mb["terminateds"].to(q_next.dtype), 0.0)
            # n-step rows carry their own bootstrap discount gamma^k
            # (windows cut short at non-terminal boundaries have k < n).
            disc = mb.get("n_step_discount", gamma)
            target = mb["rewards"] + disc * (1.0 - done) * q_next
        td = q_taken - target
        huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
        if "weights" in mb:
            huber = mb["weights"] * huber
        return huber.mean(), td

    return loss_fn


class DQN(Algorithm):
    _default_config_class = DQNConfig
    _learner_trees = ("_target_params",)
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ("_grad_steps",)

    def setup(self, config: DQNConfig) -> None:
        policy = self.local_policy
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, policy.params)
        self._target_params = target_copy(policy.params)
        if config.prioritized_replay:
            self._buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.replay_buffer_capacity,
                alpha=config.prioritized_replay_alpha, seed=config.seed)
        else:
            self._buffer = ReplayBuffer(config.replay_buffer_capacity,
                                        seed=config.seed)
        self._grad_steps = 0
        self._reader = None
        if config.input_:
            from ray_tpu_torch.rllib.offline.json_reader import JsonReader
            self._reader = JsonReader(config.input_)
        self._loss_fn = self._build_loss_fn(policy, config)

    def _build_loss_fn(self, policy, config):
        """Returns loss_fn(params, target_params, mb, noise) -> (loss, td).
        Rainbow overrides this with the C51 distributional loss."""
        return make_dqn_loss(policy, config.gamma, config.double_q)

    def draw_noise(self, batch: int) -> Optional[Any]:
        """The loss's noise for a minibatch of ``batch`` rows: none for
        DQN (Rainbow's noisy heads draw theirs)."""
        return None

    def _epsilon(self) -> float:
        config: DQNConfig = self.config
        frac = min(1.0, self._timesteps_total /
                   max(config.epsilon_timesteps, 1))
        return config.epsilon_initial + frac * (
            config.epsilon_final - config.epsilon_initial)

    def get_weights(self):
        weights = self.local_policy.get_weights()  # {"params", "epsilon"}
        weights["epsilon"] = self._epsilon()
        return weights

    def learn_on_batch(self, mb: Dict[str, Any], noise: Optional[Any] = None
                       ) -> Tuple[float, np.ndarray]:
        """One Adam step on a replay minibatch (numpy columns, as the
        buffer samples them) on the learner's device, with ``noise``
        (:meth:`draw_noise`'s, drawn when None); then its priorities from
        |td| and, every ``target_network_update_freq`` steps, the target
        sync. Returns the loss and the TD errors."""
        config: DQNConfig = self.config
        policy = self.local_policy
        device_mb = {k: as_tensor(v, policy.device) for k, v in mb.items()
                     if k in _COLUMNS}
        if noise is None:
            noise = self.draw_noise(len(mb["obs"]))

        def loss(params, batch):
            value, td = self._loss_fn(params, self._target_params, batch,
                                      noise)
            return value, {"td": td}

        grads, metrics = loss_grads(loss, policy.params, device_mb)
        self._opt_state = apply_grads(self._optimizer, policy.params,
                                      self._opt_state, grads)
        td = metrics["td"].cpu().numpy()
        self._grad_steps += 1
        if config.prioritized_replay:
            self._buffer.update_priorities(mb["batch_indexes"], td)
        if self._grad_steps % config.target_network_update_freq == 0:
            polyak(policy.params, self._target_params, config.tau)
        return float(metrics["total_loss"]), td

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: DQNConfig = self.config
        if self._reader is not None:
            batch = SampleBatch.concat_samples(
                [self._reader.next()
                 for _ in range(config.num_train_batches_per_iteration)])
        else:
            weights_ref = ray_tpu_torch.put(self.get_weights())
            self.workers.sync_weights(weights_ref)
            per_worker = max(
                config.rollout_fragment_length, 1)
            batch = self.workers.sample(per_worker)
        self._timesteps_total += len(batch)
        if config.n_step > 1:
            from ray_tpu_torch.rllib.utils.replay_buffers import (
                n_step_transform)
            batch = n_step_transform(batch, config.n_step, config.gamma)
        self._buffer.add(batch)

        losses = []
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
                losses.append(self.learn_on_batch(mb)[0])
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "epsilon": self._epsilon(),
            "replay_buffer_size": len(self._buffer),
            "gradient_steps_total": self._grad_steps,
        }
