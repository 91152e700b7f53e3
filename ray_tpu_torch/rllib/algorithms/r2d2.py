"""R2D2: recurrent replay distributed DQN (Kapturowski et al. 2019).

The port of ``ray_tpu/rllib/algorithms/r2d2.py`` (the reference's
rllib/algorithms/r2d2): DQN with an LSTM Q-network trained on stored
SEQUENCES. Each sampled window seeds the LSTM with the hidden state
recorded at collection time, burns in ``burn_in`` steps without gradient
(re-warming the recurrence under current weights), then TD-trains the
remainder with double-Q targets and R2D2's invertible value rescaling.
Inherits the DQN engine's rollout / target-sync / epsilon plumbing;
replay and the update are sequence-shaped (utils/replay_buffers.py
SequenceReplayBuffer). The learner runs on ``config.device`` (the CUDA
card unless the config asks for the CPU); :meth:`R2D2.learn_on_batch` is
one update on a sampled window batch.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.learner_state import polyak, target_copy
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.r2d2_policy import (value_rescale,
                                                    value_rescale_inv)
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor
from ray_tpu_torch.rllib.utils.replay_buffers import SequenceReplayBuffer

# The sequence columns the loss reads.
_COLUMNS = ("obs", "actions", "rewards", "terminateds", "mask", "h0", "c0")


class R2D2Config(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or R2D2)
        self.policy_class_name = "r2d2"
        self.seq_len = 10            # training window length
        self.burn_in = 4             # no-gradient warmup steps per window
        self.train_batch_size = 16   # sequences per minibatch
        self.replay_buffer_capacity = 2000  # episodes
        self.lstm_cell_size = 64
        self.use_value_rescaling = True
        self.n_step = 1              # within-sequence TD(0)
        self.prioritized_replay = False  # uniform sequence sampling

    def training(self, *, seq_len=None, burn_in=None, lstm_cell_size=None,
                 use_value_rescaling=None, **kwargs) -> "R2D2Config":
        super().training(**kwargs)
        for name, val in (("seq_len", seq_len), ("burn_in", burn_in),
                          ("lstm_cell_size", lstm_cell_size),
                          ("use_value_rescaling", use_value_rescaling)):
            if val is not None:
                setattr(self, name, val)
        return self

    def policy_config(self):
        base = super().policy_config()
        base["lstm_cell_size"] = self.lstm_cell_size
        return base


def make_r2d2_loss(policy, gamma: float, double_q: bool, burn_in: int,
                   rescale: bool):
    """The sequence TD loss bound to ``policy``: ``loss_fn(params,
    target_params, mb) -> (loss, td)`` on ``[B, T, ...]`` windows; the
    burn-in and every target computed without gradients (JAX's
    ``stop_gradient``)."""

    def loss_fn(params, target_params, mb):
        obs = mb["obs"]                      # [B, T, ...]
        h0, c0 = mb["h0"], mb["c0"]          # [B, hidden]
        # Burn-in without gradient: re-warm the recurrence with current
        # weights, but only the post-burn-in steps train.
        h_on, c_on, h_tb, c_tb = h0, c0, h0, c0
        if burn_in > 0:
            with torch.no_grad():
                _, (h_on, c_on) = policy.q_seq(params, obs[:, :burn_in],
                                               h0, c0)
                _, (h_tb, c_tb) = policy.q_seq(target_params,
                                               obs[:, :burn_in], h0, c0)
        train_obs = obs[:, burn_in:]
        q_online, _ = policy.q_seq(params, train_obs, h_on, c_on)
        actions = mb["actions"][:, burn_in:].long()
        rewards = mb["rewards"][:, burn_in:]
        dones = torch.clamp_min(mb["terminateds"][:, burn_in:].to(
            rewards.dtype), 0.0)
        mask = mb["mask"][:, burn_in:]
        q_taken = torch.gather(q_online, -1,
                               actions[..., None])[..., 0]  # [B, T']
        with torch.no_grad():
            q_target, _ = policy.q_seq(target_params, train_obs, h_tb, c_tb)
            # Next-step targets within the window: shift by one; the last
            # step of each window has no successor -> masked out.
            if double_q:
                a_star = q_online[:, 1:].argmax(-1)
                q_next = torch.gather(q_target[:, 1:], -1,
                                      a_star[..., None])[..., 0]
            else:
                q_next = q_target[:, 1:].max(-1).values
            if rescale:
                q_next = value_rescale_inv(q_next)
            target = rewards[:, :-1] + gamma * (1.0 - dones[:, :-1]) * \
                q_next
            if rescale:
                target = value_rescale(target)
        td = q_taken[:, :-1] - target
        # Valid steps: real (mask) at t AND t+1 unless t is terminal
        # (terminal steps bootstrap nothing and are always valid).
        valid = mask[:, :-1] * torch.maximum(mask[:, 1:], dones[:, :-1])
        huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
        denom = torch.clamp_min(valid.sum(), 1.0)
        return (huber * valid).sum() / denom, td

    return loss_fn


class R2D2(DQN):
    _default_config_class = R2D2Config

    def setup(self, config: R2D2Config) -> None:
        if getattr(config, "input_", None):
            raise ValueError(
                "R2D2 trains on stored SEQUENCES with recurrent states "
                "recorded at collection time; offline JSON input "
                "(config.offline_data) carries neither and is not "
                "supported.")
        if config.prioritized_replay:
            raise ValueError(
                "R2D2 samples sequences uniformly; prioritized_replay "
                "is not supported (set it False).")
        policy = self.local_policy
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, policy.params)
        self._target_params = target_copy(policy.params)
        self._buffer = SequenceReplayBuffer(
            config.replay_buffer_capacity, seed=config.seed)
        self._grad_steps = 0
        self._reader = None
        self._loss_fn = make_r2d2_loss(policy, config.gamma, config.double_q,
                                       config.burn_in,
                                       config.use_value_rescaling)

    def learn_on_batch(self, mb: Dict[str, Any]
                       ) -> Tuple[float, np.ndarray]:
        """One Adam step on a batch of windows (numpy columns, as the
        sequence buffer samples them) on the learner's device, and every
        ``target_network_update_freq`` steps the target sync. Returns the
        loss and the TD errors [B, T' - 1]."""
        config: R2D2Config = self.config
        policy = self.local_policy
        device_mb = {k: as_tensor(v, policy.device) for k, v in mb.items()
                     if k in _COLUMNS}

        def loss(params, batch):
            value, td = self._loss_fn(params, self._target_params, batch)
            return value, {"td": td}

        grads, metrics = loss_grads(loss, policy.params, device_mb)
        self._opt_state = apply_grads(self._optimizer, policy.params,
                                      self._opt_state, grads)
        self._grad_steps += 1
        if self._grad_steps % config.target_network_update_freq == 0:
            polyak(policy.params, self._target_params, config.tau)
        return float(metrics["total_loss"]), metrics["td"].cpu().numpy()

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: R2D2Config = self.config
        weights_ref = ray_tpu_torch.put(self.get_weights())
        self.workers.sync_weights(weights_ref)
        batch = self.workers.sample(max(config.rollout_fragment_length, 1))
        self._timesteps_total += len(batch)
        self._buffer.add(batch)

        losses = []
        if len(self._buffer) >= \
                config.num_steps_sampled_before_learning_starts:
            for _ in range(config.num_train_batches_per_iteration):
                mb = self._buffer.sample(config.train_batch_size,
                                         config.seq_len)
                losses.append(self.learn_on_batch(mb)[0])
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "epsilon": self._epsilon(),
            "replay_buffer_size": len(self._buffer),
            "gradient_steps_total": self._grad_steps,
        }
