"""QMIX: monotonic value factorization for cooperative multi-agent RL.

The port of ``ray_tpu/rllib/algorithms/qmix.py`` (the reference's
rllib/algorithms/qmix, Rashid et al. 2018): each agent has a utility
network Q_i(o_i, a_i) (parameter-shared, agent id one-hot appended); a
MIXING network combines them into Q_tot(s, a_1..a_n) with weights produced
by hypernetworks of the global state and constrained positive (abs),
making Q_tot monotone in every Q_i — so per-agent greedy argmax IS the
joint greedy action, while credit assignment trains through the team
reward.

Env contract: a MultiAgentEnv whose agents act simultaneously with a
shared Discrete action space; the global state is the concatenation of
agent observations (the standard fallback when the env exposes none).
Collection is in-algorithm (one env on the host, epsilon-greedy per agent
from a numpy generator): joint transitions must stay synchronized, which
the per-policy rollout workers deliberately do not guarantee. The
utility net, the hypernetworks, their target copy and Adam live on
``config.device`` (the CUDA card unless the config asks for the CPU);
:meth:`QMix.learn_on_batch` is one update on a replay minibatch.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.learner_state import target_copy
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.models.catalog import mlp_apply, mlp_init
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import (as_tensor,
                                                     from_jax_params,
                                                     to_numpy)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

# The replay columns the loss reads.
_COLUMNS = ("obs", "actions", "rewards", "dones", "state", "new_obs",
            "new_state")


class QMixConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or QMix)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.mixing_embed_dim = 32
        self.replay_buffer_capacity = 5000   # joint transitions
        self.num_steps_sampled_before_learning_starts = 200
        self.num_train_batches_per_iteration = 32
        self.target_network_update_freq = 100
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 4000
        self.rollout_steps_per_iteration = 200
        self.double_q = True

    def training(self, *, mixing_embed_dim=None,
                 replay_buffer_capacity=None,
                 num_steps_sampled_before_learning_starts=None,
                 num_train_batches_per_iteration=None,
                 target_network_update_freq=None, epsilon_timesteps=None,
                 rollout_steps_per_iteration=None, double_q=None,
                 **kwargs) -> "QMixConfig":
        super().training(**kwargs)
        for name, val in (
                ("mixing_embed_dim", mixing_embed_dim),
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("num_steps_sampled_before_learning_starts",
                 num_steps_sampled_before_learning_starts),
                ("num_train_batches_per_iteration",
                 num_train_batches_per_iteration),
                ("target_network_update_freq",
                 target_network_update_freq),
                ("epsilon_timesteps", epsilon_timesteps),
                ("rollout_steps_per_iteration",
                 rollout_steps_per_iteration),
                ("double_q", double_q)):
            if val is not None:
                setattr(self, name, val)
        return self


class QMix(Algorithm):
    _default_config_class = QMixConfig
    _own_rollout_actors = True
    _supports_multi_agent = True
    _owns_params = True
    _learner_trees = ("_target",)
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ("_grad_steps",)

    def setup(self, config: QMixConfig) -> None:
        env = self._env_creator(config.env_config)
        self._env = env
        obs0, _ = env.reset(seed=config.seed)
        self.agent_ids: List[str] = sorted(obs0.keys())
        self.n_agents = len(self.agent_ids)
        any_id = self.agent_ids[0]
        self.obs_dim = int(np.prod(
            env.observation_space_for(any_id).shape))
        self.n_actions = int(env.action_space_for(any_id).n)
        self.state_dim = self.obs_dim * self.n_agents
        in_dim = self.obs_dim + self.n_agents  # + agent-id one-hot
        self.embed = config.mixing_embed_dim
        hiddens = list(config.fcnet_hiddens)
        self.device = resolve_device(config.device)
        gen = torch.Generator().manual_seed(config.seed)
        n, a, dev = self.n_agents, self.n_actions, self.device
        self.params = {
            # Shared per-agent utility net.
            "q": mlp_init(gen, [in_dim, *hiddens, a], dev),
            # Hypernetworks from the global state.
            "hyper_w1": mlp_init(gen, [self.state_dim, n * self.embed], dev),
            "hyper_b1": mlp_init(gen, [self.state_dim, self.embed], dev),
            "hyper_w2": mlp_init(gen, [self.state_dim, self.embed], dev),
            "hyper_b2": mlp_init(gen, [self.state_dim, self.embed, 1], dev),
        }
        self._target = target_copy(self.params)
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, self.params)
        self._agent_onehot = torch.eye(n, device=dev)
        self._rng = np.random.default_rng(config.seed)
        self._buffer = ReplayBuffer(config.replay_buffer_capacity,
                                    seed=config.seed)
        self._grad_steps = 0
        self._obs = obs0
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    # -- the networks ----------------------------------------------------

    def agent_qs(self, params, obs_all):
        """obs_all [B, n, obs_dim] -> per-agent q [B, n, A]."""
        ids = self._agent_onehot.expand(obs_all.shape[:-1]
                                        + (self.n_agents,))
        return mlp_apply(params["q"], torch.cat([obs_all, ids], -1))

    def mix(self, params, qs_taken, state):
        """qs_taken [B, n], state [B, state_dim] -> Q_tot [B].
        Monotone: mixing weights pass through abs()."""
        w1 = torch.abs(mlp_apply(params["hyper_w1"], state)).reshape(
            (-1, self.n_agents, self.embed))
        b1 = mlp_apply(params["hyper_b1"], state)
        hidden = F.elu(torch.einsum("bn,bne->be", qs_taken, w1) + b1)
        w2 = torch.abs(mlp_apply(params["hyper_w2"], state))
        b2 = mlp_apply(params["hyper_b2"], state)[..., 0]
        return (hidden * w2).sum(-1) + b2

    def _loss(self, params, target_params, mb):
        config: QMixConfig = self.config
        qs = self.agent_qs(params, mb["obs"])                # [B, n, A]
        q_taken = torch.gather(qs, -1,
                               mb["actions"][..., None].long())[..., 0]
        q_tot = self.mix(params, q_taken, mb["state"])
        with torch.no_grad():
            qs_next_t = self.agent_qs(target_params, mb["new_obs"])
            if config.double_q:
                a_star = self.agent_qs(params, mb["new_obs"]).argmax(-1)
            else:
                a_star = qs_next_t.argmax(-1)
            q_next = torch.gather(qs_next_t, -1, a_star[..., None])[..., 0]
            q_tot_next = self.mix(target_params, q_next, mb["new_state"])
            target = mb["rewards"] + config.gamma * (1.0 - mb["dones"]) * \
                q_tot_next
        td = q_tot - target
        return (td ** 2).mean(), {"td": td}

    def learn_on_batch(self, mb: Dict[str, Any]) -> float:
        """One Adam step on a replay minibatch (numpy columns, as the
        buffer samples them) on the learner's device, and every
        ``target_network_update_freq`` steps the hard target sync.
        Returns the loss."""
        device_mb = {k: as_tensor(v, self.device) for k, v in mb.items()
                     if k in _COLUMNS}
        grads, metrics = loss_grads(
            lambda p, b: self._loss(p, self._target, b), self.params,
            device_mb)
        self._opt_state = apply_grads(self._optimizer, self.params,
                                      self._opt_state, grads)
        self._grad_steps += 1
        if self._grad_steps % self.config.target_network_update_freq == 0:
            self._target = target_copy(self.params)
        return float(metrics["total_loss"])

    # -- collection ------------------------------------------------------

    def _epsilon(self) -> float:
        c: QMixConfig = self.config
        frac = min(1.0, self._timesteps_total / max(c.epsilon_timesteps, 1))
        return c.epsilon_initial + frac * (c.epsilon_final
                                           - c.epsilon_initial)

    def _obs_matrix(self, obs_dict) -> np.ndarray:
        return np.stack([np.asarray(obs_dict[aid], np.float32).reshape(-1)
                         for aid in self.agent_ids])

    def _act(self, obs_mat: np.ndarray, epsilon: float) -> np.ndarray:
        with torch.no_grad():
            qs = self.agent_qs(self.params,
                               as_tensor(obs_mat[None], self.device))
        greedy = qs[0].cpu().numpy().argmax(-1)
        explore = self._rng.random(self.n_agents) < epsilon
        rand = self._rng.integers(0, self.n_actions, self.n_agents)
        return np.where(explore, rand, greedy)

    def training_step(self) -> Dict[str, Any]:
        config: QMixConfig = self.config
        eps = self._epsilon()
        for _ in range(config.rollout_steps_per_iteration):
            obs_mat = self._obs_matrix(self._obs)
            acts = self._act(obs_mat, eps)
            action_dict = {aid: int(a)
                           for aid, a in zip(self.agent_ids, acts)}
            nxt, rewards, terms, truncs, _ = self._env.step(action_dict)
            terminated = bool(terms.get("__all__"))
            # Truncation ends the EPISODE but not the TASK: the TD
            # target still bootstraps through it (matching the
            # single-agent stack's terminateds/truncateds split).
            done = terminated or bool(truncs.get("__all__"))
            team_r = float(sum(rewards.values()))
            self._episode_reward += team_r
            if done:
                nxt_mat = obs_mat  # episode over: next state unused
            else:
                nxt_mat = self._obs_matrix(nxt)
            row = {"obs": obs_mat, "actions": acts,
                   "rewards": np.float32(team_r),
                   "dones": np.float32(terminated),
                   "state": obs_mat.reshape(-1),
                   "new_obs": nxt_mat,
                   "new_state": nxt_mat.reshape(-1)}
            self._buffer.add(SampleBatch(
                {k: np.asarray(v)[None] for k, v in row.items()}))
            self._timesteps_total += 1
            if done:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self._env.reset()
            else:
                self._obs = nxt

        losses = []
        if len(self._buffer) >= max(
                config.num_steps_sampled_before_learning_starts,
                config.train_batch_size):
            for _ in range(config.num_train_batches_per_iteration):
                losses.append(self.learn_on_batch(
                    self._buffer.sample(config.train_batch_size)))

        window = self._episode_rewards[-100:]
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "epsilon": eps,
            "episode_reward_mean": (float(np.mean(window)) if window
                                    else float("nan")),
            "episodes_total": len(self._episode_rewards),
        }

    def get_weights(self):
        """Checkpoint payload (Algorithm.save): the LEARNED state — the
        shared utility net, hypernet mixer, and target copy — not the
        unused probe policy."""
        return {"qmix_params": to_numpy(self.params),
                "qmix_target": to_numpy(self._target)}

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights["qmix_params"], self.device)
        self._target = target_copy(from_jax_params(weights["qmix_target"],
                                                   self.device))

    def compute_joint_action(self, obs_dict) -> Dict[str, int]:
        """Greedy joint action (monotonicity makes per-agent argmax the
        joint argmax)."""
        acts = self._act(self._obs_matrix(obs_dict), 0.0)
        return {aid: int(a) for aid, a in zip(self.agent_ids, acts)}

    def stop(self) -> None:
        close = getattr(self._env, "close", None)
        if callable(close):
            close()
