"""MADDPG: multi-agent DDPG with centralized critics.

The port of ``ray_tpu/rllib/algorithms/maddpg.py`` (the reference's
rllib/algorithms/maddpg; Lowe et al. 2017, "Multi-Agent Actor-Critic for
Mixed Cooperative-Competitive Environments"): every agent keeps a
DECENTRALIZED deterministic actor ``mu_i(o_i)`` usable with only its own
observation at execution time, but trains it against a CENTRALIZED
critic ``Q_i(o_1..o_n, a_1..a_n)`` that sees the joint observation and
joint action — sidestepping the non-stationarity that breaks independent
DDPG learners, because the joint-conditioned value function is stationary
as the other agents' policies shift.

Updates (per agent i, from a replay buffer of joint transitions):
  * critic: TD toward ``r_i + gamma * Q_i'(o', mu_1'(o_1'),...,
    mu_n'(o_n'))`` with target actors/critics (polyak-averaged),
  * actor: deterministic policy gradient through agent i's critic AFTER
    that critic's own step this update, with agent i's action from its
    CURRENT actor and the other agents' actions from the batch (the
    paper's Eq. 6 sampling approximation).

Collection is in-algorithm on the host (joint transitions must stay
synchronized, like qmix.py); exploration is Gaussian action noise with
linear decay, from a numpy generator. Env contract: a MultiAgentEnv with
simultaneous Box actions (e.g. env/examples.py CooperativeNavEnv). The
actors, critics, their targets and the two Adams per agent live on
``config.device`` (the CUDA card unless the config asks for the CPU);
:meth:`MADDPG.learn_on_batch` is one update of every agent.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

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
                                                     named_leaves, to_numpy)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer


class MADDPGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MADDPG)
        self.actor_lr = 1e-3     # reference MADDPGConfig knobs
        self.critic_lr = 1e-2
        self.tau = 0.01
        self.train_batch_size = 256
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.num_train_batches_per_iteration = 50
        self.rollout_steps_per_iteration = 500
        self.noise_initial = 0.5
        self.noise_final = 0.05
        self.noise_timesteps = 15_000

    def training(self, *, actor_lr=None, critic_lr=None, tau=None,
                 replay_buffer_capacity=None,
                 num_steps_sampled_before_learning_starts=None,
                 num_train_batches_per_iteration=None,
                 rollout_steps_per_iteration=None, noise_timesteps=None,
                 **kwargs) -> "MADDPGConfig":
        super().training(**kwargs)
        for name, val in (
                ("actor_lr", actor_lr), ("critic_lr", critic_lr),
                ("tau", tau),
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("num_steps_sampled_before_learning_starts",
                 num_steps_sampled_before_learning_starts),
                ("num_train_batches_per_iteration",
                 num_train_batches_per_iteration),
                ("rollout_steps_per_iteration",
                 rollout_steps_per_iteration),
                ("noise_timesteps", noise_timesteps)):
            if val is not None:
                setattr(self, name, val)
        return self


class MADDPG(Algorithm):
    _default_config_class = MADDPGConfig
    _own_rollout_actors = True
    _supports_multi_agent = True
    _owns_params = True
    _learner_trees = ("_target",)
    _learner_opts = {"_a_states": "params/actors",
                     "_c_states": "params/critics"}
    _learner_values = ()

    def setup(self, config: MADDPGConfig) -> None:
        env = self._env_creator(config.env_config)
        self._env = env
        obs0, _ = env.reset(seed=config.seed)
        self.agent_ids: List[str] = sorted(obs0.keys())
        self.n = len(self.agent_ids)
        self.obs_dims = [int(np.prod(
            env.observation_space_for(a).shape)) for a in self.agent_ids]
        self.act_dims = [int(np.prod(
            env.action_space_for(a).shape)) for a in self.agent_ids]
        self._act_lo = [np.asarray(env.action_space_for(a).low,
                                   np.float32) for a in self.agent_ids]
        self._act_hi = [np.asarray(env.action_space_for(a).high,
                                   np.float32) for a in self.agent_ids]
        joint_dim = sum(self.obs_dims) + sum(self.act_dims)
        hiddens = list(config.fcnet_hiddens)
        self.device = resolve_device(config.device)
        gen = torch.Generator().manual_seed(config.seed)
        actors, critics = [], []
        for i in range(self.n):
            actors.append(mlp_init(gen, [self.obs_dims[i], *hiddens,
                                         self.act_dims[i]], self.device))
            critics.append(mlp_init(gen, [joint_dim, *hiddens, 1],
                                    self.device))
        self.params = {"actors": actors, "critics": critics}
        self._target = target_copy(self.params)
        self._a_opt = optim.adam(config.actor_lr)
        self._c_opt = optim.adam(config.critic_lr)
        self._a_states = [init_optimizer(self._a_opt, p) for p in actors]
        self._c_states = [init_optimizer(self._c_opt, p) for p in critics]
        self._los = [torch.from_numpy(lo.reshape(-1)).to(self.device)
                     for lo in self._act_lo]
        self._his = [torch.from_numpy(hi.reshape(-1)).to(self.device)
                     for hi in self._act_hi]
        self._rng = np.random.default_rng(config.seed)
        self._buffer = ReplayBuffer(config.replay_buffer_capacity,
                                    seed=config.seed)
        self._obs = obs0
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    # -- the networks ----------------------------------------------------

    def act(self, actor, obs, j: int):
        """Deterministic actor for agent j, rescaled from tanh's [-1, 1]
        to the agent's Box bounds (same mapping as td3.py det_action) so
        the whole action space is reachable."""
        t = torch.tanh(mlp_apply(actor, obs))
        return self._los[j] + (t + 1.0) * 0.5 * (self._his[j] - self._los[j])

    @staticmethod
    def critic(cr, obs_list, act_list):
        return mlp_apply(cr, torch.cat(list(obs_list) + list(act_list),
                                       -1))[..., 0]

    def _critic_loss(self, cr_i, i: int, mb):
        n, gamma = self.n, self.config.gamma
        obs = [mb[f"obs_{j}"] for j in range(n)]
        acts = [mb[f"act_{j}"] for j in range(n)]
        with torch.no_grad():
            nxt = [mb[f"new_obs_{j}"] for j in range(n)]
            a_next = [self.act(self._target["actors"][j], nxt[j], j)
                      for j in range(n)]
            q_next = self.critic(self._target["critics"][i], nxt, a_next)
            target = mb["rewards"][:, i] + gamma * \
                (1.0 - mb["dones"][:, 0]) * q_next
        q = self.critic(cr_i, obs, acts)
        return ((q - target) ** 2).mean(), {}

    def _actor_loss(self, actor_i, i: int, mb):
        obs = [mb[f"obs_{j}"] for j in range(self.n)]
        acts = [mb[f"act_{j}"] for j in range(self.n)]
        acts[i] = self.act(actor_i, obs[i], i)
        return -self.critic(self.params["critics"][i], obs, acts).mean(), {}

    def learn_on_batch(self, mb: Dict[str, Any]) -> Tuple[float, float]:
        """One update of every agent on a replay minibatch (numpy columns,
        as the buffer samples them) on the learner's device: agent i's
        critic steps, then its actor against that stepped critic; then
        the targets move by ``(1 - tau) * t + tau * p``. Returns the mean
        critic and actor losses."""
        device_mb = {k: as_tensor(v, self.device) for k, v in mb.items()
                     if k != "batch_indexes"}
        closses, alosses = [], []
        for i in range(self.n):
            critic = self.params["critics"][i]
            grads, metrics = loss_grads(
                lambda p, b: self._critic_loss(p, i, b), critic, device_mb)
            self._c_states[i] = apply_grads(self._c_opt, critic,
                                            self._c_states[i], grads)
            closses.append(metrics["total_loss"])
            # Agent i's actor against its critic as just stepped (the
            # other agents' critics do not enter its loss).
            actor = self.params["actors"][i]
            grads, metrics = loss_grads(
                lambda p, b: self._actor_loss(p, i, b), actor, device_mb)
            self._a_states[i] = apply_grads(self._a_opt, actor,
                                            self._a_states[i], grads)
            alosses.append(metrics["total_loss"])
        tau = self.config.tau
        with torch.no_grad():
            for t, p in zip(named_leaves(self._target).values(),
                            named_leaves(self.params).values()):
                t.copy_((1 - tau) * t + tau * p)
        return (float(sum(closses) / self.n), float(sum(alosses) / self.n))

    # -- acting ----------------------------------------------------------

    def _noise(self) -> float:
        c: MADDPGConfig = self.config
        frac = min(1.0, self._timesteps_total / max(c.noise_timesteps, 1))
        return c.noise_initial + frac * (c.noise_final - c.noise_initial)

    def compute_actions(self, obs_dict, noise: float = 0.0
                        ) -> Dict[str, np.ndarray]:
        out = {}
        with torch.no_grad():
            acts = [self.act(self.params["actors"][i], as_tensor(
                np.asarray(obs_dict[aid], np.float32).reshape(1, -1),
                self.device), i) for i, aid in enumerate(self.agent_ids)]
        for i, aid in enumerate(self.agent_ids):
            a = acts[i][0].cpu().numpy()
            if noise > 0:
                a = a + noise * self._rng.standard_normal(a.shape)
            out[aid] = np.clip(a, self._act_lo[i], self._act_hi[i]
                               ).astype(np.float32)
        return out

    def training_step(self) -> Dict[str, Any]:
        config: MADDPGConfig = self.config
        sigma = self._noise()
        for _ in range(config.rollout_steps_per_iteration):
            acts = self.compute_actions(self._obs, sigma)
            nxt, rewards, terms, truncs, _ = self._env.step(acts)
            terminated = bool(terms.get("__all__"))
            done = terminated or bool(truncs.get("__all__"))
            self._episode_reward += float(sum(rewards.values()))
            row = {"rewards": np.asarray(
                [rewards[a] for a in self.agent_ids], np.float32),
                "dones": np.asarray([float(terminated)], np.float32)}
            for j, aid in enumerate(self.agent_ids):
                row[f"obs_{j}"] = np.asarray(self._obs[aid], np.float32)
                row[f"act_{j}"] = acts[aid]
                # nxt is always a valid observation; terminated rows are
                # masked out of the bootstrap by "dones", and truncated
                # rows NEED the real post-step obs to bootstrap through.
                row[f"new_obs_{j}"] = np.asarray(nxt[aid], np.float32)
            self._buffer.add(SampleBatch(
                {k: np.asarray(v)[None] for k, v in row.items()}))
            self._timesteps_total += 1
            if done:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self._env.reset()
            else:
                self._obs = nxt

        closses, alosses = [], []
        if len(self._buffer) >= max(
                config.num_steps_sampled_before_learning_starts,
                config.train_batch_size):
            for _ in range(config.num_train_batches_per_iteration):
                cl, al = self.learn_on_batch(
                    self._buffer.sample(config.train_batch_size))
                closses.append(cl)
                alosses.append(al)

        window = self._episode_rewards[-100:]
        return {
            "critic_loss": float(np.mean(closses)) if closses else
            float("nan"),
            "actor_loss": float(np.mean(alosses)) if alosses else
            float("nan"),
            "noise_sigma": sigma,
            "episode_reward_mean": (float(np.mean(window)) if window
                                    else float("nan")),
            "episodes_total": len(self._episode_rewards),
        }

    def get_weights(self):
        return {"maddpg_params": to_numpy(self.params),
                "maddpg_target": to_numpy(self._target)}

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights["maddpg_params"], self.device)
        self._target = target_copy(from_jax_params(
            weights["maddpg_target"], self.device))

    def stop(self) -> None:
        close = getattr(self._env, "close", None)
        if callable(close):
            close()
