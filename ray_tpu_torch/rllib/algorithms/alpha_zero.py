"""AlphaZero: one-player MCTS planning + learned policy/value priors.

The port of ``ray_tpu/rllib/algorithms/alpha_zero.py`` (the reference's
rllib/algorithms/alpha_zero; Silver et al. 2017 adapted to single-player
envs, with the "ranked rewards" (R2) strategy of Laterre et al. 2018):
each move runs a PUCT tree search over CLONABLE env states
(``get_state``/``set_state``: the env is the simulator), guided by a
policy/value network; visit counts become the policy training target, and
the value head regresses the R2 binary reward (+1 when the episode return
beats the rolling percentile of recent returns, -1 otherwise).

Env contract: Discrete actions; observations either a plain vector or a
dict ``{"obs": vec, "action_mask": 0/1 vec}``; ``get_state() -> opaque``
and ``set_state(s)`` restore mid-episode (env/examples.py
ClonableCartPole). Exploration: Dirichlet noise on the root priors +
sampling from visit counts; evaluation uses noiseless argmax.

The tree search stays on the host, as in the JAX package; the
priors-and-value network and its optax Adam update run on
``config.device`` (the CUDA card unless the config asks for the CPU), so
every leaf evaluation is one forward there and one copy back.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.models.catalog import mlp_apply, mlp_init
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import (as_tensor,
                                                     from_jax_params,
                                                     to_numpy)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or AlphaZero)
        self.lr = 5e-4
        self.train_batch_size = 128
        self.num_train_batches_per_iteration = 16
        self.replay_buffer_capacity = 20_000
        #: MCTS knobs (reference: alpha_zero.py mcts_config defaults).
        self.num_simulations = 30
        self.c_puct = 1.25
        self.dirichlet_alpha = 0.3
        self.dirichlet_epsilon = 0.25
        self.temperature = 1.0
        #: R2 ranked-rewards knobs.
        self.ranked_rewards_percentile = 75
        self.ranked_rewards_buffer = 100
        self.episodes_per_iteration = 4
        self.max_episode_steps = 200

    def training(self, *, num_simulations=None, c_puct=None,
                 dirichlet_alpha=None, dirichlet_epsilon=None,
                 temperature=None, ranked_rewards_percentile=None,
                 ranked_rewards_buffer=None, episodes_per_iteration=None,
                 max_episode_steps=None, replay_buffer_capacity=None,
                 num_train_batches_per_iteration=None,
                 **kwargs) -> "AlphaZeroConfig":
        super().training(**kwargs)
        for name, val in (
                ("num_simulations", num_simulations),
                ("c_puct", c_puct),
                ("dirichlet_alpha", dirichlet_alpha),
                ("dirichlet_epsilon", dirichlet_epsilon),
                ("temperature", temperature),
                ("ranked_rewards_percentile", ranked_rewards_percentile),
                ("ranked_rewards_buffer", ranked_rewards_buffer),
                ("episodes_per_iteration", episodes_per_iteration),
                ("max_episode_steps", max_episode_steps),
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("num_train_batches_per_iteration",
                 num_train_batches_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self


class _Node:
    """One tree node: per-action visit/value/prior stats."""

    __slots__ = ("n", "w", "p", "children", "legal")

    def __init__(self, priors: np.ndarray, legal: np.ndarray):
        a = len(priors)
        self.n = np.zeros(a, np.float32)
        self.w = np.zeros(a, np.float32)
        self.p = priors
        self.legal = legal
        self.children: Dict[int, "_Node"] = {}

    def q(self) -> np.ndarray:
        return self.w / np.maximum(self.n, 1.0)


def _split_obs(obs) -> tuple:
    if isinstance(obs, dict):
        return (np.asarray(obs["obs"], np.float32).reshape(-1),
                np.asarray(obs["action_mask"], np.float32))
    return np.asarray(obs, np.float32).reshape(-1), None


def priors_and_value(params, obs):
    """The network: a tanh torso (its last layer activated too), logits
    over the actions and a tanh value."""
    h = mlp_apply(params["torso"], obs, activate_last=True)
    logits = mlp_apply(params["pi"], h)
    v = torch.tanh(mlp_apply(params["v"], h)[..., 0])
    return logits, v


class AlphaZero(Algorithm):
    _default_config_class = AlphaZeroConfig
    _own_rollout_actors = True
    _owns_params = True
    _learner_trees = ()
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ()

    def setup(self, config: AlphaZeroConfig) -> None:
        env = self._env_creator(config.env_config)
        for attr in ("get_state", "set_state"):
            if not hasattr(env, attr):
                raise ValueError(
                    "AlphaZero needs a clonable env exposing get_state/"
                    "set_state (the env IS the MCTS simulator; see "
                    "env/examples.py ClonableCartPole)")
        self._env = env
        self.device = resolve_device(config.device)
        obs0, _ = env.reset(seed=config.seed)
        vec, _mask = _split_obs(obs0)
        self.obs_dim = len(vec)
        self.n_actions = int(env.action_space.n)
        hiddens = list(config.fcnet_hiddens)
        gen = torch.Generator().manual_seed(config.seed)
        self.params = {
            "torso": mlp_init(gen, [self.obs_dim, *hiddens], self.device),
            "pi": mlp_init(gen, [hiddens[-1], self.n_actions], self.device),
            "v": mlp_init(gen, [hiddens[-1], 1], self.device),
        }
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, self.params)
        self._rng = np.random.default_rng(config.seed)
        self._buffer = ReplayBuffer(config.replay_buffer_capacity,
                                    seed=config.seed)
        #: rolling episode returns for the R2 threshold.
        self._returns_window: List[float] = []
        self._episode_rewards: List[float] = []

    # -- network ---------------------------------------------------------

    def _loss(self, params, mb):
        logits, v = priors_and_value(params, mb["obs"])
        # Illegal actions are masked out of the CE support.
        logits = torch.where(mb["mask"] > 0, logits,
                             torch.full_like(logits, -1e9))
        logp = torch.log_softmax(logits, -1)
        pi_loss = -(mb["tree_policy"] * logp).sum(-1).mean()
        v_loss = ((v - mb["z"]) ** 2).mean()
        return pi_loss + v_loss, {"policy_loss": pi_loss, "value_loss": v_loss}

    def learn_on_batch(self, mb: SampleBatch) -> Dict[str, float]:
        """One Adam step on a replayed minibatch (numpy ``obs``,
        ``tree_policy``, ``mask``, ``z`` [n, 1]) on the learner's
        device; returns the policy and value losses."""
        device_mb = {k: as_tensor(mb[k], self.device)
                     for k in ("obs", "tree_policy", "mask", "z")}
        device_mb["z"] = device_mb["z"][:, 0]
        grads, metrics = loss_grads(self._loss, self.params, device_mb)
        self._opt_state = apply_grads(self._optimizer, self.params,
                                      self._opt_state, grads)
        return {k: float(metrics[k]) for k in ("policy_loss", "value_loss")}

    def _evaluate(self, vec: np.ndarray, mask: Optional[np.ndarray]):
        """The priors (masked, softmaxed in float64 on the host) and value
        of one observation: a forward on the learner's device."""
        with torch.no_grad():
            logits, v = priors_and_value(self.params,
                                         as_tensor(vec[None], self.device))
        logits = logits[0].cpu().numpy().astype(np.float64)
        if mask is not None:
            logits = np.where(mask > 0, logits, -1e9)
        e = np.exp(logits - logits.max())
        return e / e.sum(), float(v[0])

    # -- MCTS ------------------------------------------------------------

    def _expand(self, obs) -> _Node:
        vec, mask = _split_obs(obs)
        priors, value = self._evaluate(vec, mask)
        legal = mask if mask is not None else \
            np.ones(self.n_actions, np.float32)
        return _Node(priors.astype(np.float32), legal), value

    def _simulate(self, root: _Node, config: AlphaZeroConfig) -> None:
        """One PUCT descent from the current env state (restored
        afterwards). Undiscounted: the backed-up value is the net's
        [-1, 1] estimate at the leaf, or at a terminal the RANKED
        transform of the env's sparse episode score."""
        env = self._env
        saved = env.get_state()
        node = root
        path: List[tuple] = []
        value = 0.0
        while True:
            total_n = node.n.sum()
            u = config.c_puct * node.p * \
                math.sqrt(total_n + 1e-8) / (1.0 + node.n)
            score = node.q() + u
            score = np.where(node.legal > 0, score, -np.inf)
            a = int(score.argmax())
            path.append((node, a))
            obs, r, term, trunc, _ = env.step(a)
            if term or trunc:
                value = self._rank(float(r))
                break
            child = node.children.get(a)
            if child is None:
                child, value = self._expand(obs)
                node.children[a] = child
                break
            node = child
        for node, a in path:
            node.n[a] += 1.0
            node.w[a] += value
        env.set_state(saved)

    def _tree_policy(self, root: _Node,
                     config: AlphaZeroConfig) -> np.ndarray:
        counts = root.n ** (1.0 / max(config.temperature, 1e-3))
        total = counts.sum()
        if total <= 0:
            legal = root.legal / root.legal.sum()
            return legal.astype(np.float32)
        return (counts / total).astype(np.float32)

    def _search(self, obs, explore: bool):
        """One full MCTS from the CURRENT env state: returns
        (tree_policy, legal_mask). Exploration adds Dirichlet noise to
        the root priors."""
        config: AlphaZeroConfig = self.config
        root, _ = self._expand(obs)
        if explore:
            noise = self._rng.dirichlet(
                np.full(self.n_actions, config.dirichlet_alpha))
            root.p = ((1 - config.dirichlet_epsilon) * root.p +
                      config.dirichlet_epsilon *
                      noise.astype(np.float32))
        for _ in range(config.num_simulations):
            self._simulate(root, config)
        return self._tree_policy(root, config), root.legal

    def compute_action(self, obs, explore: bool = False) -> int:
        """MCTS move from the CURRENT env state (must correspond to
        ``obs``). Exploit mode: argmax visit counts, no noise."""
        pi, legal = self._search(obs, explore)
        if explore:
            return int(self._rng.choice(self.n_actions, p=pi))
        return int(np.where(legal > 0, pi, 0.0).argmax())

    # -- self-play + training -------------------------------------------

    def _rank(self, episode_score: float) -> float:
        """R2 transform WITHOUT recording: +-1 against the rolling
        percentile (simulated episodes must not pollute the window)."""
        config: AlphaZeroConfig = self.config
        window = self._returns_window
        if not window:
            return 1.0
        threshold = np.percentile(
            window, config.ranked_rewards_percentile)
        if episode_score > threshold:
            return 1.0
        if episode_score < threshold:
            return -1.0
        return float(self._rng.choice([-1.0, 1.0]))

    def _env_running_score(self) -> float:
        """Accumulated-but-unpaid score of the current episode, for
        budget-exhausted self-play (envs without the hook give 0)."""
        hook = getattr(self._env, "episode_score", None)
        return float(hook()) if callable(hook) else 0.0

    def _ranked_reward(self, episode_return: float) -> float:
        """Rank AND record — for completed self-play episodes."""
        config: AlphaZeroConfig = self.config
        z = self._rank(episode_return)
        self._returns_window.append(episode_return)
        del self._returns_window[:-config.ranked_rewards_buffer]
        return z

    def training_step(self) -> Dict[str, Any]:
        config: AlphaZeroConfig = self.config
        for _ in range(config.episodes_per_iteration):
            obs, _ = self._env.reset()
            rows = []
            episode_return = 0.0
            terminated = False
            for _ in range(config.max_episode_steps):
                vec, _ = _split_obs(obs)
                pi, legal = self._search(obs, explore=True)
                a = int(self._rng.choice(self.n_actions, p=pi))
                rows.append({"obs": vec, "tree_policy": pi,
                             "mask": legal})
                obs, r, term, trunc, _ = self._env.step(a)
                episode_return += float(r)
                self._timesteps_total += 1
                if term or trunc:
                    terminated = True
                    break
            if not terminated:
                # Sparse-score envs pay only at termination; an episode
                # that outlives the step budget ranks by its running
                # score, not 0.
                episode_return += float(self._env_running_score())
            z = self._ranked_reward(episode_return)
            self._episode_rewards.append(episode_return)
            for row in rows:
                row["z"] = np.asarray([z], np.float32)
                self._buffer.add(SampleBatch(
                    {k: np.asarray(v)[None] for k, v in row.items()}))

        pi_losses, v_losses = [], []
        if len(self._buffer) >= config.train_batch_size:
            for _ in range(config.num_train_batches_per_iteration):
                out = self.learn_on_batch(
                    self._buffer.sample(config.train_batch_size))
                pi_losses.append(out["policy_loss"])
                v_losses.append(out["value_loss"])

        window = self._episode_rewards[-100:]
        return {
            "policy_loss": float(np.mean(pi_losses)) if pi_losses
            else float("nan"),
            "value_loss": float(np.mean(v_losses)) if v_losses
            else float("nan"),
            "episode_reward_mean": (float(np.mean(window)) if window
                                    else float("nan")),
            "episodes_total": len(self._episode_rewards),
        }

    def evaluate(self) -> Dict[str, Any]:
        """Noiseless-argmax MCTS episodes (exploit mode): the base
        evaluate's flat-vector policy path fits neither the dict
        observations nor the tree search."""
        config: AlphaZeroConfig = self.config
        episodes = getattr(config, "evaluation_num_episodes", 3) or 3
        rewards = []
        for _ in range(episodes):
            obs, _ = self._env.reset()
            total, terminated = 0.0, False
            for _ in range(config.max_episode_steps):
                a = self.compute_action(obs, explore=False)
                obs, r, term, trunc, _ = self._env.step(a)
                total += float(r)
                if term or trunc:
                    terminated = True
                    break
            if not terminated:
                total += float(self._env_running_score())
            rewards.append(total)
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episodes_this_eval": len(rewards)}

    def get_weights(self):
        return {"az_params": to_numpy(self.params)}

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights["az_params"], self.device)

    def stop(self) -> None:
        close = getattr(self._env, "close", None)
        if callable(close):
            close()
