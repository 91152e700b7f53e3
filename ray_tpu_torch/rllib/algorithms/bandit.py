"""Contextual bandits: LinUCB and linear Thompson sampling.

Analog of the reference's rllib/algorithms/bandit (BanditLinUCB /
BanditLinTS, backed by rllib/utils/exploration and the contrib bandit
models): one-step decision problems where the "episode" is a single
(context, action, reward) round. Exact linear-Gaussian posteriors per
arm — closed-form sherman-morrison updates, no gradient descent — so
the learner is a pure linear-algebra loop in jax.

The env contract is gymnasium-style with one step per episode: reset()
returns the context, step(arm) returns (next_context, reward, True, ...).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig


class BanditConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BanditLinUCB)
        self.exploration = "ucb"        # "ucb" | "ts"
        self.ucb_alpha = 1.0            # confidence width
        self.ts_sigma = 1.0             # posterior noise scale
        self.lambda_reg = 1.0           # ridge prior precision
        self.rounds_per_iteration = 100

    def training(self, *, ucb_alpha=None, ts_sigma=None, lambda_reg=None,
                 rounds_per_iteration=None, **kwargs) -> "BanditConfig":
        super().training(**kwargs)
        for name, val in (("ucb_alpha", ucb_alpha),
                          ("ts_sigma", ts_sigma),
                          ("lambda_reg", lambda_reg),
                          ("rounds_per_iteration", rounds_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self


class _LinearPosterior:
    """Per-arm ridge posterior: A = lambda*I + sum x x^T, b = sum r x.
    Maintains A_inv incrementally (Sherman–Morrison) and caches its
    Cholesky factor for Thompson draws — refactorized lazily only after
    this arm's posterior actually changed, so TS arm selection is
    O(dim^2) per untouched arm instead of O(dim^3) for every arm every
    round."""

    def __init__(self, dim: int, lam: float):
        self.A_inv = np.eye(dim, dtype=np.float64) / lam
        self.b = np.zeros(dim, np.float64)
        self._chol: Optional[np.ndarray] = None

    @property
    def theta(self) -> np.ndarray:
        return self.A_inv @ self.b

    @property
    def chol(self) -> np.ndarray:
        if self._chol is None:
            dim = self.A_inv.shape[0]
            self._chol = np.linalg.cholesky(
                self.A_inv + 1e-12 * np.eye(dim))
        return self._chol

    def update(self, x: np.ndarray, r: float) -> None:
        Ax = self.A_inv @ x
        denom = 1.0 + float(x @ Ax)
        self.A_inv -= np.outer(Ax, Ax) / denom
        self.b += r * x
        self._chol = None


class BanditLinUCB(Algorithm):
    """LinUCB (Li et al. 2010): pick argmax_a theta_a.x +
    alpha * sqrt(x^T A_a^-1 x). With exploration="ts", linear Thompson
    sampling instead: sample theta ~ N(mean, sigma^2 A^-1) per arm."""

    _default_config_class = BanditConfig
    # Bandits sample in-process (one env step per round, closed-form
    # updates) — no rollout actors.
    _own_rollout_actors = True

    def setup(self, config: BanditConfig) -> None:
        env = self._env_creator(config.env_config)
        self._env = env
        self.n_arms = int(env.action_space.n)
        self.dim = int(np.prod(env.observation_space.shape))
        self._arms = [
            _LinearPosterior(self.dim, config.lambda_reg)
            for _ in range(self.n_arms)]
        self._rng = np.random.default_rng(config.seed)
        self._obs, _ = env.reset(seed=config.seed)
        self._total_reward = 0.0
        self._total_rounds = 0
        self._reward_window: list = []

    def _select_arm(self, x: np.ndarray) -> int:
        config: BanditConfig = self.config
        scores = np.empty(self.n_arms)
        for a, post in enumerate(self._arms):
            mean = float(post.theta @ x)
            if config.exploration == "ts":
                # Sample from the posterior: theta_s = mean + sigma * L z
                # with L the (cached) Cholesky factor of A_inv.
                z = self._rng.standard_normal(self.dim)
                theta_s = post.theta + config.ts_sigma * (post.chol @ z)
                scores[a] = float(theta_s @ x)
            else:
                width = np.sqrt(max(float(x @ post.A_inv @ x), 0.0))
                scores[a] = mean + config.ucb_alpha * width
        return int(scores.argmax())

    def training_step(self) -> Dict[str, Any]:
        config: BanditConfig = self.config
        rewards = []
        for _ in range(config.rounds_per_iteration):
            x = np.asarray(self._obs, np.float64).reshape(-1)
            arm = self._select_arm(x)
            obs, reward, terminated, truncated, _ = self._env.step(arm)
            self._arms[arm].update(x, float(reward))
            rewards.append(float(reward))
            self._obs = (self._env.reset()[0]
                         if (terminated or truncated) else obs)
        self._total_reward += sum(rewards)
        self._total_rounds += len(rewards)
        self._timesteps_total += len(rewards)
        self._reward_window.extend(rewards)
        self._reward_window = self._reward_window[-1000:]
        return {
            "episode_reward_mean": float(np.mean(self._reward_window)),
            "mean_reward_this_iter": float(np.mean(rewards)),
            "cumulative_reward": self._total_reward,
            "rounds_total": self._total_rounds,
        }

    def compute_single_action(self, obs):
        return self._select_arm(np.asarray(obs, np.float64).reshape(-1))

    def get_state(self) -> Dict[str, Any]:
        return {"arms": [(p.A_inv, p.b) for p in self._arms],
                "total_reward": self._total_reward,
                "rounds": self._total_rounds}

    def set_state(self, state: Dict[str, Any]) -> None:
        for post, (a_inv, b) in zip(self._arms, state["arms"]):
            post.A_inv = np.asarray(a_inv)
            post.b = np.asarray(b)
            post._chol = None
        self._total_reward = state["total_reward"]
        self._total_rounds = state["rounds"]

    # Algorithm.save/restore persist via get_weights/set_weights — for a
    # bandit the "weights" ARE the arm posteriors, not the unused probe
    # policy.
    def get_weights(self):
        return self.get_state()

    def set_weights(self, weights) -> None:
        self.set_state(weights)

    def stop(self) -> None:
        close = getattr(self._env, "close", None)
        if callable(close):
            close()


class BanditLinTSConfig(BanditConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BanditLinTS)
        self.exploration = "ts"


class BanditLinTS(BanditLinUCB):
    _default_config_class = BanditLinTSConfig


class BanditLinUCBConfig(BanditConfig):
    pass
