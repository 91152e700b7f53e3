"""RandomAgent: the uniform-random baseline.

Analog of the reference's rllib/algorithms/random_agent.py: samples
actions uniformly from the action space and reports episode statistics —
the canonical sanity baseline for new environments and the zero point
for learning-curve gates (every tuned-example threshold in
tuned_examples/__init__.py is quoted against it).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig


class RandomAgentConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or RandomAgent)
        self.rollout_steps_per_iteration = 1000

    def training(self, *, rollout_steps_per_iteration=None, **kwargs
                 ) -> "RandomAgentConfig":
        super().training(**kwargs)
        if rollout_steps_per_iteration is not None:
            self.rollout_steps_per_iteration = rollout_steps_per_iteration
        return self


class RandomAgent(Algorithm):
    _default_config_class = RandomAgentConfig
    _own_rollout_actors = True

    def setup(self, config: RandomAgentConfig) -> None:
        self._env = self._env_creator(config.env_config)
        self._env.action_space.seed(config.seed)
        self._obs, _ = self._env.reset(seed=config.seed)
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    def training_step(self) -> Dict[str, Any]:
        config: RandomAgentConfig = self.config
        for _ in range(config.rollout_steps_per_iteration):
            obs, r, term, trunc, _ = self._env.step(
                self._env.action_space.sample())
            self._episode_reward += float(r)
            self._timesteps_total += 1
            if term or trunc:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self._env.reset()
            else:
                self._obs = obs
        window = self._episode_rewards[-100:]
        return {
            "episode_reward_mean": (float(np.mean(window)) if window
                                    else float("nan")),
            "episodes_total": len(self._episode_rewards),
        }

    def get_weights(self):
        return {}

    def set_weights(self, weights) -> None:
        pass

    def stop(self) -> None:
        close = getattr(self._env, "close", None)
        if callable(close):
            close()
