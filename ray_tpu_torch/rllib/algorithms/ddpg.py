"""DDPG: deep deterministic policy gradient.

Analog of the reference's rllib/algorithms/ddpg. The reference builds TD3
*on top of* its DDPG stack; here the layering is inverted — the TD3 engine
(ray_tpu/rllib/algorithms/td3.py) already contains the DDPG update as its
degenerate case, so DDPG = TD3 with every-step actor updates, no
target-policy smoothing noise, and the classic DDPG default
hyperparameters. The twin-critic min reduces to a (slightly conservative)
single-critic target; exploration remains clipped Gaussian noise on the
deterministic actor (TD3Policy).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.td3 import TD3, TD3Config


class DDPGConfig(TD3Config):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DDPG)
        self.policy_delay = 1       # actor + targets update every step
        self.target_noise = 0.0     # no target-policy smoothing
        self.target_noise_clip = 0.0
        self.tau = 0.002


class DDPG(TD3):
    _default_config_class = DDPGConfig
