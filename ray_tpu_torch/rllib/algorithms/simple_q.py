"""SimpleQ: the minimal deep Q-learner.

Analog of the reference's rllib/algorithms/simple_q — the pedagogical DQN
without double-Q, prioritized replay, or dueling heads. The reference
derives DQN from SimpleQ; here the DQN engine already covers the simple
update as a configuration (double_q=False, uniform replay), so SimpleQ is
that configuration with SimpleQ's defaults.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig


class SimpleQConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or SimpleQ)
        self.double_q = False
        self.prioritized_replay = False
        self.target_network_update_freq = 500
        self.replay_buffer_capacity = 50_000


class SimpleQ(DQN):
    _default_config_class = SimpleQConfig
