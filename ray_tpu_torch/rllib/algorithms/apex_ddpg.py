"""APEX-DDPG: distributed prioritized replay for continuous control.

Analog of the reference's rllib/algorithms/apex_ddpg (Horgan et al. 2018
applied to DDPG): many exploration actors feeding a central prioritized
buffer, a single continuous-control
learner. As with apex_dqn.py, the reference's dedicated replay-shard
actors collapse here because the learner owns its buffer — APEX-DDPG is
the DDPG engine under the APEX distributed configuration: a worker
fleet, prioritized replay, n-step returns, and slower target sync.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig


class ApexDDPGConfig(DDPGConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ApexDDPG)
        self.num_rollout_workers = 4
        self.prioritized_replay = True
        self.n_step = 3
        self.replay_buffer_capacity = 200_000
        self.num_steps_sampled_before_learning_starts = 2000
        self.tau = 0.001  # APEX syncs targets more slowly


class ApexDDPG(DDPG):
    _default_config_class = ApexDDPGConfig
