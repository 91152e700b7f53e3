"""APEX-DQN: distributed prioritized experience replay.

Analog of the reference's rllib/algorithms/apex_dqn (Horgan et al. 2018):
a fleet of exploration actors, each with a FIXED epsilon from the APEX
ladder 0.4^(1 + 7i/(N-1)) (per_worker_epsilon — the broadcast schedule is
ignored), feeding a central prioritized replay buffer; the learner runs
double + dueling DQN on 3-step returns with priority updates. The
reference dedicates replay-shard actors because its learner is remote
from its buffers; here the learner owns the buffer, so APEX reduces to
the DQN engine under its distributed configuration — same sampling
topology, same update.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig


class ApexDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ApexDQN)
        self.num_rollout_workers = 4
        self.per_worker_epsilon = True
        self.prioritized_replay = True
        self.double_q = True
        self.dueling = True
        self.n_step = 3
        self.replay_buffer_capacity = 200_000
        self.num_steps_sampled_before_learning_starts = 2000
        self.target_network_update_freq = 500
        self.train_batch_size = 64


class ApexDQN(DQN):
    _default_config_class = ApexDQNConfig
