"""ray_tpu_torch.rllib: reinforcement learning on the port's runtime.

The port of ``ray_tpu/rllib``: the ``Algorithm``/``AlgorithmConfig``
driver, ``WorkerSet`` rollout actors (CPU samplers), ``TorchPolicy`` (the
port of ``JAXPolicy``), ``QPolicy`` and ``SACPolicy``; PPO with its
per-minibatch and fused SGD schedules and its learner group, DQN (with
SimpleQ and APEX-DQN as its configurations), SAC, CQL, TD3 (and DDPG),
A2C, A3C, PG, IMPALA and APPO (V-trace), BC, MARWIL, ES and ARS;
prioritized and n-step replay buffers; multi-agent training
(``MultiAgentEnv`` + policy maps), the new-stack ``core``
(``RLModule``/``Learner``/``LearnerGroup``: a learner on a ``dp`` mesh or
remote learner actors), connectors, offline JSON IO and the model
catalog. Learners run on the CUDA card unless the config asks for the
CPU. The rest of RLlib's algorithms, and the algorithm registry, are
ROADMAP item 10b.
"""

from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.a3c import A3C, A3CConfig
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.apex_dqn import ApexDQN, ApexDQNConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.ars import ARS, ARSConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.es import ES, ESConfig
from ray_tpu_torch.rllib.algorithms.impala import Impala, ImpalaConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.pg import PG, PGConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.simple_q import SimpleQ, SimpleQConfig
from ray_tpu_torch.rllib.algorithms.td3 import TD3, TD3Config
from ray_tpu_torch.rllib.core import (Learner, LearnerConfig, LearnerGroup,
                                      MLPActorCriticModule, PPOLearner,
                                      RLModule, RLModuleSpec)
from ray_tpu_torch.rllib.env import MultiAgentEnv
from ray_tpu_torch.rllib.evaluation.multi_agent_worker import (
    MultiAgentRolloutWorker)
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.evaluation.worker_set import WorkerSet
from ray_tpu_torch.rllib.models.catalog import ModelCatalog
from ray_tpu_torch.rllib.offline import JsonReader, JsonWriter
from ray_tpu_torch.rllib.policy.q_policy import QPolicy
from ray_tpu_torch.rllib.policy.sac_policy import SACPolicy
from ray_tpu_torch.rllib.policy.sample_batch import (MultiAgentBatch,
                                                     SampleBatch)
from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy, compute_gae
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)

__all__ = ["A2C", "A2CConfig", "A3C", "A3CConfig", "APPO", "APPOConfig",
           "ARS", "ARSConfig", "Algorithm", "AlgorithmConfig", "ApexDQN",
           "ApexDQNConfig", "BC", "BCConfig", "CQL", "CQLConfig", "DDPG",
           "DDPGConfig", "DQN", "DQNConfig", "ES", "ESConfig", "Impala",
           "ImpalaConfig", "JsonReader", "JsonWriter", "Learner",
           "LearnerConfig", "LearnerGroup", "MARWIL", "MARWILConfig",
           "MLPActorCriticModule", "ModelCatalog", "MultiAgentBatch",
           "MultiAgentEnv", "MultiAgentRolloutWorker", "PG", "PGConfig",
           "PPO", "PPOConfig", "PPOLearner", "PrioritizedReplayBuffer",
           "QPolicy", "RLModule", "RLModuleSpec", "ReplayBuffer",
           "RolloutWorker", "SAC", "SACConfig", "SACPolicy", "SampleBatch",
           "SimpleQ", "SimpleQConfig", "TD3", "TD3Config", "TorchPolicy",
           "WorkerSet", "compute_gae"]
