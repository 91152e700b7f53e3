"""ray_tpu_torch.rllib: reinforcement learning on the port's runtime.

The port of ``ray_tpu/rllib``: the ``Algorithm``/``AlgorithmConfig``
driver, ``WorkerSet`` rollout actors (CPU samplers), ``TorchPolicy`` (the
port of ``JAXPolicy``), ``QPolicy`` and ``SACPolicy``; PPO with its
per-minibatch and fused SGD schedules and its learner group, DQN (with
SimpleQ and APEX-DQN as its configurations), Rainbow (noisy nets and C51
heads), R2D2 (recurrent sequence replay with burn-in), SAC, CQL, TD3
(and DDPG and APEX-DDPG), A2C, A3C, PG, IMPALA and APPO (V-trace), BC,
MARWIL, ES and ARS, QMIX (monotonic value factorization), MADDPG
(centralized critics), SlateQ (slate recommendation), AlphaStar (league
self-play over PPO learners), AlphaZero (MCTS with ranked rewards), CRR,
DDPPO (decentralized PPO over a collective group), Dreamer (an RSSM world
model and latent imagination), DT (the Decision Transformer), MAML and
MBMPO (first-order meta-learning, model-based for MBMPO), the LinUCB and
LinTS contextual bandits and the random baseline; prioritized, n-step
and sequence replay buffers; the tuned examples; multi-agent training
(``MultiAgentEnv`` + policy maps), the new-stack ``core``
(``RLModule``/``Learner``/``LearnerGroup``: a learner on a ``dp`` mesh or
remote learner actors), connectors, offline JSON IO and the model
catalog. Learners run on the CUDA card unless the config asks for the
CPU. The policy client and server, the synthetic Atari environment and
the algorithm registry are ROADMAP item 10b.
"""

from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.a3c import A3C, A3CConfig
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.alpha_star import (AlphaStar,
                                                       AlphaStarConfig)
from ray_tpu_torch.rllib.algorithms.alpha_zero import (AlphaZero,
                                                       AlphaZeroConfig)
from ray_tpu_torch.rllib.algorithms.apex_ddpg import ApexDDPG, ApexDDPGConfig
from ray_tpu_torch.rllib.algorithms.apex_dqn import ApexDQN, ApexDQNConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.ars import ARS, ARSConfig
from ray_tpu_torch.rllib.algorithms.bandit import (BanditConfig, BanditLinTS,
                                                   BanditLinTSConfig,
                                                   BanditLinUCB,
                                                   BanditLinUCBConfig)
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.crr import CRR, CRRConfig
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig
from ray_tpu_torch.rllib.algorithms.ddppo import DDPPO, DDPPOConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.dreamer import Dreamer, DreamerConfig
from ray_tpu_torch.rllib.algorithms.dt import DT, DTConfig
from ray_tpu_torch.rllib.algorithms.es import ES, ESConfig
from ray_tpu_torch.rllib.algorithms.impala import Impala, ImpalaConfig
from ray_tpu_torch.rllib.algorithms.maddpg import MADDPG, MADDPGConfig
from ray_tpu_torch.rllib.algorithms.maml import MAML, MAMLConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.mbmpo import MBMPO, MBMPOConfig
from ray_tpu_torch.rllib.algorithms.pg import PG, PGConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.qmix import QMix, QMixConfig
from ray_tpu_torch.rllib.algorithms.r2d2 import R2D2, R2D2Config
from ray_tpu_torch.rllib.algorithms.rainbow import Rainbow, RainbowConfig
from ray_tpu_torch.rllib.algorithms.random_agent import (RandomAgent,
                                                         RandomAgentConfig)
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.simple_q import SimpleQ, SimpleQConfig
from ray_tpu_torch.rllib.algorithms.slateq import SlateQ, SlateQConfig
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
           "ARS", "ARSConfig", "Algorithm", "AlgorithmConfig", "AlphaStar",
           "AlphaStarConfig", "AlphaZero", "AlphaZeroConfig", "ApexDDPG",
           "ApexDDPGConfig", "ApexDQN", "ApexDQNConfig", "BC", "BCConfig",
           "BanditConfig", "BanditLinTS", "BanditLinTSConfig", "BanditLinUCB",
           "BanditLinUCBConfig", "CQL", "CQLConfig", "CRR", "CRRConfig",
           "DDPG", "DDPGConfig", "DDPPO", "DDPPOConfig", "DQN", "DQNConfig",
           "DT", "DTConfig", "Dreamer", "DreamerConfig", "ES", "ESConfig",
           "Impala", "ImpalaConfig", "JsonReader", "JsonWriter", "Learner",
           "LearnerConfig", "LearnerGroup", "MADDPG", "MADDPGConfig", "MAML",
           "MAMLConfig", "MARWIL", "MARWILConfig", "MBMPO", "MBMPOConfig",
           "MLPActorCriticModule", "ModelCatalog", "MultiAgentBatch",
           "MultiAgentEnv", "MultiAgentRolloutWorker", "PG", "PGConfig",
           "PPO", "PPOConfig", "PPOLearner", "PrioritizedReplayBuffer",
           "QMix", "QMixConfig", "QPolicy", "R2D2", "R2D2Config", "RLModule",
           "RLModuleSpec", "Rainbow", "RainbowConfig", "RandomAgent",
           "RandomAgentConfig", "ReplayBuffer", "RolloutWorker", "SAC",
           "SACConfig", "SACPolicy", "SampleBatch", "SimpleQ",
           "SimpleQConfig", "SlateQ", "SlateQConfig", "TD3", "TD3Config",
           "TorchPolicy", "WorkerSet", "compute_gae"]
