"""ray_tpu_torch.rllib: reinforcement learning on the port's runtime.

The port of ``ray_tpu/rllib`` as far as PPO's learner stack: the
``Algorithm``/``AlgorithmConfig`` driver, ``WorkerSet`` rollout actors
(CPU samplers), ``TorchPolicy`` (the port of ``JAXPolicy``), PPO with its
per-minibatch and fused SGD schedules and its learner group, multi-agent
training (``MultiAgentEnv`` + policy maps), the new-stack ``core``
(``RLModule``/``Learner``/``LearnerGroup``: a learner on a ``dp`` mesh or
remote learner actors), connectors, offline JSON IO and the model
catalog. Learners run on the CUDA card unless the config asks for the
CPU. RLlib's other algorithms, their policies and replay buffers are
ROADMAP item 10b.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
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
from ray_tpu_torch.rllib.policy.sample_batch import (MultiAgentBatch,
                                                     SampleBatch)
from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy, compute_gae

__all__ = ["Algorithm", "AlgorithmConfig", "JsonReader", "JsonWriter",
           "Learner", "LearnerConfig", "LearnerGroup",
           "MLPActorCriticModule", "ModelCatalog", "MultiAgentBatch",
           "MultiAgentEnv", "MultiAgentRolloutWorker", "PPO", "PPOConfig",
           "PPOLearner", "RLModule", "RLModuleSpec", "RolloutWorker",
           "SampleBatch", "TorchPolicy", "WorkerSet", "compute_gae"]
