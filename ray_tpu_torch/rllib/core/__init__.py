"""ray_tpu_torch.rllib.core: the RLlib "new stack".

Analog of the reference's embryonic rllib/core (SURVEY.md §2.6:
rl_module/rl_module.py, rl_trainer/trainer_runner.py), redesigned
TPU-first: RLModule is a *functional* network description (pure init/apply
over pytree params), Learner owns one jitted update built from a
compute_loss, and LearnerGroup is the TrainerRunner analog with two
scale-out modes — SPMD (one pjit update sharded over the device mesh's
``dp`` axis; gradients ride ICI via GSPMD-inserted psums) and remote
(learner actors computing gradients that the group averages), covering the
reference's multi-GPU-learner capability on TPU.
"""

from ray_tpu_torch.rllib.core.learner import Learner, LearnerConfig, PPOLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (MLPActorCriticModule, RLModule,
                                          RLModuleSpec)

__all__ = ["Learner", "LearnerConfig", "LearnerGroup",
           "MLPActorCriticModule", "PPOLearner", "RLModule", "RLModuleSpec"]
