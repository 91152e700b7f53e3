"""Training entry points of the port: ``TorchTrainer`` over the gang of
the task/actor runtime (``train.torch``, the counterpart of
``ray_tpu/train/jax``), the process group and mesh inside a worker
(``prepare_mesh``), and sharded checkpoints in the JAX package's format
(``ShardedCheckpoint``; the port's train state saved and restored by
``save_train_state`` and ``restore_train_state``, or reported by
``session.report_sharded``), and batch inference (``TorchPredictor``,
``BatchPredictor``)."""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train._internal.sharded_checkpoint import ShardedCheckpoint
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer, DataParallelTrainer
from ray_tpu_torch.train.predictor import (BatchPredictor, Predictor,
                                           TorchPredictor)
from ray_tpu_torch.train.torch import (TorchBackendConfig, TorchTrainer,
                                       prepare_mesh)
from ray_tpu_torch.train.torch.checkpoint import (latest_checkpoint,
                                                  restore_train_state,
                                                  save_train_state)

__all__ = [
    "Backend",
    "BackendConfig",
    "BaseTrainer",
    "BatchPredictor",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "DataParallelTrainer",
    "FailureConfig",
    "Predictor",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "ShardedCheckpoint",
    "TorchBackendConfig",
    "TorchPredictor",
    "TorchTrainer",
    "latest_checkpoint",
    "prepare_mesh",
    "restore_train_state",
    "save_train_state",
]
