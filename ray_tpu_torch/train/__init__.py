"""Training entry points of the port: ``train.torch``, the rank-level
counterpart of ``ray_tpu/train/jax``, and sharded checkpoints in the JAX
package's format (``ShardedCheckpoint``; the port's train state saved and
restored by ``save_train_state`` and ``restore_train_state``)."""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train._internal.sharded_checkpoint import ShardedCheckpoint
from ray_tpu_torch.train.torch.checkpoint import (latest_checkpoint,
                                                  restore_train_state,
                                                  save_train_state)

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "ShardedCheckpoint",
    "latest_checkpoint",
    "restore_train_state",
    "save_train_state",
]
