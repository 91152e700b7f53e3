"""AIR of the port: ``Checkpoint`` and ``CheckpointConfig``, the
counterparts of ``ray_tpu/air``'s."""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig

__all__ = ["Checkpoint", "CheckpointConfig"]
