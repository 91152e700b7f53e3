"""The checkpoint part of ``ray_tpu/air/config.py``: ``CheckpointConfig``.
The rest (``ScalingConfig``, ``RunConfig``, ``FailureConfig``) configures
the trainer's gang, which waits for the task/actor runtime
(``ROADMAP.md`` queue 1, item 7)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class CheckpointConfig:
    """reference: air/config.py CheckpointConfig."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False
