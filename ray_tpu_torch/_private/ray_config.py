"""Runtime flags read from the environment: the part of
``ray_tpu/_private/ray_config.py`` that the port's checkpoints and
``@serve.batch`` read.

The JAX package first asks a live runtime's config table and keeps its
defaults in a native library; the port has neither, so a flag is the
``RAY_TPU_<name>`` environment variable coerced to its default's type, or
the default. The names and defaults are the JAX package's, so one
environment sets both packages alike.
"""

from __future__ import annotations

import os
from typing import Any

_PY_DEFAULTS = {
    # Sharded checkpoints: reader-side fan-out of per-parameter loads, and
    # whether full-block restores and GC validate crc32 checksums.
    "train_ckpt_shard_parallelism": 8,
    "train_ckpt_verify_checksums": True,
    # Batch queues with no declared target adapt against this latency
    # budget (0 = fixed batching; serve/batching.py).
    "serve_batch_target_latency_ms": 0.0,
}


def runtime_config_value(name: str, default: Any) -> Any:
    """The raw ``RAY_TPU_<name>`` env var coerced to the default's type,
    else the default."""
    env = os.environ.get(f"RAY_TPU_{name}")
    if env is None:
        return default
    if isinstance(default, bool):
        return env.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        try:
            return int(float(env))
        except ValueError:
            return default
    if isinstance(default, float):
        try:
            return float(env)
        except ValueError:
            return default
    return env
