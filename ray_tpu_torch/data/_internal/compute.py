"""Compute strategies: tasks vs. autoscaling actor pools.

Analog of the reference's python/ray/data/_internal/compute.py
(TaskPoolStrategy / ActorPoolStrategy): a one-to-one stage maps a block
transform over every block either as independent tasks (default) or on a
pool of long-lived actors (amortizing expensive UDF construction, e.g. a
model loaded onto a TPU chip for batch inference).

Both paths stream: at most ``max_in_flight`` block transforms are
outstanding, and results are yielded as they finish (the round-1 analog of
the reference's streaming executor backpressure,
data/_internal/execution/streaming_executor.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata


@dataclass
class TaskPoolStrategy:
    size: Optional[int] = None  # max concurrent tasks (None = unbounded-ish)


class ActorPoolStrategy:
    """Autoscaling pool of UDF actors (reference: compute.py ActorPoolStrategy:
    min_size..max_size actors, each processing blocks serially)."""

    def __init__(self, min_size: int = 1, max_size: Optional[int] = None,
                 max_tasks_in_flight_per_actor: int = 2):
        if max_size is None:
            max_size = max(min_size, 2)
        if min_size < 1 or max_size < min_size:
            raise ValueError("Need 1 <= min_size <= max_size")
        self.min_size = min_size
        self.max_size = max_size
        self.max_tasks_in_flight_per_actor = max_tasks_in_flight_per_actor


ComputeStrategy = Any  # TaskPoolStrategy | ActorPoolStrategy | str


def resolve_compute(compute) -> ComputeStrategy:
    if compute is None or compute == "tasks":
        return TaskPoolStrategy()
    if compute == "actors":
        return ActorPoolStrategy()
    if isinstance(compute, (TaskPoolStrategy, ActorPoolStrategy)):
        return compute
    raise ValueError(f"Unknown compute strategy: {compute!r}")


def _apply_transform(block: Block, fn_bytes: bytes,
                     meta_only: bool) -> Tuple[Block, BlockMetadata]:
    """Worker-side: run a pickled block transform."""
    import cloudpickle
    fn = cloudpickle.loads(fn_bytes)
    out = fn(block)
    acc = BlockAccessor.for_block(out)
    return out, acc.get_metadata()


_transform_task = None


def _get_transform_task(num_cpus: float):
    global _transform_task
    if _transform_task is None:
        _transform_task = ray_tpu_torch.remote(_apply_transform)
    return _transform_task.options(num_cpus=num_cpus, num_returns=2)


class _BlockTransformActor:
    """Actor wrapper executing a (possibly stateful) block transform.

    For callable-class UDFs the class is constructed once here and reused
    for every block (reference: data/_internal/compute.py BlockWorker).
    """

    def __init__(self, fn_constructor_bytes: Optional[bytes]):
        import cloudpickle
        self._udf_instance = None
        if fn_constructor_bytes is not None:
            ctor, args, kwargs = cloudpickle.loads(fn_constructor_bytes)
            self._udf_instance = ctor(*args, **kwargs)

    def ready(self):
        return True

    def apply(self, block: Block, fn_bytes: bytes):
        import cloudpickle
        fn = cloudpickle.loads(fn_bytes)
        if self._udf_instance is not None:
            out = fn(block, self._udf_instance)
        else:
            out = fn(block)
        acc = BlockAccessor.for_block(out)
        return out, acc.get_metadata()
