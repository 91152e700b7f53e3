"""Lazy execution plan: fused one-to-one stages + all-to-all stages.

Analog of the reference's data/_internal/plan.py (ExecutionPlan + stage
fusion) and the logical planner (data/_internal/logical/): a Dataset holds
input blocks plus a chain of stages; execution fuses adjacent one-to-one
stages into a single task per block (so `.map_batches(f).filter(g)` costs
one task per block, not two) and materializes all-to-all stages (shuffle,
sort, repartition) through the 2-stage push-based shuffle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data._internal.compute import (ComputeStrategy, TaskPoolStrategy,
                                            resolve_compute)
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata


@dataclass
class OneToOneStage:
    """A per-block transform (map_batches / map / filter / flat_map /...)."""

    name: str
    transform: Callable[[Block], Block]
    compute: ComputeStrategy = field(default_factory=TaskPoolStrategy)
    num_cpus: float = 1.0
    udf_constructor: Optional[tuple] = None

    def can_fuse_with(self, other: "OneToOneStage") -> bool:
        # Actor stages don't fuse (each needs its own pool); plain task
        # stages with matching resources fuse freely.
        return (isinstance(self.compute, TaskPoolStrategy)
                and isinstance(other.compute, TaskPoolStrategy)
                and self.num_cpus == other.num_cpus
                and self.udf_constructor is None
                and other.udf_constructor is None)

    def fuse(self, other: "OneToOneStage") -> "OneToOneStage":
        first, second = self.transform, other.transform

        def fused(block):
            return second(first(block))

        return OneToOneStage(
            name=f"{self.name}->{other.name}", transform=fused,
            compute=other.compute, num_cpus=max(self.num_cpus, other.num_cpus))


@dataclass
class AllToAllStage:
    """A global re-organization (shuffle / sort / repartition / groupby).

    ``fn(block_refs, metas) -> (block_refs, metas)``.
    """

    name: str
    fn: Callable[[List[Any], List[BlockMetadata]],
                 Tuple[List[Any], List[BlockMetadata]]]


class ExecutionPlan:
    def __init__(self, blocks: List[Any], metadata: List[BlockMetadata],
                 stages: Optional[List[Any]] = None):
        self._in_blocks = list(blocks)
        self._in_metadata = list(metadata)
        self._stages: List[Any] = list(stages or [])
        self._out: Optional[Tuple[List[Any], List[BlockMetadata]]] = None

    def with_stage(self, stage) -> "ExecutionPlan":
        if self._out is not None:
            # Build on the materialized snapshot to avoid recomputation.
            return ExecutionPlan(self._out[0], self._out[1], [stage])
        return ExecutionPlan(self._in_blocks, self._in_metadata,
                             self._stages + [stage])

    def stage_names(self) -> List[str]:
        return [s.name for s in self._stages]

    def _fused_stages(self) -> List[Any]:
        fused: List[Any] = []
        for stage in self._stages:
            if (fused and isinstance(stage, OneToOneStage)
                    and isinstance(fused[-1], OneToOneStage)
                    and fused[-1].can_fuse_with(stage)):
                fused[-1] = fused[-1].fuse(stage)
            else:
                fused.append(stage)
        return fused

    def _build_operators(self, options=None):
        """Fused stages → physical operator chain (reference: the logical →
        physical planning in data/_internal/logical/planner.py)."""
        from ray_tpu_torch.data._internal.execution import (AllToAllOperator,
                                                      ExecutionOptions,
                                                      InputDataBuffer,
                                                      MapOperator)
        options = options or ExecutionOptions(
            # Match the bulk path's old default: wide inputs run wide.
            max_in_flight_per_operator=max(8, len(self._in_blocks)))
        ops = [InputDataBuffer(self._in_blocks, self._in_metadata)]
        for stage in self._fused_stages():
            if isinstance(stage, OneToOneStage):
                ops.append(MapOperator(
                    stage.name, stage.transform, stage.compute,
                    stage.num_cpus, stage.udf_constructor,
                    max_in_flight=options.max_in_flight_per_operator))
            else:
                ops.append(AllToAllOperator(stage.name, stage.fn))
        return ops

    def iter_execute(self):
        """Stream (block_ref, metadata) pairs through the operator chain —
        consecutive map stages with different compute strategies pipeline
        against each other instead of materializing between them. Caches
        the full result when fully consumed."""
        if self._out is not None:
            yield from zip(*self._out)
            return
        from ray_tpu_torch.data._internal.execution import StreamingExecutor
        out_blocks: List[Any] = []
        out_metas: List[BlockMetadata] = []
        for bundle in StreamingExecutor().execute(self._build_operators()):
            for block_ref, meta in bundle.blocks:
                if isinstance(meta, ray_tpu_torch.ObjectRef):
                    meta = ray_tpu_torch.get(meta)
                out_blocks.append(block_ref)
                out_metas.append(meta)
                yield block_ref, meta
        self._out = (out_blocks, out_metas)

    def execute(self) -> Tuple[List[Any], List[BlockMetadata]]:
        if self._out is not None:
            return self._out
        for _ in self.iter_execute():
            pass
        return self._out

    def is_executed(self) -> bool:
        return self._out is not None

    def clear_cache(self) -> None:
        self._out = None
