"""Streaming-execution interfaces.

Analog of the reference's data/_internal/execution/interfaces.py
(PhysicalOperator :158, RefBundle): datasets execute as a chain of
physical operators that exchange bundles of block references. Operators
pull inputs as upstream produces them and bound their own in-flight work,
so blocks flow through the whole chain without materializing any
intermediate dataset — the memory high-water mark is O(in-flight blocks),
not O(dataset).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class RefBundle:
    """A group of (block_ref, metadata) pairs moving between operators.
    Metadata may itself still be a ref while the block is in flight."""

    blocks: List[Tuple[Any, Any]]  # [(block_ref, meta_or_meta_ref)]

    def block_refs(self) -> List[Any]:
        return [b for b, _ in self.blocks]


@dataclass
class ExecutionOptions:
    """Resource bounds for a streaming run (the analog of the reference's
    ExecutionResources limits on the StreamingExecutor)."""

    max_in_flight_per_operator: int = 8
    # Topology-wide cap on bytes buffered in flight (launched inputs +
    # unconsumed outputs). When exceeded, upstream operators stop
    # LAUNCHING (downstream keeps draining), so peak memory is bounded
    # by this budget instead of the dataset size (reference: operator
    # resource accounting in streaming_executor.py:23 /
    # ExecutionResources).
    max_in_flight_bytes: int = 512 * 1024 * 1024


class PhysicalOperator:
    """One stage of a streaming dataset topology.

    Lifecycle: ``add_input`` is called as upstream bundles arrive, then
    ``all_inputs_done`` exactly once; the executor polls ``work`` to let
    the operator launch/collect tasks, drains ``get_next`` while
    ``has_next``, and considers the operator finished when ``completed``.
    """

    def __init__(self, name: str):
        self.name = name

    def add_input(self, bundle: RefBundle) -> None:
        raise NotImplementedError

    def all_inputs_done(self) -> None:
        self._inputs_done = True

    def work(self, byte_budget: float = float("inf")) -> None:
        """Launch new tasks / collect finished ones (non-blocking).
        ``byte_budget`` is how many in-flight + output bytes this
        operator may hold before it must stop LAUNCHING (collection
        always proceeds); the executor derives it from
        ``ExecutionOptions.max_in_flight_bytes`` minus what downstream
        operators are already holding."""

    def active_refs(self) -> List[Any]:
        """Refs the executor may block on instead of sleep-polling: one
        becoming ready means ``work`` can make progress."""
        return []

    def buffered_bytes(self) -> int:
        """Bytes this operator holds in flight: launched-but-unfinished
        inputs plus produced-but-unconsumed outputs. Drives topology
        backpressure."""
        return 0

    def has_next(self) -> bool:
        raise NotImplementedError

    def get_next(self) -> RefBundle:
        raise NotImplementedError

    def completed(self) -> bool:
        raise NotImplementedError

    def num_active_tasks(self) -> int:
        return 0

    def shutdown(self) -> None:
        """Release operator resources (actor pools etc.)."""
