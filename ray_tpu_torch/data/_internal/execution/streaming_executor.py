"""StreamingExecutor: pipelined execution of an operator chain.

Analog of the reference's data/_internal/execution/streaming_executor.py:23
— the event loop that moves RefBundles through the operator topology.
Unlike the bulk path (stage N completes before stage N+1 starts), every
operator runs concurrently: a block can be in stage 3 while later blocks
are still being read, so the first output batch is available after one
block traverses the chain, and peak memory is bounded by the operators'
in-flight caps rather than the dataset size.
"""

from __future__ import annotations

import time
from typing import Iterator, List

from ray_tpu_torch.data._internal.execution.interfaces import (ExecutionOptions,
                                                         PhysicalOperator,
                                                         RefBundle)


class StreamingExecutor:
    def __init__(self, options: ExecutionOptions = None):
        self.options = options or ExecutionOptions()

    def execute(self, operators: List[PhysicalOperator]
                ) -> Iterator[RefBundle]:
        """Run the chain (operators[0] is the input buffer) and yield the
        final operator's bundles as they complete."""
        if not operators:
            return
        import ray_tpu_torch
        budget = self.options.max_in_flight_bytes
        try:
            done_flags = [False] * len(operators)
            while True:
                progressed = False
                # Resource-aware backpressure: operator i may hold
                # (in-flight + output) bytes up to the topology budget
                # minus what everything DOWNSTREAM of it already holds —
                # the sink gets budget first (so it keeps draining, no
                # deadlock) and upstream launches throttle as the chain
                # backs up (reference: per-operator resource accounting
                # in the streaming executor, interfaces.py:158
                # ExecutionResources).
                budgets = [float("inf")] * len(operators)
                suffix = 0
                for i in range(len(operators) - 1, -1, -1):
                    budgets[i] = budget - suffix
                    suffix += operators[i].buffered_bytes()
                # Move bundles downstream (upstream-first so a bundle can
                # traverse several operators in one pass).
                for i, op in enumerate(operators):
                    if i > 0:
                        op.work(byte_budget=budgets[i])
                    is_last = i == len(operators) - 1
                    if is_last:
                        continue
                    downstream = operators[i + 1]
                    # Transfer is throttled by the downstream budget too:
                    # bundles wait in the producer (where they are already
                    # counted) instead of inflating downstream queues. An
                    # empty downstream always accepts one bundle, so even
                    # a block bigger than the whole budget progresses.
                    while op.has_next() and (
                            downstream.buffered_bytes() < budgets[i + 1]
                            or downstream.buffered_bytes() == 0):
                        downstream.add_input(op.get_next())
                        progressed = True
                    if op.completed() and not done_flags[i]:
                        done_flags[i] = True
                        downstream.all_inputs_done()
                    downstream.work(byte_budget=budgets[i + 1])
                last = operators[-1]
                while last.has_next():
                    progressed = True
                    yield last.get_next()
                if last.completed():
                    return
                if not progressed:
                    # Block on in-flight work becoming ready instead of
                    # sleep-polling (the reference's event-driven loop);
                    # the short timeout covers non-ref progress sources
                    # (actor autoscaling, barrier stages).
                    refs = [r for op in operators
                            for r in op.active_refs()]
                    if refs:
                        ray_tpu_torch.wait(refs, num_returns=1, timeout=0.2)
                    else:
                        time.sleep(0.002)
        finally:
            for op in operators:
                op.shutdown()
