"""Physical operators for the streaming executor.

Analogs of the reference's data/_internal/execution/operators/: the input
buffer, the task/actor map operator (with bounded in-flight work and
in-order output), and the all-to-all barrier operator wrapping shuffle-like
stage functions.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data._internal.execution.interfaces import (PhysicalOperator,
                                                         RefBundle)


class InputDataBuffer(PhysicalOperator):
    """Feeds the topology from a materialized list of input blocks."""

    def __init__(self, blocks: List[Any], metadata: List[Any]):
        super().__init__("Input")
        self._bundles = [RefBundle([(b, m)])
                         for b, m in zip(blocks, metadata)]
        self._i = 0

    def add_input(self, bundle: RefBundle) -> None:
        raise RuntimeError("InputDataBuffer has no upstream")

    def has_next(self) -> bool:
        return self._i < len(self._bundles)

    def get_next(self) -> RefBundle:
        out = self._bundles[self._i]
        self._i += 1
        return out

    def completed(self) -> bool:
        return self._i >= len(self._bundles)


class MapOperator(PhysicalOperator):
    """Applies a block transform as remote tasks (or an actor pool),
    bounded in-flight, emitting outputs in input order (datasets are
    ordered)."""

    def __init__(self, name: str, transform: Callable,
                 compute=None, num_cpus: float = 1.0,
                 udf_constructor=None, max_in_flight: int = 8):
        super().__init__(name)
        import cloudpickle

        from ray_tpu_torch.data._internal.compute import (ActorPoolStrategy,
                                                    _BlockTransformActor,
                                                    _get_transform_task)
        self._fn_bytes = cloudpickle.dumps(transform)
        self._inputs_done = False
        self._queue: List[RefBundle] = []       # not yet launched
        self._in_flight: List[tuple] = []       # ordered (out_ref, meta_ref)
        self._outputs: List[RefBundle] = []
        self._in_flight_bytes = 0               # launched input payloads
        self._out_bytes = 0                     # unconsumed output payloads
        self._queue_bytes = 0                   # queued (unlaunched) inputs
        self._launch_bytes: Dict[int, int] = {}  # id(refs) -> input bytes
        self._pool = None
        self._per_actor: Dict[int, int] = {}
        self._actor_cap = 0
        self._actor_of: Dict[int, int] = {}     # id(refs) -> actor idx
        if isinstance(compute, ActorPoolStrategy):
            self._ctor_bytes = (cloudpickle.dumps(udf_constructor)
                                if udf_constructor is not None else None)
            self._actor_cls = ray_tpu_torch.remote(_BlockTransformActor)
            self._num_cpus = num_cpus
            self._pool = []
            self._pool_max = compute.max_size or max(compute.min_size, 1)
            self._actor_cap = compute.max_tasks_in_flight_per_actor
            for _ in range(max(compute.min_size, 1)):
                self._spawn_actor()
            self._max_in_flight = self._pool_max * self._actor_cap
        else:
            self._task = _get_transform_task(num_cpus)
            # TaskPoolStrategy.size is a user-set concurrency bound.
            self._max_in_flight = getattr(compute, "size", None) or \
                max_in_flight

    def _spawn_actor(self) -> None:
        idx = len(self._pool)
        self._pool.append(self._actor_cls.options(
            num_cpus=self._num_cpus).remote(self._ctor_bytes))
        self._per_actor[idx] = 0

    def add_input(self, bundle: RefBundle) -> None:
        # Normalize to one block per queue entry — upstream bundles may
        # group several blocks (RefBundle's contract), and every block must
        # be launched.
        for block_ref, meta in bundle.blocks:
            self._queue.append(RefBundle([(block_ref, meta)]))
            self._queue_bytes += self._meta_bytes(meta)

    @staticmethod
    def _meta_bytes(meta) -> int:
        size = getattr(meta, "size_bytes", None)
        return int(size) if size else 0

    def work(self, byte_budget: float = float("inf")) -> None:
        # Launch while count capacity remains AND the byte budget allows
        # more in-flight/output payload. The first launch is always
        # permitted when nothing is in flight (a single block larger than
        # the whole budget must still make progress).
        while self._queue and len(self._in_flight) < self._max_in_flight:
            if self._in_flight and \
                    self._in_flight_bytes + self._out_bytes >= byte_budget:
                break
            bundle = self._queue[0]
            block_ref = bundle.blocks[0][0]
            if self._pool is not None:
                target = min(self._per_actor, key=self._per_actor.get)
                if self._per_actor[target] >= self._actor_cap:
                    # Autoscale the pool toward max_size under backlog
                    # (ActorPoolStrategy semantics: min..max actors).
                    if len(self._pool) < self._pool_max:
                        self._spawn_actor()
                        target = len(self._pool) - 1
                    else:
                        break
                refs = self._pool[target].apply.options(
                    num_returns=2).remote(block_ref, self._fn_bytes)
                self._per_actor[target] += 1
                self._actor_of[id(refs)] = target
            else:
                refs = self._task.remote(block_ref, self._fn_bytes, False)
            self._queue.pop(0)
            in_bytes = self._meta_bytes(bundle.blocks[0][1])
            self._queue_bytes -= in_bytes
            self._in_flight_bytes += in_bytes
            self._launch_bytes[id(refs)] = in_bytes
            self._in_flight.append(refs)
        # Collect from the head (in-order): anything ready moves to outputs.
        while self._in_flight:
            head = self._in_flight[0]
            ready, _ = ray_tpu_torch.wait([head[1]], num_returns=1, timeout=0)
            if not ready:
                break
            self._in_flight.pop(0)
            self._in_flight_bytes -= self._launch_bytes.pop(id(head), 0)
            if self._pool is not None:
                target = self._actor_of.pop(id(head), None)
                if target is not None:
                    self._per_actor[target] -= 1
            # Resolve the (ready) metadata here: downstream operators and
            # the executor's byte accounting get concrete sizes for free.
            meta = ray_tpu_torch.get(head[1])
            self._out_bytes += self._meta_bytes(meta)
            self._outputs.append(RefBundle([(head[0], meta)]))

    def active_refs(self) -> List[Any]:
        return [refs[1] for refs in self._in_flight]

    def buffered_bytes(self) -> int:
        return self._queue_bytes + self._in_flight_bytes + self._out_bytes

    def has_next(self) -> bool:
        return bool(self._outputs)

    def get_next(self) -> RefBundle:
        out = self._outputs.pop(0)
        self._out_bytes -= self._meta_bytes(out.blocks[0][1])
        return out

    def completed(self) -> bool:
        return (self._inputs_done and not self._queue
                and not self._in_flight and not self._outputs)

    def num_active_tasks(self) -> int:
        return len(self._in_flight)

    def shutdown(self) -> None:
        if self._pool is not None:
            for a in self._pool:
                ray_tpu_torch.kill(a)
            self._pool = None


class AllToAllOperator(PhysicalOperator):
    """Barrier operator for shuffle-like stages: buffers every input
    bundle, then runs the stage function over the whole block list (the
    reference's AllToAllOperator wrapping e.g. push-based shuffle)."""

    def __init__(self, name: str,
                 fn: Callable[[List[Any], List[Any]], tuple]):
        super().__init__(name)
        self._fn = fn
        self._in_blocks: List[Any] = []
        self._in_metas: List[Any] = []
        self._inputs_done = False
        self._ran = False
        self._outputs: List[RefBundle] = []

    def add_input(self, bundle: RefBundle) -> None:
        for block_ref, meta in bundle.blocks:
            self._in_blocks.append(block_ref)
            self._in_metas.append(meta)

    def work(self, byte_budget: float = float("inf")) -> None:
        # A barrier stage is exempt from launch throttling: it runs once
        # over the full input set and blocks the chain until done.
        if self._inputs_done and not self._ran:
            self._ran = True
            metas = [ray_tpu_torch.get(m) if isinstance(m, ray_tpu_torch.ObjectRef)
                     else m for m in self._in_metas]
            blocks, out_metas = self._fn(self._in_blocks, metas)
            self._outputs = [RefBundle([(b, m)])
                             for b, m in zip(blocks, out_metas)]

    def has_next(self) -> bool:
        return bool(self._outputs)

    def get_next(self) -> RefBundle:
        return self._outputs.pop(0)

    def completed(self) -> bool:
        return self._inputs_done and self._ran and not self._outputs
