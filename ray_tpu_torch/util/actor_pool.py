"""ActorPool: distribute work over a fixed set of actors.

Analog of the reference's python/ray/util/actor_pool.py (same public
surface: map / map_unordered / submit / get_next / get_next_unordered /
push / pop_idle / has_free / has_next).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]
            ) -> Iterator[Any]:
        """fn(actor, value) -> ObjectRef; yields results in order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn, values) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn, value) -> None:
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            # Wait for any in-flight task, recycle its actor, retry.
            ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                    num_returns=1)
            self._return_actor(ready[0])
            self.submit(fn, value)

    def _return_actor(self, future) -> None:
        _, actor = self._future_to_actor[future]
        self._idle.append(actor)

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        if not self.has_next():
            raise StopIteration("No more results to get")
        future = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        res = ray_tpu_torch.get([future], timeout=timeout)[0]
        idx, actor = self._future_to_actor.pop(future)
        self._idle.append(actor)
        return res

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        if not self.has_next():
            raise StopIteration("No more results to get")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise TimeoutError("Timed out waiting for result")
        future = ready[0]
        idx, actor = self._future_to_actor.pop(future)
        self._index_to_future.pop(idx, None)
        self._idle.append(actor)
        return ray_tpu_torch.get([future])[0]

    def has_free(self) -> bool:
        return bool(self._idle)

    def push(self, actor) -> None:
        self._idle.append(actor)

    def pop_idle(self) -> Optional[Any]:
        return self._idle.pop() if self._idle else None
