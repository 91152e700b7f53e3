"""Distributed FIFO queue backed by an async actor.

Analog of the reference's python/ray/util/queue.py: a named actor holds an
asyncio.Queue; any worker can put/get with optional blocking + timeout.
"""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        import asyncio
        self._q = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None):
        import asyncio
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item):
        import asyncio
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None):
        import asyncio
        if timeout is None:
            return (True, await self._q.get())
        try:
            return (True, await asyncio.wait_for(self._q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    async def get_nowait(self):
        import asyncio
        try:
            return (True, self._q.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    async def qsize(self):
        return self._q.qsize()

    async def empty(self):
        return self._q.empty()

    async def full(self):
        return self._q.full()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        cls = ray_tpu_torch.remote(_QueueActor)
        if actor_options:
            cls = cls.options(**actor_options)
        self.actor = cls.remote(maxsize)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full()
            return
        ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full()

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty()
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty()
        return item

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        for item in items:
            self.put_nowait(item)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return [self.get_nowait() for _ in range(num_items)]

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
