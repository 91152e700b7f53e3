"""@serve.batch: transparent dynamic request batching, adaptively tuned.

The port's copy of ``ray_tpu/serve/batching.py`` (unchanged but for its
imports, which are the port's own). Analog of the reference's
serve/batching.py: an async method decorated
with ``@serve.batch`` receives a *list* of inputs; concurrent callers are
coalesced until the batch fills or the wait timeout elapses, then the
underlying function runs once and each caller gets its element of the
returned list. The core TPU win: replicas batch independent HTTP/handle
requests into one MXU-sized ``pjit`` call.

**Adaptive micro-batching** (this module's throughput engine): with a
latency budget — ``@serve.batch(target_latency_s=...)`` or the
``RAY_TPU_serve_batch_target_latency_ms`` flag — the queue tunes its own
operating point online instead of serving the static knobs. Each
request's queue+execute latency feeds a sliding window; every
``_ADJUST_EVERY`` batches the observed p95 is compared to the budget and
the live ``(max_batch_size, wait_timeout)`` pair moves AIMD-style:

* p95 over budget → multiplicative decrease (halve the batch-size cap,
  halve the wait) — under light traffic the wait timeout dominates
  latency, so shedding it restores the budget immediately;
* p95 under ``_HEADROOM`` of budget → additive increase (cap +1, wait
  ×1.5 toward the configured maxima) — under saturating traffic batches
  fill before the timeout and the cap climbs back to the MXU-sized
  batch that maximizes throughput.

The decorated knobs are *ceilings*; adaptation only moves inside
``[1, max_batch_size]`` × ``[min_wait, batch_wait_timeout_s]``. The live
operating point is observable: ``ray_tpu_serve_batch_size`` (last
executed batch) and ``ray_tpu_serve_batch_size_limit`` (current cap)
gauges, and ``wrapper.batch_stats()`` for tests/CLI.
"""

from __future__ import annotations

import asyncio
import functools
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import builtin_metrics

# Adaptation cadence and shape. Not config flags: these are internal
# loop-stability constants, not operator-facing knobs.
_ADJUST_EVERY = 8        # batches between AIMD adjustments
_LATENCY_WINDOW = 256    # per-request latency samples kept
_HEADROOM = 0.7          # grow only while p95 < _HEADROOM * budget
_MIN_WAIT_S = 0.0005     # wait floor: never spin at zero under load


def _percentile(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return ordered[idx]


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, timeout_s: float,
                 target_latency_s: Optional[float], name: str):
        self._fn = fn
        self._max = max_batch_size          # ceiling (decorator knob)
        self._timeout = timeout_s           # ceiling (decorator knob)
        self._target = target_latency_s     # None = fixed batching
        self._name = name
        # Live operating point (== ceilings when not adaptive).
        self.cur_max = max_batch_size
        self.cur_timeout = timeout_s
        self._queue: Optional[asyncio.Queue] = None
        self._loop_task = None
        # Adaptation state.
        self._latencies: deque = deque(maxlen=_LATENCY_WINDOW)
        self._batches = 0
        self._items = 0
        self._last_batch_size = 0
        self._shrinks = 0
        self._grows = 0

    def _ensure_loop(self):
        if self._queue is None:
            self._queue = asyncio.Queue()
            self._loop_task = asyncio.get_event_loop().create_task(
                self._batch_loop())

    async def _batch_loop(self):
        while True:
            first = await self._queue.get()
            batch = [first]
            loop = asyncio.get_event_loop()
            deadline = loop.time() + self.cur_timeout
            while len(batch) < self.cur_max:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                try:
                    item = await asyncio.wait_for(self._queue.get(),
                                                  remaining)
                    batch.append(item)
                except asyncio.TimeoutError:
                    break
            args = [item[0] for item in batch]
            futures = [item[1] for item in batch]
            enqueue_times = [item[2] for item in batch]
            try:
                results = await self._fn(args)
                if len(results) != len(batch):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} "
                        f"results for a batch of {len(batch)}")
                for fut, res in zip(futures, results):
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:  # noqa: BLE001 - propagate per caller
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
            self._observe(len(batch), enqueue_times)

    def _observe(self, batch_size: int, enqueue_times: List[float]) -> None:
        """Feed one executed batch into the adaptation state + gauges."""
        self._batches += 1
        self._items += batch_size
        self._last_batch_size = batch_size
        builtin_metrics.serve_batch_size().set(
            batch_size, tags={"fn": self._name})
        if self._target is None:
            return
        done = time.monotonic()
        self._latencies.extend(done - t for t in enqueue_times)
        if self._batches % _ADJUST_EVERY == 0:
            self._adjust()

    def _adjust(self) -> None:
        """One AIMD step of the (cap, wait) operating point against the
        observed request-latency p95."""
        p95 = _percentile(list(self._latencies), 0.95)
        if p95 > self._target:
            self.cur_max = max(1, self.cur_max // 2)
            self.cur_timeout = max(_MIN_WAIT_S, self.cur_timeout / 2)
            self._shrinks += 1
        elif p95 < _HEADROOM * self._target:
            if self.cur_max < self._max:
                self.cur_max += 1
                self._grows += 1
            if self.cur_timeout < self._timeout:
                self.cur_timeout = min(self._timeout,
                                       self.cur_timeout * 1.5)
        builtin_metrics.serve_batch_size_limit().set(
            self.cur_max, tags={"fn": self._name})

    async def submit(self, arg):
        self._ensure_loop()
        fut = asyncio.get_event_loop().create_future()
        await self._queue.put((arg, fut, time.monotonic()))
        return await fut

    def stats(self) -> Dict[str, Any]:
        return {
            "adaptive": self._target is not None,
            "target_latency_s": self._target,
            "max_batch_size": self._max,
            "cur_max_batch_size": self.cur_max,
            "batch_wait_timeout_s": self._timeout,
            "cur_wait_timeout_s": self.cur_timeout,
            "batches": self._batches,
            "items": self._items,
            "last_batch_size": self._last_batch_size,
            "mean_batch_size": (self._items / self._batches
                                if self._batches else 0.0),
            "p95_latency_s": _percentile(list(self._latencies), 0.95),
            "shrinks": self._shrinks,
            "grows": self._grows,
        }


def _default_target_latency_s() -> Optional[float]:
    """Cluster-level latency budget for queues that don't declare one:
    RAY_TPU_serve_batch_target_latency_ms (0 = fixed batching)."""
    from ray_tpu_torch.serve._private.common import serve_config
    ms = serve_config("serve_batch_target_latency_ms", 0.0)
    return (ms / 1000.0) if ms and ms > 0 else None


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01,
          target_latency_s: Optional[float] = None):
    """``@serve.batch`` / ``@serve.batch(max_batch_size=…)``.

    With ``target_latency_s`` (or the cluster flag
    ``RAY_TPU_serve_batch_target_latency_ms``) the queue adapts its
    batch size and wait timeout online against that p95 budget; the
    decorator knobs become ceilings. Without either, batching is fixed
    at the declared knobs (the original behavior)."""

    def decorator(fn):
        queues: Dict[Any, _BatchQueue] = {}  # per-instance (or one for
        # free functions)

        if not asyncio.iscoroutinefunction(fn):
            raise TypeError(
                f"@serve.batch requires an async (``async def``) "
                f"function; {getattr(fn, '__name__', fn)!r} is "
                f"synchronous. Batched callers park on an asyncio "
                f"future, so a sync handler would deadlock the "
                f"replica's event loop.")

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            # Accepted shapes: fn(item) / fn(item=…) for free
            # functions, method(self, item) / method(self, item=…) for
            # methods. The single request argument may arrive
            # positionally or as a keyword — kwargs used to be silently
            # dropped here, stalling the caller forever.
            if len(args) + len(kwargs) == 2 and len(args) >= 1:
                owner = args[0]
                arg = args[1] if len(args) == 2 else \
                    next(iter(kwargs.values()))
                key = id(owner)
                bound = functools.partial(fn, owner)
            elif len(args) + len(kwargs) == 1:
                owner = None
                arg = args[0] if args else next(iter(kwargs.values()))
                key = None
                bound = fn
            else:
                raise TypeError(
                    "@serve.batch functions take exactly one request "
                    "argument (positional or keyword); got "
                    f"{len(args)} positional and {len(kwargs)} keyword "
                    "arguments")
            q = queues.get(key)
            if q is None:
                target = target_latency_s
                if target is None:
                    target = _default_target_latency_s()
                q = _BatchQueue(bound, max_batch_size,
                                batch_wait_timeout_s, target,
                                getattr(fn, "__qualname__",
                                        getattr(fn, "__name__", "batch")))
                queues[key] = q
            return await q.submit(arg)

        def batch_stats(instance: Any = None) -> Optional[Dict[str, Any]]:
            """Live stats of the batch queue bound to ``instance``
            (None for a free function)."""
            q = queues.get(None if instance is None else id(instance))
            return q.stats() if q is not None else None

        wrapper.batch_stats = batch_stats
        wrapper._batch_queues = queues
        return wrapper

    if _fn is not None:
        return decorator(_fn)
    return decorator
