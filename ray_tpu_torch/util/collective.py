"""Host-driven collective communication across actors/tasks.

API-compatible analog of the reference's `ray.util.collective`
(python/ray/util/collective/collective.py:258-655: init_collective_group /
allreduce / broadcast / allgather / reducescatter / barrier / send / recv).

The backend story is TPU-first (SURVEY.md §2.4): *inside* a jitted program,
collectives are XLA ICI collectives (psum/all_gather — see parallel/ and
ops/ring_attention.py) and never touch this module. This module covers the
reference's *host-driven* use case — actors exchanging arrays outside jit —
which the reference backs with NCCL/Gloo process groups. Here the rendezvous
point is a named coordinator actor (the same pattern the reference uses to
exchange the NCCL unique id), and the reduction itself runs in numpy on
the contributing host, with the dtypes jnp gives (``_combine``).

Data path: the coordinator actor carries only CONTROL state for large
payloads — arrays above ``_INLINE_LIMIT`` travel as ObjectRefs through
the object store / node-to-node data plane, and ``allreduce`` switches to
a bandwidth-optimal ring (scatter-reduce + allgather, the NCCL
algorithm): each rank moves 2*(world-1)/world of its bytes to a single
neighbor, instead of every rank's full array funneling through one
coordinator process (O(world x bytes) there — the round-1 design).
Small arrays keep the one-hop star path, which has lower latency.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

_COORD_NAME = "_ray_tpu_collective_coordinator"
_local = threading.local()  # per-worker-thread group registry

# Payloads above this go through the object store as refs (the
# coordinator only sees the ref); below it, inline via the coordinator
# (one hop beats put+get for small arrays). Tests may lower it to force
# the ring path on tiny arrays.
_INLINE_LIMIT = 1 << 19  # 512 KiB


class _Coordinator:
    """Async rendezvous actor: collects one contribution per rank, computes
    the collective result once, and hands it to every waiter."""

    def __init__(self):
        import asyncio
        self._rounds: Dict[str, dict] = {}
        self._lock = asyncio.Lock()

    async def contribute(self, key: str, rank: int, world: int, data,
                         combine: str):
        import asyncio
        async with self._lock:
            st = self._rounds.get(key)
            if st is None:
                st = {"parts": {}, "event": asyncio.Event(), "result": None,
                      "consumed": 0}
                self._rounds[key] = st
            st["parts"][rank] = data
            if len(st["parts"]) == world:
                st["result"] = _combine(st["parts"], world, combine)
                st["event"].set()
        await st["event"].wait()
        async with self._lock:
            st["consumed"] += 1
            result = st["result"]
            if st["consumed"] == world:
                del self._rounds[key]
        return result

    async def put_p2p(self, key: str, data):
        import asyncio
        async with self._lock:
            st = self._rounds.get(key)
            if st is None:
                st = {"parts": {}, "event": asyncio.Event(), "result": None,
                      "consumed": 0}
                self._rounds[key] = st
            st["result"] = data
            st["event"].set()
        return True

    async def get_p2p(self, key: str):
        import asyncio
        async with self._lock:
            st = self._rounds.get(key)
            if st is None:
                st = {"parts": {}, "event": asyncio.Event(), "result": None,
                      "consumed": 0}
                self._rounds[key] = st
        await st["event"].wait()
        async with self._lock:
            result = st["result"]
            del self._rounds[key]
        return result


def _combine(parts: Dict[int, Any], world: int, combine: str):
    ordered = [parts[r] for r in range(world)]
    if combine == "gather":
        return ordered
    if combine in ("sum", "product", "min", "max"):
        from ray_tpu_torch._private.device import jax_dtype
        op = {"sum": np.add, "product": np.multiply,
              "min": np.minimum, "max": np.maximum}[combine]

        def x32(a):
            a = np.asarray(a)
            return a.astype(jax_dtype(a.dtype), copy=False)

        acc = x32(ordered[0])
        for p in ordered[1:]:
            acc = op(acc, x32(p))
        return np.asarray(acc)
    if combine == "barrier":
        return None
    raise ValueError(combine)


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


class _GroupState:
    __slots__ = ("world_size", "rank", "round_ids", "p2p_live")

    def __init__(self, world_size: int, rank: int):
        self.world_size = world_size
        self.rank = rank
        self.round_ids: Dict[str, int] = {}
        # Per-channel keep-alive for refs sent out-of-band (see send()):
        # the sender must pin each object until the receiver resolves it.
        # A window of `world_size` rounds per channel is provably enough:
        # the ring is a cycle, so a send of round k on any channel
        # requires recvs that transitively require the same channel's
        # round k-(world-1) having been consumed.
        self.p2p_live: Dict[str, Any] = {}

    def next_round(self, op: str) -> int:
        n = self.round_ids.get(op, 0)
        self.round_ids[op] = n + 1
        return n


def _groups() -> Dict[str, _GroupState]:
    if not hasattr(_local, "groups"):
        _local.groups = {}
    return _local.groups


def _coordinator():
    try:
        return ray_tpu_torch.get_actor(_COORD_NAME)
    except ValueError:
        coord_cls = ray_tpu_torch.remote(_Coordinator)
        return coord_cls.options(name=_COORD_NAME,
                                 get_if_exists=True).remote()


def init_collective_group(world_size: int, rank: int,
                          backend: str = "tpu",
                          group_name: str = "default") -> None:
    """Each participant calls this once with its rank (reference:
    collective.py:151 imperative path). Registry is per worker thread —
    actors with max_concurrency=1 (the default) are safe."""
    if rank >= world_size:
        raise ValueError(f"rank {rank} >= world_size {world_size}")
    _coordinator()  # ensure it exists before the first collective
    _groups()[group_name] = _GroupState(world_size, rank)


def destroy_collective_group(group_name: str = "default") -> None:
    _groups().pop(group_name, None)


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups()


def get_rank(group_name: str = "default") -> int:
    g = _groups().get(group_name)
    return -1 if g is None else g.rank


def get_collective_group_size(group_name: str = "default") -> int:
    g = _groups().get(group_name)
    return -1 if g is None else g.world_size


def _run(group_name: str, op: str, data, combine: str):
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(
            f"Collective group {group_name!r} is not initialized on this "
            "worker; call init_collective_group first")
    rnd = g.next_round(op)
    key = f"{group_name}:{op}:{rnd}"
    coord = _coordinator()
    return ray_tpu_torch.get(
        coord.contribute.remote(key, g.rank, g.world_size, data, combine))


def _host(tensor) -> np.ndarray:
    """``tensor`` as a numpy array: a torch tensor, on the card too, is
    copied to the host, as np.asarray copies a JAX device array, and a
    bfloat16 one comes as float32 (``device.to_host``)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tensor, torch.Tensor):
        from ray_tpu_torch._private.device import to_host
        return to_host(tensor)
    return np.asarray(tensor)


def _apply_op(a: np.ndarray, b: np.ndarray, op: str) -> np.ndarray:
    return {"sum": np.add, "product": np.multiply,
            "min": np.minimum, "max": np.maximum}[op](a, b)


def _ring_allreduce(g: _GroupState, group_name: str, arr: np.ndarray,
                    op: str) -> np.ndarray:
    """Ring allreduce over the P2P channels (payloads ride the object
    data plane): world-1 scatter-reduce steps, then world-1 allgather
    steps. Per-rank traffic is 2*(world-1)/world * nbytes to ONE
    neighbor — no process ever holds more than its own array plus one
    chunk (reference algorithm: NCCL ring / Baidu allreduce)."""
    world, rank = g.world_size, g.rank
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    flat = np.ascontiguousarray(arr).reshape(-1)
    # Views, not copies: chunks are only rebound (_apply_op allocates its
    # result), never mutated in place.
    chunks = list(np.array_split(flat, world))
    # Scatter-reduce: after step s, rank r owns the full reduction of
    # chunk (r - s) mod world over ranks r-s..r.
    idx = rank
    for _ in range(world - 1):
        send(chunks[idx], nxt, group_name)
        idx = (idx - 1) % world
        chunks[idx] = _apply_op(chunks[idx], recv(prv, group_name), op)
    # Allgather: circulate each fully-reduced chunk around the ring.
    idx = (rank + 1) % world
    for _ in range(world - 1):
        send(chunks[idx], nxt, group_name)
        idx = (idx - 1) % world
        chunks[idx] = recv(prv, group_name)
    return np.concatenate(chunks).reshape(arr.shape).astype(
        arr.dtype, copy=False)


def allreduce(tensor, group_name: str = "default",
              op: str = ReduceOp.SUM):
    """Returns the reduced array (the reference mutates in place; jax arrays
    are immutable, so the result is returned)."""
    arr = _host(tensor)
    g = _groups().get(group_name)
    if (g is not None and g.world_size > 1 and op in ("sum", "product",
                                                      "min", "max")
            and arr.nbytes > _INLINE_LIMIT):
        return _ring_allreduce(g, group_name, arr, op)
    return _run(group_name, f"allreduce-{op}", arr, op)


def allgather(tensor, group_name: str = "default") -> List[Any]:
    return _run(group_name, "allgather", _host(tensor), "gather")


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(f"group {group_name!r} not initialized")
    parts = _run(group_name, "broadcast",
                 _host(tensor) if g.rank == src_rank else None,
                 "gather")
    return parts[src_rank]


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM):
    g = _groups().get(group_name)
    result = _run(group_name, f"reduce-{op}", _host(tensor), op)
    return result if g.rank == dst_rank else tensor


def reducescatter(tensor, group_name: str = "default",
                  op: str = ReduceOp.SUM):
    """Reduce then return this rank's 1/world slice along axis 0."""
    g = _groups().get(group_name)
    full = _run(group_name, f"reducescatter-{op}", _host(tensor), op)
    chunks = np.array_split(full, g.world_size, axis=0)
    return chunks[g.rank]


def barrier(group_name: str = "default") -> None:
    _run(group_name, "barrier", None, "barrier")


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(f"group {group_name!r} not initialized")
    chan = f"p2p-{g.rank}-{dst_rank}"
    n = g.round_ids.get(chan, 0)
    g.round_ids[chan] = n + 1
    key = f"{group_name}:p2p:{g.rank}->{dst_rank}:{n}"
    arr = _host(tensor)
    if arr.nbytes > _INLINE_LIMIT:
        # Large payload: only the ObjectRef goes through the coordinator;
        # the bytes move sender-store -> receiver over the object data
        # plane when recv() resolves the ref. The ref is NESTED in a
        # marker dict — a top-level ObjectRef argument would be
        # dependency-resolved into the materialized array before the
        # coordinator method runs, putting all bytes back through it.
        # Nested refs are not runtime-pinned, so the sender keeps a
        # handle alive for a window of world_size rounds per channel
        # (see _GroupState.p2p_live for why that bound is safe).
        ref = ray_tpu_torch.put(arr)
        from collections import deque
        live = g.p2p_live.setdefault(
            chan, deque(maxlen=max(g.world_size, 2)))
        live.append(ref)
        payload: Any = {"__collective_ref__": [ref]}
    else:
        payload = arr
    ray_tpu_torch.get(_coordinator().put_p2p.remote(key, payload))


def recv(src_rank: int, group_name: str = "default"):
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(f"group {group_name!r} not initialized")
    n = g.round_ids.get(f"p2p-{src_rank}-{g.rank}", 0)
    g.round_ids[f"p2p-{src_rank}-{g.rank}"] = n + 1
    key = f"{group_name}:p2p:{src_rank}->{g.rank}:{n}"
    value = ray_tpu_torch.get(_coordinator().get_p2p.remote(key))
    if isinstance(value, dict) and "__collective_ref__" in value:
        # Out-of-band payload: resolve over the data plane, not the
        # coordinator (see send()).
        value = ray_tpu_torch.get(value["__collective_ref__"][0])
    return value


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int], backend: str = "tpu",
                            group_name: str = "default"):
    """Declarative setup (reference: collective.py:151): initializes the
    group on each actor by invoking its ``init_collective_group`` method if
    it has one, else an injected generic call is required from the actor
    itself."""
    refs = []
    for actor, rank in zip(actors, ranks):
        refs.append(actor.init_collective_group.remote(
            world_size, rank, backend, group_name))
    return ray_tpu_torch.get(refs)
