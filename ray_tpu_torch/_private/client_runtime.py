"""Connected runtime for daemon/worker-side user code.

This kills the split-brain: user code executing on a node daemon (or in a
worker subprocess) used to auto-initialize a fresh, isolated local runtime —
nested ``.remote()`` calls ran in a private universe, head-created named
actors were invisible, and nested work escaped the head's resource
accounting. In the reference, every worker process embeds a CoreWorker wired
to the GCS/raylet, so tasks submit from anywhere
(/root/reference/src/ray/core_worker/core_worker.cc:1762), named actors
resolve anywhere
(/root/reference/src/ray/gcs/gcs_server/gcs_actor_manager.cc:241), and
references are owned/borrowed across processes
(/root/reference/src/ray/core_worker/reference_count.h:61).

Here the same composition property comes from a **client runtime**: when the
``ray_tpu`` API is touched from a daemon/worker execution context, the
process binds a :class:`ClientRuntime` whose operations are served by the
head over one multiplexed TCP connection (a second connection type on the
head's registration listener). The API layer (remote_function.py, actor.py)
is unchanged — it builds TaskSpecs exactly as on the head; the specs ship
pickled, and the head **re-mints task ids** before submission so ID
uniqueness stays a single-process property (the client's 4-byte unique
counter could otherwise birthday-collide with the head's).

Ownership: the head stays owner-of-record for every object. Each client
session holds head-side ObjectRef handles ("pins") for (a) refs it returned
to the client and (b) refs the client reported borrowing (``ref_add``
notices, sent when client code deserializes a ref from a payload); pins drop
on ``ref_del`` notices and wholesale on session death — a dying daemon
releases everything it borrowed.

Deadlock avoidance: a client ``get`` that blocks inside a running task ships
the task's id; the head releases that task's resources while the get blocks
and force-reacquires after (the client-side analog of the reference worker's
NotifyDirectCallTaskBlocked → raylet resource release).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import logging
import os
import socket
import threading
import traceback
import types
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private import wire as _wire
from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID, ObjectID,
                                  PlacementGroupID, TaskID)
from ray_tpu_torch._private.multinode import (_dumps, _loads, _recv_frame,
                                        _send_frame_best_effort,
                                        _send_frame)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.task_spec import TaskKind

logger = logging.getLogger("ray_tpu")


class HeadConnectionLost(ConnectionError):
    """The client runtime's head connection dropped mid-operation."""


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------


class _Waiter:
    __slots__ = ("event", "reply")

    def __init__(self):
        self.event = threading.Event()
        self.reply: Optional[dict] = None


class ClientConnection:
    """One multiplexed request/reply connection to the head (the client
    half of the protocol ClientSession serves)."""

    def __init__(self, address: Tuple[str, int]):
        self.address = tuple(address)
        self._sock = socket.create_connection(self.address, timeout=15)
        self._sock.settimeout(None)
        try:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: Dict[int, _Waiter] = {}
        self._counter = 0
        self.closed = False
        _send_frame(self._sock, _dumps({"type": "client_runtime",
                                        "protocol": _wire.PROTOCOL_VERSION,
                                        "pid": os.getpid()}),
                    self._send_lock)
        self.hello = _loads(_recv_frame(self._sock))
        if self.hello.get("type") == "register_rejected":
            with contextlib.suppress(OSError):
                self._sock.close()  # no recv thread exists to close it
            raise _wire.ProtocolMismatch(self.hello["error"])
        assert self.hello.get("type") == "client_registered", self.hello
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name="ray_tpu-client-recv", daemon=True)
        self._recv_thread.start()

    def _recv_loop(self) -> None:
        try:
            while True:
                reply = _loads(_recv_frame(self._sock))
                with self._lock:
                    waiter = self._pending.pop(reply.get("req_id"), None)
                if waiter is not None:
                    waiter.reply = reply
                    waiter.event.set()
                del waiter, reply
        except (ConnectionError, OSError):
            pass
        finally:
            self.close()

    def request(self, msg: dict, timeout: Optional[float] = None) -> dict:
        with self._lock:
            if self.closed:
                raise HeadConnectionLost(
                    f"head {self.address} connection is closed")
            self._counter += 1
            req_id = self._counter
            waiter = _Waiter()
            self._pending[req_id] = waiter
        msg["req_id"] = req_id
        payload = _dumps(msg)
        try:
            _send_frame(self._sock, payload, self._send_lock)
        except OSError as exc:
            with self._lock:
                self._pending.pop(req_id, None)
            raise HeadConnectionLost(
                f"send to head {self.address} failed: {exc}") from exc
        if not waiter.event.wait(timeout):
            with self._lock:
                self._pending.pop(req_id, None)
            raise TimeoutError(
                f"head did not reply to {msg.get('op')} within {timeout}s")
        reply = waiter.reply
        if reply is None or reply.get("type") == "closed":
            raise HeadConnectionLost(
                f"head {self.address} connection dropped while "
                f"{msg.get('op')} was in flight")
        if not reply.get("ok", True):
            exc, remote_tb = _loads(reply["error"])
            raise exc
        return reply

    def notify(self, msg: dict) -> None:
        """Fire-and-forget (req_id 0: the session handles it inline and
        never replies)."""
        msg["req_id"] = 0
        # connection gone => session death drops the pins anyway
        _send_frame_best_effort(self._sock, _dumps(msg), self._send_lock)

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            pending = list(self._pending.values())
            self._pending.clear()
        for waiter in pending:
            waiter.reply = {"type": "closed"}
            waiter.event.set()
        try:
            self._sock.close()
        except OSError:
            pass


class _ClientRefs:
    """Client-side local reference counts + head pin notices. Mutations
    from ``__del__`` (any thread, any allocation point) only enqueue; a
    flusher thread ships ordered ref_add/ref_del notices."""

    def __init__(self, enqueue):
        self._lock = threading.Lock()
        self._counts: Dict[ObjectID, int] = {}
        self._pinned: set = set()
        self._enqueue = enqueue

    def mark_pinned(self, oid: ObjectID) -> None:
        """The head already pinned this oid for us (it arrived as an API
        return) — no ref_add notice needed for the first handle."""
        with self._lock:
            self._pinned.add(oid)

    def add_local(self, oid: ObjectID) -> None:
        with self._lock:
            self._counts[oid] = self._counts.get(oid, 0) + 1
            if oid in self._pinned:
                return
            self._pinned.add(oid)
        self._enqueue(("ref_add", oid.hex()))

    def on_deleted(self, oid: ObjectID) -> None:
        with self._lock:
            c = self._counts.get(oid, 0) - 1
            if c > 0:
                self._counts[oid] = c
                return
            self._counts.pop(oid, None)
            if oid not in self._pinned:
                return
            self._pinned.discard(oid)
        self._enqueue(("ref_del", oid.hex()))

    # Runtime.refs API compatibility for paths that check liveness.
    def has(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._counts


class _ClientFunctions:
    """Function table proxy: exports ship to the head's FunctionTable
    (reference: function export to GCS KV); loads fetch bytes back."""

    def __init__(self, conn: ClientConnection):
        self._conn = conn
        self._lock = threading.Lock()
        self._by_id: Dict[bytes, bytes] = {}
        self._loaded: Dict[bytes, Any] = {}
        self._shipped: set = set()

    def export(self, fn) -> bytes:
        try:
            payload = serialization.dumps_function(fn)
        except Exception as exc:  # noqa: BLE001
            raise ValueError(
                "This function/class captured objects that cannot be "
                "serialized, so it cannot be submitted from a remote "
                "worker context (the head must receive its bytes). Make "
                f"it importable/picklable. Underlying error: {exc}")
        fn_id = self.export_bytes(payload)
        with self._lock:
            self._loaded.setdefault(fn_id, fn)
        return fn_id

    def export_bytes(self, payload: bytes) -> bytes:
        fn_id = hashlib.sha1(payload).digest()
        with self._lock:
            known = fn_id in self._shipped
            self._by_id.setdefault(fn_id, payload)
        if not known:
            self._conn.request({"op": "reg_fn", "payload": payload})
            with self._lock:
                self._shipped.add(fn_id)
        return fn_id

    def get_bytes(self, fn_id: bytes) -> bytes:
        with self._lock:
            payload = self._by_id.get(fn_id)
        if payload is not None:
            return payload
        reply = self._conn.request({"op": "fn_bytes", "fn_id": fn_id})
        payload = reply.get("payload")
        if payload is None:
            raise KeyError(fn_id)
        with self._lock:
            self._by_id[fn_id] = payload
            self._shipped.add(fn_id)
        return payload

    def load(self, fn_id: bytes):
        with self._lock:
            fn = self._loaded.get(fn_id)
        if fn is not None:
            return fn
        fn = serialization.loads_function(self.get_bytes(fn_id))
        with self._lock:
            self._loaded[fn_id] = fn
        return fn


class _ClientStore:
    def __init__(self, conn: ClientConnection):
        self._conn = conn

    def contains(self, oid: ObjectID) -> bool:
        return bool(self._conn.request(
            {"op": "contains", "ref": oid.hex()})["contains"])


class _ClientScheduler:
    def __init__(self, conn: ClientConnection):
        self._conn = conn

    def nodes_snapshot(self) -> List[dict]:
        return self._conn.request({"op": "nodes"})["nodes"]

    def placement_group_exists(self, pg_id: PlacementGroupID) -> bool:
        return bool(self._conn.request(
            {"op": "pg_exists", "pg_id": pg_id.hex()})["exists"])


def _attached_arena():
    """The shm arena this WORKER process shares with its daemon (None
    outside worker-subprocess contexts or when the arena is gone)."""
    try:
        from ray_tpu_torch._private import worker_process as wp
        executor = getattr(wp, "_current_executor", None)
        if executor is not None:
            return executor._get_arena()
    except Exception:  # noqa: BLE001 - arena optional
        pass
    return None


def _local_object_addr(daemon=None) -> Optional[Tuple[str, int]]:
    """This context's object-server address — the OWNER endpoint stamped
    into owner hints (phase 3). In-daemon: the daemon's server; worker
    subprocess: the daemon's server via RAY_TPU_OBJECT_ADDR."""
    if daemon is not None and daemon._object_server is not None and \
            daemon._object_server_host:
        return (daemon._object_server_host, daemon._object_server.port)
    raw = os.environ.get("RAY_TPU_OBJECT_ADDR")
    if raw and ":" in raw:
        host, _, port = raw.rpartition(":")
        try:
            return (host, int(port))
        except ValueError:
            return None
    return None


class ClientRuntime:
    """Head-connected runtime bound by worker.py when user code runs in a
    daemon/worker context. Implements the Runtime surface the API layer
    uses; every operation is served by the head's ClientSession."""

    is_client = True

    def __init__(self, address: Tuple[str, int]):
        self._conn = ClientConnection(address)
        hello = self._conn.hello
        self.job_id = JobID(bytes.fromhex(hello["job_id"]))
        self.session_id = hello["session_id"]
        self.namespace = hello.get("namespace", "default")
        self.head_node_id = NodeID(bytes.fromhex(hello["head_node_id"]))
        self.node_resources = types.SimpleNamespace(
            num_cpus=hello.get("num_cpus", 0),
            num_tpus=hello.get("num_tpus", 0))
        self.functions = _ClientFunctions(self._conn)
        self.store = _ClientStore(self._conn)
        self.scheduler = _ClientScheduler(self._conn)
        self.refs = _ClientRefs(self._enqueue_notice)
        self._actor_info: Dict[ActorID, dict] = {}
        self._actor_info_lock = threading.Lock()
        # Node-resident put threshold: payloads at/above it stay in the
        # creating node's table (same knob the head uses to decide
        # inline vs daemon-resident results). Local config defaults —
        # per-head _system_config overrides do not travel here, which
        # only shifts the inline/local cutover, never correctness.
        from ray_tpu_torch._private.ray_config import make_ray_config
        self._put_local_limit = int(
            make_ray_config(None).remote_object_inline_limit_bytes
            or (1 << 20))
        # Owner-ward resolutions served without a head op (phase 3;
        # tests assert this moves while head op counters stand still).
        self.ownerward_gets = 0
        # Ordered ref-notice queue + flusher (see _ClientRefs).
        self._notices: "collections.deque" = collections.deque()
        self._notice_event = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="ray_tpu-client-refgc",
            daemon=True)
        self._flusher.start()

    # -- plumbing -------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._conn.closed

    def _enqueue_notice(self, notice: Tuple[str, str]) -> None:
        self._notices.append(notice)
        self._notice_event.set()

    def _flush_loop(self) -> None:
        while not self._conn.closed:
            self._notice_event.wait(timeout=0.2)
            self._notice_event.clear()
            while self._notices:
                try:
                    op, ref_hex = self._notices.popleft()
                except IndexError:
                    break
                self._conn.notify({"op": op, "ref": ref_hex})

    def _refs_from_hex(self, hexes: List[str]) -> List[ObjectRef]:
        refs = []
        for h in hexes:
            oid = ObjectID.from_hex(h)
            # The head pinned these for this session before replying; the
            # first local handle must not send a redundant ref_add.
            self.refs.mark_pinned(oid)
            refs.append(ObjectRef(oid))
        return refs

    @staticmethod
    def _current_task_id_hex() -> Optional[str]:
        from ray_tpu_torch._private.runtime import current_task_spec
        spec = current_task_spec()
        if spec is None:
            return None
        hex_id = getattr(spec, "task_id_hex", None)
        if hex_id is not None:
            return hex_id
        task_id = getattr(spec, "task_id", None)
        return task_id.hex() if task_id is not None else None

    def on_ref_deleted(self, oid: ObjectID) -> None:
        self.refs.on_deleted(oid)

    # -- task/actor submission -----------------------------------------

    def register_function(self, fn) -> bytes:
        return self.functions.export(fn)

    def submit_task(self, spec) -> List[ObjectRef]:
        reply = self._conn.request(
            {"op": "submit_task", "spec": _dumps(spec)})
        return self._refs_from_hex(reply["refs"])

    def submit_actor_task(self, spec) -> List[ObjectRef]:
        reply = self._conn.request(
            {"op": "submit_actor_task", "spec": _dumps(spec)})
        return self._refs_from_hex(reply["refs"])

    def create_actor(self, spec, **options) -> ActorID:
        # Forward ALL options verbatim: the server applies them with
        # Runtime.create_actor(spec, **opts), so a kwarg added to the head
        # runtime (e.g. concurrency_groups) works from client contexts
        # without this class naming it — the two signatures cannot drift
        # and head-side defaults stay authoritative.
        reply = self._conn.request({
            "op": "create_actor", "spec": _dumps(spec), "opts": options})
        actor_id = ActorID(bytes.fromhex(reply["actor_id"]))
        with self._actor_info_lock:
            self._actor_info[actor_id] = {
                "exists": True, "fn_id": spec.function_id,
                "name": options.get("name", ""),
                "namespace": options.get("namespace", "default"),
                "class_name": (spec.name or "").rsplit(".", 1)[0],
                "dead": False, "num_restarts": 0,
            }
        return actor_id

    def _fetch_actor_info(self, actor_id: ActorID) -> dict:
        reply = self._conn.request(
            {"op": "actor_info", "actor_id": actor_id.hex()})
        info = {"exists": reply["exists"], "fn_id": reply.get("fn_id"),
                "name": reply.get("name", ""),
                "namespace": reply.get("namespace", "default"),
                "class_name": reply.get("class_name", ""),
                "dead": reply.get("dead", False),
                "num_restarts": reply.get("num_restarts", 0)}
        if info["exists"]:
            with self._actor_info_lock:
                self._actor_info[actor_id] = info
        return info

    def actor_state(self, actor_id: ActorID):
        with self._actor_info_lock:
            info = self._actor_info.get(actor_id)
        if info is None:
            info = self._fetch_actor_info(actor_id)
        if not info["exists"]:
            return None
        return types.SimpleNamespace(
            actor_id=actor_id,
            creation_spec=types.SimpleNamespace(
                function_id=info["fn_id"], _tpu_ids=None, _node_id=None),
            dead=info["dead"], name=info["name"],
            namespace=info["namespace"],
            class_name=info.get("class_name", ""),
            num_restarts=info["num_restarts"])

    def get_named_actor(self, name: str,
                        namespace: str = "default") -> ActorID:
        reply = self._conn.request(
            {"op": "get_named_actor", "name": name, "namespace": namespace})
        return ActorID(bytes.fromhex(reply["actor_id"]))

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._conn.request({"op": "kill_actor", "actor_id": actor_id.hex(),
                            "no_restart": no_restart})

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        self._conn.request({"op": "cancel", "ref": ref.hex(),
                            "force": force})

    # -- objects --------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        payload = serialization.serialize(value)
        ref = self._put_node_resident(payload)
        if ref is not None:
            return ref
        reply = self._conn.request({"op": "put", "payload": payload})
        return self._refs_from_hex([reply["ref"]])[0]

    def _put_node_resident(self, payload: bytes) -> Optional[ObjectRef]:
        """Distributed-ownership put (reference: owner-is-creator,
        reference_count.h:61): a big payload created on a node STAYS in
        that node's object table — only a directory registration goes to
        the head, and readers pull the bytes over the node-to-node data
        plane. In-daemon contexts write the daemon table directly;
        worker subprocesses write the shared shm arena and the daemon
        ADOPTS the entry (bookkeeping) during registration. Returns
        None when this context cannot (or should not: small payloads
        ship inline) keep the bytes local — caller falls back to the
        head-stored put."""
        if len(payload) < self._put_local_limit:
            return None
        import uuid

        from ray_tpu_torch._private import multinode as mn
        key = f"cput-{uuid.uuid4().hex}"
        daemon = mn._current_daemon
        adopt = False
        node_hex = None
        arena = None
        if daemon is not None and daemon.node_id_hex:
            daemon._table.put(key, payload)
            node_hex = daemon.node_id_hex
        else:
            node_hex = os.environ.get("RAY_TPU_NODE_ID")
            arena = _attached_arena()
            if not node_hex or arena is None or \
                    not arena.put_bytes(key, payload):
                return None  # no local store (thin client / arena full)
            adopt = True
        try:
            reply = self._conn.request({
                "op": "put_remote", "node": node_hex, "key": key,
                "size": len(payload), "adopt": adopt})
        except Exception:  # noqa: BLE001 - registration failed: clean up
            logger.exception("node-resident put registration failed; "
                             "falling back to head-stored put")
            # BOTH stores must release the orphan: an unadopted arena
            # entry has no bookkeeping — nothing would ever free it.
            if daemon is not None:
                daemon._table.free(key)
            elif arena is not None:
                arena.delete(key)
            return None
        # Owner hint (phase 3): the creator knows the owner — itself.
        # Any borrower of this ref can then locate/fetch/register
        # straight against this node's object server, no head op.
        hint = None
        addr = _local_object_addr(daemon)
        if addr is not None and node_hex:
            hint = (key, addr[0], addr[1], node_hex)
        oid = ObjectID.from_hex(reply["ref"])
        # Pin BEFORE constructing (as _refs_from_hex does): the head
        # pinned this ref before replying; the first local handle must
        # not send a redundant ref_add.
        self.refs.mark_pinned(oid)
        return ObjectRef(oid, owner_hint=hint)

    #: sentinel: owner-ward resolution missed, fall back to the head.
    _MISS = object()

    def get(self, refs: List[ObjectRef],
            timeout: Optional[float]) -> List[Any]:
        # Phase-3 fast path: refs carrying an owner hint resolve
        # against the OWNER's object server (local read on the owner
        # node, direct pull elsewhere) — the head is not involved.
        # Anything unhinted, freed, or owner-dead falls back to the
        # head op (which waits / reconstructs as before).
        values: List[Any] = [None] * len(refs)
        remaining: List[Tuple[int, ObjectRef]] = []
        for i, r in enumerate(refs):
            hint = getattr(r, "_owner_hint", None)
            v = (self._get_ownerward(hint, timeout)
                 if hint else self._MISS)
            if v is self._MISS:
                remaining.append((i, r))
            else:
                values[i] = v
        if remaining:
            reply = self._conn.request({
                "op": "get",
                "refs": [r.hex() for _i, r in remaining],
                "timeout": timeout,
                "holding_task": self._current_task_id_hex(),
            })
            for (i, _r), v in zip(remaining, _loads(reply["values"])):
                values[i] = v
        return values

    def _get_ownerward(self, hint, timeout: Optional[float]) -> Any:
        """Resolve one hinted ref owner-ward; _MISS on any failure.
        Network waits are capped by the CALLER's timeout (a get with
        timeout=0.5 on a dead owner must miss fast and let the head
        fallback apply the real deadline — never serve 30s of connect
        retries first)."""
        from ray_tpu_torch._private import multinode as mn
        from ray_tpu_torch._private.dataplane import (ObjectPullError,
                                                fetch_remote_bytes,
                                                pull_object)
        try:
            key, host, port, node_hex = hint
        except (TypeError, ValueError):
            return self._MISS
        net_timeout = 10.0 if timeout is None else max(
            0.1, min(10.0, timeout))
        payload = None
        try:
            daemon = mn._current_daemon
            if daemon is not None:
                if daemon.node_id_hex != node_hex and \
                        not daemon._table.contains(key):
                    # Peer-owned: pull into this node's table (cached
                    # for siblings, admission-bounded) then read local.
                    pull_object((host, port), key, daemon._table,
                                timeout=net_timeout, retries=0)
                with daemon._table.pinned(key) as raw:
                    if raw is not None:
                        payload = bytes(raw)
            else:
                arena = _attached_arena()
                if arena is not None and \
                        os.environ.get("RAY_TPU_NODE_ID") == node_hex:
                    view = arena.get_bytes(key)
                    if view is not None:
                        try:
                            payload = bytes(view)
                        finally:
                            with contextlib.suppress(BufferError):
                                view.release()
                            # get_bytes holds an arena refcount the
                            # caller must return (native_store
                            # contract) — a leaked pin would make the
                            # eventual free fail forever.
                            with contextlib.suppress(Exception):
                                arena.release(key)
                if payload is None:
                    payload = fetch_remote_bytes((host, port), key,
                                                 timeout=net_timeout)
        except (ObjectPullError, OSError, ConnectionError):
            return self._MISS
        if payload is None:
            return self._MISS
        self.ownerward_gets += 1
        return serialization.deserialize(payload)

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True):
        reply = self._conn.request({
            "op": "wait", "refs": [r.hex() for r in refs],
            "num_returns": num_returns, "timeout": timeout,
        })
        by_hex = {r.hex(): r for r in refs}
        return ([by_hex[h] for h in reply["ready"]],
                [by_hex[h] for h in reply["pending"]])

    def free_objects(self, oids: List[ObjectID]) -> None:
        self._conn.request(
            {"op": "free", "refs": [oid.hex() for oid in oids]})

    # -- cluster introspection / PGs / KV -------------------------------

    def cluster_resources(self) -> Dict[str, float]:
        return self._conn.request({"op": "cluster_resources"})["resources"]

    def available_resources(self) -> Dict[str, float]:
        return self._conn.request(
            {"op": "available_resources"})["resources"]

    def task_events(self) -> List[dict]:
        return self._conn.request({"op": "task_events"})["events"]

    def create_placement_group(self, bundles: List[Dict[str, float]],
                               strategy: str = "PACK",
                               name: str = "") -> PlacementGroupID:
        reply = self._conn.request({"op": "create_pg", "bundles": bundles,
                                    "strategy": strategy, "name": name})
        return PlacementGroupID(bytes.fromhex(reply["pg_id"]))

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        self._conn.request({"op": "remove_pg", "pg_id": pg_id.hex()})

    def kv_put(self, namespace: str, key: bytes, value: bytes,
               overwrite: bool = True) -> bool:
        return self._conn.request(
            {"op": "kv_put", "ns": namespace, "key": key, "value": value,
             "overwrite": overwrite})["existed"]

    def kv_get(self, namespace: str, key: bytes):
        return self._conn.request(
            {"op": "kv_get", "ns": namespace, "key": key})["value"]

    def kv_del(self, namespace: str, key: bytes) -> bool:
        return self._conn.request(
            {"op": "kv_del", "ns": namespace, "key": key})["deleted"]

    def kv_keys(self, namespace: str, prefix: bytes = b"") -> list:
        return self._conn.request(
            {"op": "kv_keys", "ns": namespace, "prefix": prefix})["keys"]

    # -- lifecycle ------------------------------------------------------

    def shutdown(self) -> None:
        self._conn.close()
        self._notice_event.set()


# ---------------------------------------------------------------------------
# Head side
# ---------------------------------------------------------------------------


class ClientSession:
    """Head-side server for one ClientRuntime connection: executes API
    ops against the real runtime and holds this session's object pins
    (head-side ObjectRef handles). Dies with the connection — a dead
    daemon's borrowed refs are released wholesale."""

    def __init__(self, runtime, sock: socket.socket, addr, on_close=None):
        self.runtime = runtime
        self._sock = sock
        self.addr = addr
        self._send_lock = threading.Lock()
        self._plock = threading.Lock()
        self._pinned: Dict[ObjectID, ObjectRef] = {}
        # Actors this session created (reference: ownership — a non-
        # detached actor dies with its creator). Reaped on close();
        # detached actors are never tracked here.
        self._created_actors: set = set()
        self._closed = False
        self._on_close = on_close

    def serve(self) -> None:
        try:
            while True:
                msg = _loads(_recv_frame(self._sock))
                if msg.get("req_id", 0) == 0:
                    self._handle_notice(msg)
                    continue
                # Per-request threads: get/wait block arbitrarily long and
                # must not stall the session's other requests.
                threading.Thread(
                    target=self._handle, args=(msg,),
                    name="ray_tpu-client-op", daemon=True).start()
                del msg
        except (ConnectionError, OSError):
            pass
        finally:
            self.close()

    def close(self) -> None:
        with self._plock:
            if self._closed:
                return
            self._closed = True
            self._pinned.clear()  # handles die → refcounts decrement
            created = list(self._created_actors)
            self._created_actors.clear()
        # Client disconnect reaps the actors this session created —
        # EXCEPT detached ones, whose lifetime the GCS owns (they were
        # never tracked). Double-check liveness/lifetime against the
        # runtime: a handle may have been killed or re-created since.
        for actor_id in created:
            state = self.runtime.actor_state(actor_id)
            if state is None or state.dead or state.detached:
                continue
            try:
                self.runtime.kill_actor(actor_id, no_restart=True)
            except Exception:  # noqa: BLE001 - teardown best effort
                logger.exception("failed to reap client actor %s",
                                 actor_id.hex()[:12])
        try:
            self._sock.close()
        except OSError:
            pass
        if self._on_close is not None:
            try:
                self._on_close(self)
            except Exception:  # noqa: BLE001 - teardown best effort
                pass

    # -- pins -----------------------------------------------------------

    def _pin(self, refs: List[ObjectRef]) -> None:
        with self._plock:
            if self._closed:
                return
            for r in refs:
                self._pinned[r.object_id()] = r

    def _handle_notice(self, msg: dict) -> None:
        op = msg.get("op")
        try:
            if op == "ref_add":
                oid = ObjectID.from_hex(msg["ref"])
                self._pin([ObjectRef(oid)])
            elif op == "ref_del":
                with self._plock:
                    self._pinned.pop(ObjectID.from_hex(msg["ref"]), None)
        except Exception:  # noqa: BLE001 - notices are best-effort
            logger.exception("client-session notice %s failed", op)

    # -- request dispatch ----------------------------------------------

    def _handle(self, msg: dict) -> None:
        req_id = msg.get("req_id")
        try:
            reply = self._dispatch(msg)
            reply["req_id"] = req_id
            reply.setdefault("ok", True)
        except BaseException as exc:  # noqa: BLE001 - ship to client
            try:
                payload = _dumps((exc, traceback.format_exc()))
            except Exception:  # noqa: BLE001 - unpicklable exception
                payload = _dumps((RuntimeError(
                    f"{type(exc).__name__}: {exc}"),
                    traceback.format_exc()))
            reply = {"req_id": req_id, "ok": False, "error": payload}
        # client gone => close() runs from the serve loop
        _send_frame_best_effort(self._sock, _dumps(reply), self._send_lock)

    def _dispatch(self, msg: dict) -> dict:
        # Schema check BEFORE dispatch (wire.py CLIENT_SCHEMAS): a
        # drifted op fails with the exact field name as a normal error
        # reply, never a KeyError inside a handler.
        _wire.validate_client_op(msg)
        op = msg["op"]
        from ray_tpu_torch._private.event_stats import GLOBAL
        with GLOBAL.timed(f"client.{op}"):
            return self._dispatch_op(op, msg)

    def _dispatch_op(self, op: str, msg: dict) -> dict:
        rt = self.runtime
        if op == "submit_task":
            spec = _loads(msg["spec"])
            # Re-mint: task-id uniqueness is a single-process (head)
            # property; a client-minted id could collide with the head's
            # own counter (ids.py _task_unique birthday note).
            spec.task_id = TaskID.for_normal_task(rt.job_id)
            refs = rt.submit_task(spec)
            self._pin(refs)
            return {"refs": [r.hex() for r in refs]}
        if op == "submit_actor_task":
            spec = _loads(msg["spec"])
            spec.task_id = TaskID.for_actor_task(spec.actor_id)
            refs = rt.submit_actor_task(spec)
            self._pin(refs)
            return {"refs": [r.hex() for r in refs]}
        if op == "create_actor":
            spec = _loads(msg["spec"])
            opts = msg["opts"]
            # get_if_exists may hand back an actor some OTHER session
            # (or the head driver) created — this session must not adopt
            # its lifetime. Resolve the name first to tell apart.
            existing = None
            if opts.get("name") and opts.get("get_if_exists"):
                try:
                    existing = rt.get_named_actor(
                        opts["name"], opts.get("namespace") or "default")
                except ValueError:
                    existing = None
            # No re-mint needed: creation task ids derive deterministically
            # from the actor id (TaskID.for_actor_creation — 8 random
            # actor bytes, zero unique part), a shape head-minted normal/
            # actor task ids can never take.
            actor_id = rt.create_actor(spec, **opts)
            if actor_id != existing and opts.get("lifetime") != "detached":
                with self._plock:
                    if not self._closed:
                        self._created_actors.add(actor_id)
            return {"actor_id": actor_id.hex()}
        if op == "actor_info":
            state = rt.actor_state(ActorID(bytes.fromhex(msg["actor_id"])))
            if state is None:
                return {"exists": False}
            return {"exists": True,
                    "fn_id": state.creation_spec.function_id,
                    "name": state.name, "namespace": state.namespace,
                    "class_name": getattr(state, "class_name", ""),
                    "dead": state.dead,
                    "num_restarts": state.num_restarts,
                    "lifetime": state.lifetime}
        if op == "get_named_actor":
            actor_id = rt.get_named_actor(msg["name"], msg["namespace"])
            return {"actor_id": actor_id.hex()}
        if op == "kill_actor":
            rt.kill_actor(ActorID(bytes.fromhex(msg["actor_id"])),
                          msg["no_restart"])
            return {}
        if op == "cancel":
            rt.cancel(ObjectRef(ObjectID.from_hex(msg["ref"])),
                      msg["force"])
            return {}
        if op == "reg_fn":
            rt.functions.export_bytes(msg["payload"])
            return {}
        if op == "fn_bytes":
            try:
                return {"payload": rt.functions.get_bytes(msg["fn_id"])}
            except KeyError:
                return {"payload": None}
        if op == "put":
            ref = rt.put(serialization.deserialize(msg["payload"]))
            self._pin([ref])
            return {"ref": ref.hex()}
        if op == "put_remote":
            # Distributed-ownership put: bytes already live in the
            # creating node's table; register the directory entry only.
            ref = rt.register_remote_put(
                NodeID(bytes.fromhex(msg["node"])), msg["key"],
                int(msg["size"]), adopt=bool(msg.get("adopt")))
            self._pin([ref])
            return {"ref": ref.hex()}
        if op == "get":
            refs = [ObjectRef(ObjectID.from_hex(h)) for h in msg["refs"]]
            held = None
            if msg.get("holding_task"):
                held = rt.client_get_release(msg["holding_task"])
            try:
                values = rt.get(refs, msg.get("timeout"))
            finally:
                if held is not None:
                    rt.client_get_reacquire(held)
            return {"values": _dumps(values)}
        if op == "wait":
            refs = [ObjectRef(ObjectID.from_hex(h)) for h in msg["refs"]]
            ready, pending = rt.wait(refs, msg["num_returns"],
                                     msg.get("timeout"))
            return {"ready": [r.hex() for r in ready],
                    "pending": [r.hex() for r in pending]}
        if op == "contains":
            return {"contains": rt.store.contains(
                ObjectID.from_hex(msg["ref"]))}
        if op == "free":
            oids = [ObjectID.from_hex(h) for h in msg["refs"]]
            with self._plock:
                for oid in oids:
                    self._pinned.pop(oid, None)
            rt.free_objects(oids)
            return {}
        if op == "cluster_resources":
            return {"resources": rt.cluster_resources()}
        if op == "available_resources":
            return {"resources": rt.available_resources()}
        if op == "nodes":
            return {"nodes": rt.scheduler.nodes_snapshot()}
        if op == "pg_exists":
            return {"exists": rt.scheduler.placement_group_exists(
                PlacementGroupID(bytes.fromhex(msg["pg_id"])))}
        if op == "create_pg":
            pg_id = rt.create_placement_group(
                msg["bundles"], msg["strategy"], msg["name"])
            return {"pg_id": pg_id.hex()}
        if op == "remove_pg":
            rt.remove_placement_group(
                PlacementGroupID(bytes.fromhex(msg["pg_id"])))
            return {}
        if op == "task_events":
            return {"events": rt.task_events()}
        if op == "kv_put":
            return {"existed": rt.kv_put(msg["ns"], msg["key"],
                                         msg["value"], msg["overwrite"])}
        if op == "kv_get":
            return {"value": rt.kv_get(msg["ns"], msg["key"])}
        if op == "kv_del":
            return {"deleted": rt.kv_del(msg["ns"], msg["key"])}
        if op == "kv_keys":
            return {"keys": rt.kv_keys(msg["ns"], msg["prefix"])}
        if op == "ping":
            return {}
        raise ValueError(f"unknown client op {op!r}")
