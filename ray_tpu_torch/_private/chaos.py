"""Deterministic fault injection for transport paths.

A copy of ``ray_tpu/_private/chaos.py`` (the port imports nothing of
``ray_tpu``), with the same spec grammar and site names, so that one
``RAY_TPU_CHAOS`` spec drives both packages. Of the sites below the port
has the sharded checkpoint's and spill's.

Enabled via the ``RAY_TPU_CHAOS`` environment variable (inherited by
daemon subprocesses) or programmatically via :func:`configure`::

    RAY_TPU_CHAOS="send_oserror:p=0.05:seed=7"
    RAY_TPU_CHAOS="sock_close:site=head.send:after=5:times=1;delay_ms:ms=20"

Spec grammar: ops separated by ``;``; each op is ``KIND[:k=v...]``.

Kinds
    send_oserror   raise an OSError from a ``*.send`` site
    recv_oserror   raise an OSError from a ``*.recv`` site
    sock_close     shutdown+close the socket at the site, then raise
    delay_ms       sleep ``ms`` milliseconds at the site
    kill           raise :class:`ChaosKill` from a ``*kill`` site (serve
                   replicas treat it as sudden death: the actor plays
                   dead from then on, exercising failover/replacement)
    io_oserror     raise an OSError from a ``*_error`` storage-IO site
                   (spill writes/restores; degrades a tier instead of
                   failing the caller)
    partition      network partition: blackhole every matching ``.send``
                   / ``.recv`` call by raising :class:`ChaosPartition`
                   (an unreachable peer, NOT a reset — the membership
                   layer classifies it like a probe timeout). Scope
                   with ``site`` (``head`` = everything the head sends
                   or receives on its session/health channels →
                   bidirectional head↔daemon partition; ``daemon`` =
                   the daemon's side; ``pull`` = the daemon↔daemon data
                   plane). ``ms`` (default 0 = no window) arms a heal
                   timer on the first fire: matching calls are
                   blackholed for ``ms`` milliseconds, then the
                   partition heals and never fires again — partition →
                   suspicion → death declaration → heal → fenced
                   re-register, in one deterministic spec.

Params
    p      firing probability per matching call (default 1.0)
    seed   per-op RNG seed — same seed, same call sequence, same fires
    site   substring filter on the injection-site name
    after  skip the first N matching calls
    times  fire at most N times (0 = unlimited)
    ms     sleep duration for delay_ms (default 10); heal-after
           duration for partition (default 0 = never heals)

Sites: ``head.send`` / ``head.recv`` (head side of a session channel),
``daemon.send`` / ``daemon.recv`` (daemon side), ``pull.send``
(dataplane pooled pull sockets), ``head.health.send`` /
``head.health.recv`` (head-side liveness probe), ``daemon.health.send``
/ ``daemon.health.recv`` (daemon health-channel loop),
``daemon.resume.send`` (resume handshake — a partition must also block
the daemon's attempt to re-attach its broken session), ``serve.replica_kill`` /
``serve.replica_delay_ms`` (serve replica request path — evaluated at
the top of every ``handle_request``), ``spill.write_error`` /
``spill.restore_error`` (spill-backend IO, see _private/spill.py),
``train.worker_kill`` / ``train.result_delay_ms`` /
``train.ping_delay_ms`` / ``train.start_delay_ms`` (train-worker gang
RPCs, see train/_internal/worker_group.py — a fired kill makes the
rank play dead so the BackendExecutor's system-failure gang restart is
exercised deterministically), ``train.ckpt_shard_write_error`` /
``train.ckpt_shard_kill`` (per-rank sharded checkpoint writes, see
train/_internal/sharded_checkpoint.py — an injected ``io_oserror``
fails that rank's shard write cleanly so the save attempt aborts
without committing, while a kill takes the rank down mid-save to prove
torn shard sets stay uncommitted and get garbage-collected).

Hot paths guard on the module-level :data:`ACTIVE` flag, so with chaos
disabled the per-frame cost is a single attribute read and no call.
"""

from __future__ import annotations

import logging
import os
import random
import socket
import threading
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

ACTIVE = False

_LOCK = threading.Lock()
_OPS: List["_Op"] = []
_DEFAULT_SEED = 0xC4A05
_KINDS = ("send_oserror", "recv_oserror", "sock_close", "delay_ms", "kill",
          "io_oserror", "partition")


class ChaosError(OSError):
    """Injected transport failure (distinguishable from real ones)."""


class ChaosKill(ChaosError):
    """Injected sudden-death signal (serve replicas catch this and play
    dead — every subsequent call raises ActorDiedError)."""


class ChaosPartition(ChaosError):
    """Injected network partition: the peer is unreachable, not reset.

    Channels treat it like any transient OSError (mark broken, park for
    resume); the membership layer classifies it like a probe TIMEOUT —
    evidence of partition feeding the suspicion score, never the
    immediate process-is-gone death path."""


class _Op:
    __slots__ = ("kind", "p", "site", "after", "times", "ms", "rng",
                 "seen", "fired", "started")

    def __init__(self, kind: str, params: dict):
        self.kind = kind
        self.p = float(params.get("p", 1.0))
        self.site = params.get("site", "")
        self.after = int(params.get("after", 0))
        self.times = int(params.get("times", 0))
        # delay_ms: sleep duration. partition: heal-after window from
        # the first fire (0 = the partition never heals on its own).
        self.ms = float(params.get("ms",
                                   0.0 if kind == "partition" else 10.0))
        self.rng = random.Random(int(params.get("seed", _DEFAULT_SEED)))
        self.seen = 0
        self.fired = 0
        self.started: Optional[float] = None  # partition: first-fire time


def configure(spec: Optional[str]) -> List[_Op]:
    """Parse a chaos spec string, replacing any previous configuration.

    An empty/None spec disables injection entirely.
    """
    global ACTIVE
    ops = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        kind = fields[0].strip()
        if kind not in _KINDS:
            raise ValueError(
                f"unknown chaos op {kind!r} (expected one of {_KINDS})")
        params = {}
        for field in fields[1:]:
            key, _, value = field.partition("=")
            params[key.strip()] = value.strip()
        ops.append(_Op(kind, params))
    with _LOCK:
        _OPS[:] = ops
        ACTIVE = bool(ops)
    return list(ops)


def reset() -> None:
    """Disable injection and drop all configured ops."""
    configure("")


def stats() -> List[dict]:
    """Per-op match/fire counters (for asserting a fault really fired)."""
    with _LOCK:
        return [{"kind": op.kind, "site": op.site, "seen": op.seen,
                 "fired": op.fired} for op in _OPS]


def maybe_inject(site: str, sock=None) -> None:
    """Evaluate the active ops at an injection site.

    May sleep, close ``sock``, or raise :class:`ChaosError`. Callers
    must guard with ``if chaos.ACTIVE:`` to keep disabled-path cost at
    one attribute read.
    """
    fire = None
    with _LOCK:
        for op in _OPS:
            if op.site and op.site not in site:
                continue
            if op.kind == "send_oserror" and ".send" not in site:
                continue
            if op.kind == "recv_oserror" and ".recv" not in site:
                continue
            if op.kind == "kill" and "kill" not in site:
                continue
            if op.kind == "io_oserror" and "_error" not in site:
                continue
            if (op.kind == "partition" and ".send" not in site
                    and ".recv" not in site):
                continue
            op.seen += 1
            if op.seen <= op.after:
                continue
            if op.kind == "partition" and op.started is not None:
                # Window armed on the first fire: every matching call is
                # blackholed until ``ms`` elapses, then the partition
                # heals for good (p/times no longer consulted).
                if (time.monotonic() - op.started) * 1000.0 < op.ms:
                    op.fired += 1
                    fire = op
                    break
                continue
            if op.times and op.fired >= op.times:
                continue
            if op.p < 1.0 and op.rng.random() >= op.p:
                continue
            op.fired += 1
            if op.kind == "partition" and op.ms > 0 and op.started is None:
                op.started = time.monotonic()
            fire = op
            break
    if fire is None:
        return
    if fire.kind == "delay_ms":
        time.sleep(fire.ms / 1000.0)
        return
    if fire.kind == "kill":
        raise ChaosKill(f"chaos[kill] injected at {site}")
    if fire.kind == "partition":
        raise ChaosPartition(f"chaos[partition] injected at {site}")
    if fire.kind == "sock_close" and sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
    raise ChaosError(f"chaos[{fire.kind}] injected at {site}")


_env_spec = os.environ.get("RAY_TPU_CHAOS", "")
if _env_spec:
    try:
        configure(_env_spec)
    except ValueError:
        logger.warning("ignoring malformed RAY_TPU_CHAOS spec %r", _env_spec)
