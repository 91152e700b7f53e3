"""Pluggable object-spill backends behind URI schemes.

A copy of ``ray_tpu/_private/spill.py`` (the port imports nothing of
``ray_tpu``): the same schemes, file layout, atomic writes and chaos
sites, so a checkpoint one package writes the other reads. The port has
no cluster runtime; ``session://`` takes its session id explicitly, and
the session directory is the JAX package's (:func:`session_dir_for`).

Analog of the reference's external-storage layer
(python/ray/_private/external_storage.py): the raylet's
``LocalObjectManager`` spills primary copies through an
``ExternalStorage`` implementation selected by config — filesystem,
smart_open/S3, or a custom class path — and hands the resulting URL to
the owner, who can later ask ANY node to restore from it. This module
is the ray_tpu twin: every byte of spill IO in ``_private/`` flows
through a :class:`SpillBackend` so the chaos sites
(``spill.write_error`` / ``spill.restore_error``) and the failure
counters observe all of it.

Schemes
    ``file://<dir>``      per-process spill dir — current behavior; the
                          files die with their daemon (not durable).
    ``session://[<id>]``  the host-shared session directory
                          (:func:`session_dir_for`): survives
                          daemon death, so the head can re-point a
                          restore at any surviving node — or read the
                          file itself.
    ``mock-s3://<bucket>``local-directory stand-in for a remote object
                          store; the real S3/GCS client is left as a
                          :func:`register_spill_backend` registration
                          point (the reference gates smart_open the
                          same way).

Writes are crash-safe everywhere: payload goes to ``<path>.tmp``,
``flush`` + ``fsync``, then an atomic ``os.replace`` — a reader never
observes a torn file, and a daemon killed mid-spill leaves only a
``.tmp`` turd that the next write truncates. A failed write degrades
gracefully (caller keeps the in-memory copy and bumps
``ray_tpu_object_spill_failures_total{op="write"}``); a failed or
truncated read is a *tier miss* — the caller falls down the recovery
hierarchy (replica → spill → lineage) instead of raising into
``get()``.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from typing import Callable, Dict, Optional, Tuple

from ray_tpu_torch._private import chaos

logger = logging.getLogger(__name__)


def session_dir_for(session_id: str) -> str:
    """A cluster session's directory, as ``ray_tpu/_private/ray_logging.py``
    names it ("ray_tpu-sessions", not "ray_tpu": a plain /tmp/ray_tpu would
    shadow the package as a namespace package for a script run there)."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu-sessions",
                        f"session_{session_id}")

# uri scheme -> factory(uri) -> SpillBackend; extension point for real
# remote stores (S3/GCS): register a scheme and set
# RAY_TPU_object_spill_uri="s3://bucket/prefix".
_BACKENDS: Dict[str, Callable[[str], "SpillBackend"]] = {}
_LOCK = threading.Lock()


def register_spill_backend(scheme: str,
                           factory: Callable[[str], "SpillBackend"]) -> None:
    """Register a backend factory for a URI scheme (e.g. ``s3``)."""
    with _LOCK:
        _BACKENDS[scheme] = factory


def _split_uri(uri: str) -> Tuple[str, str]:
    scheme, sep, rest = uri.partition("://")
    if not sep:
        raise ValueError(f"not a spill URI: {uri!r}")
    return scheme, rest


class SpillFailure(OSError):
    """A spill write/read that failed (real IO error or injected via the
    ``io_oserror`` chaos kind at ``spill.write_error`` /
    ``spill.restore_error``). Callers degrade, never propagate."""


class SpillBackend:
    """One URI scheme's spill IO. Subclasses define where bytes land;
    the base class owns atomicity, chaos injection, and accounting."""

    #: Does the payload survive the writing daemon's death? Durable
    #: URIs are announced to the head for cross-node restore.
    durable = False
    scheme = "file"

    def __init__(self, root: str):
        self._root = root
        self._made = False

    @property
    def root(self) -> str:
        return self._root

    def _ensure_root(self) -> None:
        if not self._made:
            os.makedirs(self._root, exist_ok=True)
            self._made = True

    def uri_for(self, filename: str) -> str:
        return f"{self.scheme}://{filename}"

    def path_for(self, uri: str) -> str:
        _, rest = _split_uri(uri)
        return os.path.join(self._root, os.path.basename(rest))

    # -- write ------------------------------------------------------------

    def write(self, filename: str, payload) -> str:
        """Atomically persist ``payload`` (bytes or a list of buffers)
        under ``filename``; returns the spill URI. Raises
        :class:`SpillFailure` on any IO error (callers keep the memory
        copy and count the failure)."""
        self._ensure_root()
        path = os.path.join(self._root, os.path.basename(filename))
        tmp = path + ".tmp"
        try:
            if chaos.ACTIVE:
                chaos.maybe_inject("spill.write_error")
            with open(tmp, "wb") as f:
                if isinstance(payload, (bytes, bytearray, memoryview)):
                    f.write(payload)
                else:
                    for part in payload:
                        f.write(part)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as exc:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            _count_failure("write")
            raise SpillFailure(f"spill write of {filename} failed: {exc}") \
                from exc
        return self.uri_for(filename)

    # -- read -------------------------------------------------------------

    def read(self, uri: str, expected_size: int = 0) -> Optional[bytes]:
        """Read a spilled payload back. Returns ``None`` on a tier miss:
        missing file, truncated file (shorter than ``expected_size``),
        or an injected restore error — the caller falls down a tier."""
        return self.read_path(self.path_for(uri), expected_size)

    def read_path(self, path: str, expected_size: int = 0
                  ) -> Optional[bytes]:
        """``read`` for callers whose bookkeeping is path-based (the
        node table records local paths, not URIs). Same tier-miss
        contract and chaos/failure accounting."""
        try:
            if chaos.ACTIVE:
                chaos.maybe_inject("spill.restore_error")
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            _count_failure("restore")
            return None
        if expected_size and len(data) < expected_size:
            _count_failure("restore")
            logger.warning("spilled payload %s truncated (%d < %d bytes)",
                           path, len(data), expected_size)
            return None
        return data

    def read_range(self, uri: str, offset: int, length: int
                   ) -> Optional[bytes]:
        """Read ``length`` bytes at ``offset`` from a spilled payload —
        the byte-range primitive behind sharded-checkpoint resharding
        (a restarted gang pulls only the slices it needs from each
        saved shard, not whole files). Same tier-miss contract as
        :meth:`read`: ``None`` on a missing/short file or an injected
        restore error."""
        path = self.path_for(uri)
        try:
            if chaos.ACTIVE:
                chaos.maybe_inject("spill.restore_error")
            with open(path, "rb") as f:
                data = os.pread(f.fileno(), length, offset)
        except OSError:
            _count_failure("restore")
            return None
        if len(data) < length:
            _count_failure("restore")
            logger.warning(
                "spilled payload %s truncated (%d < %d bytes at +%d)",
                path, len(data), length, offset)
            return None
        return data

    def list_files(self, prefix: str = ""):
        """Filenames under this backend's root starting with ``prefix``
        (``.tmp`` turds excluded) — lets index loaders reconcile what
        storage actually holds against what was committed (orphan-shard
        garbage collection). Returns [] when the root doesn't exist."""
        try:
            names = os.listdir(self._root)
        except OSError:
            return []
        return sorted(n for n in names
                      if n.startswith(prefix) and not n.endswith(".tmp"))

    def size_of(self, uri: str) -> Optional[int]:
        """On-storage byte size of a spilled payload (None if missing)."""
        try:
            return os.stat(self.path_for(uri)).st_size
        except OSError:
            return None

    # -- landing (chunked recv straight to backend storage) ---------------

    def create_landing(self, filename: str, size: int) -> "SpillLanding":
        """An fd-backed landing for a chunked pull that goes straight to
        backend storage (the ``begin_recv`` disk path): chunks land via
        ``pwrite``, ``commit`` fsyncs and atomically renames."""
        self._ensure_root()
        path = os.path.join(self._root, os.path.basename(filename))
        if chaos.ACTIVE:
            chaos.maybe_inject("spill.write_error")
        return SpillLanding(self, path, size, self.uri_for(filename))

    # -- delete / teardown ------------------------------------------------

    def delete(self, uri: str) -> None:
        self.delete_path(self.path_for(uri))

    @staticmethod
    def delete_path(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def close(self) -> None:
        """Remove the backend root if this backend owns it (per-process
        file:// dirs). Durable backends leave their files for peers."""
        if self.durable:
            return
        try:
            for name in os.listdir(self._root):
                try:
                    os.unlink(os.path.join(self._root, name))
                except OSError:
                    pass
            os.rmdir(self._root)
        except OSError:
            pass


class SpillLanding:
    """fd + pwrite landing used by the dataplane's disk recv path."""

    __slots__ = ("backend", "path", "tmp", "fd", "size", "uri")

    def __init__(self, backend: SpillBackend, path: str, size: int,
                 uri: str):
        self.backend = backend
        self.path = path
        self.tmp = path + ".tmp"
        self.size = size
        self.uri = uri
        self.fd = os.open(self.tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC,
                          0o600)
        if size:
            os.ftruncate(self.fd, size)

    def pwrite(self, data, offset: int) -> None:
        os.pwrite(self.fd, data, offset)

    def commit(self) -> None:
        os.fsync(self.fd)
        os.close(self.fd)
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass
        try:
            os.unlink(self.tmp)
        except OSError:
            pass


class FileSpillBackend(SpillBackend):
    """``file://`` — a plain per-process directory (seed behavior)."""

    durable = False
    scheme = "file"

    def uri_for(self, filename: str) -> str:
        # Absolute-path URIs so a same-host reader could still find the
        # file; durability is still "no" because close() removes it.
        return "file://" + os.path.join(self._root,
                                        os.path.basename(filename))

    def path_for(self, uri: str) -> str:
        _, rest = _split_uri(uri)
        return rest if os.path.isabs(rest) else \
            os.path.join(self._root, os.path.basename(rest))


class SessionSpillBackend(SpillBackend):
    """``session://<session_id>/<file>`` — the host-shared session dir.

    Survives daemon death: the directory belongs to the cluster session
    (:func:`session_dir_for`), so after SIGKILLing the spilling
    daemon any process that knows the URI — the head included — can
    restore the payload without re-running the producer."""

    durable = True
    scheme = "session"

    def __init__(self, session_id: str):
        self.session_id = session_id
        super().__init__(os.path.join(session_dir_for(session_id), "spill"))

    def uri_for(self, filename: str) -> str:
        return f"session://{self.session_id}/{os.path.basename(filename)}"

    def path_for(self, uri: str) -> str:
        _, rest = _split_uri(uri)
        sid, _, name = rest.partition("/")
        if not name:  # bare session://<file> — ours
            sid, name = self.session_id, sid
        return os.path.join(session_dir_for(sid), "spill",
                            os.path.basename(name))


class MockS3SpillBackend(SpillBackend):
    """``mock-s3://<bucket>/<key>`` — a local-directory stand-in for a
    remote object store, keeping the URI/restore contract of a real one
    (any node resolves the same bucket dir). Swap in real S3/GCS via
    ``register_spill_backend("s3", ...)``."""

    durable = True
    scheme = "mock-s3"

    def __init__(self, bucket: str = "spill"):
        self.bucket = bucket or "spill"
        root = os.environ.get("RAY_TPU_MOCK_S3_DIR") or os.path.join(
            tempfile.gettempdir(), "ray_tpu-mock-s3")
        super().__init__(os.path.join(root, self.bucket))

    def uri_for(self, filename: str) -> str:
        return f"mock-s3://{self.bucket}/{os.path.basename(filename)}"

    def path_for(self, uri: str) -> str:
        _, rest = _split_uri(uri)
        bucket, _, name = rest.partition("/")
        if not name:
            bucket, name = self.bucket, bucket
        root = os.environ.get("RAY_TPU_MOCK_S3_DIR") or os.path.join(
            tempfile.gettempdir(), "ray_tpu-mock-s3")
        return os.path.join(root, bucket, os.path.basename(name))


def backend_for_uri(base_uri: str, session_id: str = "",
                    fallback_dir: str = "") -> SpillBackend:
    """Build the backend named by ``object_spill_uri``.

    ``base_uri`` forms: empty (file:// over ``fallback_dir``),
    ``file:///abs/dir``, ``session://`` (uses ``session_id``),
    ``session://<explicit-id>``, ``mock-s3://<bucket>``, or any
    registered custom scheme."""
    if not base_uri:
        return FileSpillBackend(fallback_dir or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_spill_{os.getpid()}"))
    scheme, rest = _split_uri(base_uri)
    with _LOCK:
        factory = _BACKENDS.get(scheme)
    if factory is not None:
        return factory(base_uri)
    if scheme == "file":
        return FileSpillBackend(rest or fallback_dir)
    if scheme == "session":
        sid = rest.strip("/") or session_id
        if not sid:
            raise ValueError(
                "session:// spill URI needs a session id (register with "
                "the head first, or pass session://<id>)")
        return SessionSpillBackend(sid)
    if scheme == "mock-s3":
        return MockS3SpillBackend(rest.strip("/"))
    raise ValueError(
        f"no spill backend registered for scheme {scheme!r} "
        f"(register one with "
        f"ray_tpu_torch._private.spill.register_spill_backend)")


def reader_for_uri(uri: str) -> Optional[SpillBackend]:
    """A backend capable of reading ``uri`` — used by restore paths that
    hold only a URI (head-side restore after the spilling daemon died,
    or a node restoring a peer's durable spill)."""
    try:
        scheme, rest = _split_uri(uri)
    except ValueError:
        return None
    with _LOCK:
        factory = _BACKENDS.get(scheme)
    try:
        if factory is not None:
            return factory(uri)
        if scheme == "file":
            return FileSpillBackend(os.path.dirname(rest) or ".")
        if scheme == "session":
            sid = rest.partition("/")[0]
            return SessionSpillBackend(sid) if sid else None
        if scheme == "mock-s3":
            return MockS3SpillBackend(rest.partition("/")[0])
    except (ValueError, OSError):
        return None
    return None


def read_uri(uri: str, expected_size: int = 0) -> Optional[bytes]:
    """Restore a payload from any spill URI (tier miss -> ``None``)."""
    backend = reader_for_uri(uri)
    if backend is None:
        return None
    return backend.read(uri, expected_size)


def _count_failure(op: str) -> None:
    try:
        from ray_tpu_torch._private import builtin_metrics
        builtin_metrics.object_spill_failures().inc(tags={"op": op})
    except Exception:  # noqa: BLE001 - metrics must never break spill IO
        pass
