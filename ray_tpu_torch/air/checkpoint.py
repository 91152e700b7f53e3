"""AIR Checkpoint: dict / directory / sharded-tensor / URI forms.

A copy of ``ray_tpu/air/checkpoint.py`` (the port imports nothing of
``ray_tpu``), after the reference's python/ray/air/checkpoint.py:63
(Checkpoint with to_dict/from_dict/to_directory/from_directory/uri
conversions). Where the JAX package writes a sharded pytree with orbax,
JAX's own per-host writer, the port writes a state dict of (D)Tensors with
PyTorch's counterpart, ``torch.distributed.checkpoint`` (DCP): each rank
writes its own DTensor shards, and a restore loads into the layout of its
target, so a state sharded over a mesh round-trips without being gathered
onto one host (`from_sharded_state` / `restore_sharded_state`). The
metadata's ``format`` names the writer; neither package reads the other's
directory in this form. The format both packages share is the sharded
checkpoint of ``train/_internal/sharded_checkpoint.py``.

URI checkpoints (``to_uri``/``from_uri``) persist the payload through the
pluggable spill backends (``file://`` / ``session://`` / ``mock-s3://``,
_private/spill.py) with crash-safe atomic writes, so a gang restart can
restore from a location that survives the reporting node's death. A
``from_uri`` checkpoint is lazy: nothing is fetched until the first
``to_dict``/``to_directory``/``restore_sharded_state``, so handing one to
every rank of a restarted gang costs one small pickle, not one payload
copy per rank.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import tarfile
import tempfile
import uuid
from typing import Any, Dict, Optional

_DICT_FILE = "checkpoint_dict.pkl"
_METADATA_FILE = "ckpt_metadata.json"
_SHARDED_DIR = "sharded_state"
# The writer of a sharded directory checkpoint, in its metadata: the JAX
# package's is "orbax".
_DCP_FORMAT = "torch.distributed.checkpoint"

# URI-payload envelope versioning (one pickled dict per checkpoint file).
_PAYLOAD_KIND_DICT = "dict"
_PAYLOAD_KIND_DIR = "directory"


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 directory: Optional[str] = None,
                 uri: Optional[str] = None):
        if sum(x is not None for x in (data, directory, uri)) != 1:
            raise ValueError(
                "Provide exactly one of data=, directory= or uri= "
                "(use from_dict/from_directory/from_uri)")
        self._data = data
        self._directory = directory
        self._uri = uri
        self.id = uuid.uuid4().hex[:8]

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, directory: str) -> "Checkpoint":
        return cls(directory=str(directory))

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        """A lazy handle on a checkpoint persisted at a spill URI
        (``to_uri``'s return value). The payload is fetched on first
        access, from any process that can resolve the URI's backend."""
        return cls(uri=str(uri))

    @classmethod
    def from_sharded_state(cls, state: Any, directory: str,
                           extra: Optional[Dict[str, Any]] = None
                           ) -> "Checkpoint":
        """Write a state dict of (D)Tensors, possibly sharded over a mesh,
        with ``torch.distributed.checkpoint`` and return a directory
        checkpoint. Each rank writes only its shards; with a process group
        every rank calls this with the same ``directory``."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        directory = os.path.abspath(directory)
        path = os.path.join(directory, _SHARDED_DIR)
        group = dist.is_initialized()
        if not group or dist.get_rank() == 0:
            os.makedirs(directory, exist_ok=True)
            if os.path.exists(path):
                shutil.rmtree(path)
        if group:
            dist.barrier()
        dcp.save(state, checkpoint_id=path)
        if not group or dist.get_rank() == 0:
            meta = {"format": _DCP_FORMAT, "extra": extra or {}}
            with open(os.path.join(directory, _METADATA_FILE), "w") as f:
                json.dump(meta, f)
        if group:
            dist.barrier()
        return cls.from_directory(directory)

    # -- URI persistence (durable checkpoints) ----------------------------

    @property
    def uri(self) -> Optional[str]:
        """The spill URI this checkpoint was persisted at/loaded from."""
        return self._uri

    def _payload_bytes(self) -> bytes:
        """One self-describing pickle: dict checkpoints carry the dict,
        directory checkpoints carry a tar of the tree (DCP sharded state
        included)."""
        self._hydrate()
        if self._data is not None:
            return pickle.dumps(
                {"kind": _PAYLOAD_KIND_DICT, "data": self._data},
                protocol=pickle.HIGHEST_PROTOCOL)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            tar.add(self._directory, arcname=".")
        return pickle.dumps(
            {"kind": _PAYLOAD_KIND_DIR, "tar": buf.getvalue()},
            protocol=pickle.HIGHEST_PROTOCOL)

    def to_uri(self, uri: str) -> str:
        """Persist this checkpoint's payload at a spill URI (crash-safe
        atomic write through the URI's backend: ``file://`` /
        ``session://`` / ``mock-s3://`` or any registered scheme).
        Returns the canonical URI — feed it to :meth:`from_uri` on any
        node that can resolve the backend."""
        from ray_tpu_torch._private import spill
        backend = spill.reader_for_uri(uri)
        if backend is None:
            raise ValueError(f"no spill backend can write {uri!r}")
        _, rest = uri.partition("://")[::2]
        filename = os.path.basename(rest.rstrip("/"))
        if not filename:
            raise ValueError(f"checkpoint URI needs a filename: {uri!r}")
        out = backend.write(filename, self._payload_bytes())
        self._uri = out
        return out

    def _hydrate(self) -> None:
        """Materialize a lazy URI checkpoint into dict/directory form."""
        if self._data is not None or self._directory is not None:
            return
        from ray_tpu_torch._private import spill
        payload = spill.read_uri(self._uri)
        if payload is None:
            raise ValueError(
                f"Checkpoint payload at {self._uri} is missing or "
                "unreadable (storage lost after the run that wrote it?)")
        envelope = pickle.loads(payload)
        if envelope.get("kind") == _PAYLOAD_KIND_DICT:
            self._data = envelope["data"]
            return
        directory = tempfile.mkdtemp(prefix="ray_tpu_ckpt_uri_")
        with tarfile.open(fileobj=io.BytesIO(envelope["tar"])) as tar:
            tar.extractall(directory)
        self._directory = directory

    # -- accessors --------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        self._hydrate()
        if self._data is not None:
            return dict(self._data)
        path = os.path.join(self._directory, _DICT_FILE)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        raise ValueError(
            f"Checkpoint at {self._directory} has no dict form "
            f"(missing {_DICT_FILE}); use restore_sharded_state for sharded "
            "checkpoints.")

    def to_directory(self, path: Optional[str] = None) -> str:
        self._hydrate()
        if self._directory is not None:
            if path and os.path.abspath(path) != self._directory:
                shutil.copytree(self._directory, path, dirs_exist_ok=True)
                return path
            return self._directory
        path = path or tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _DICT_FILE), "wb") as f:
            pickle.dump(self._data, f)
        return path

    def restore_sharded_state(self, target: Any) -> Any:
        """Load a ``from_sharded_state`` checkpoint into ``target``, a state
        dict of (D)Tensors in the layout to restore to (each rank reads the
        parts of its own shards), in place; returns ``target``. A
        directory another writer made (the JAX package's orbax) raises."""
        import torch.distributed.checkpoint as dcp

        self._hydrate()
        if self._directory is None:
            raise ValueError("Sharded restore requires a directory checkpoint")
        meta_path = os.path.join(self._directory, _METADATA_FILE)
        fmt = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                fmt = json.load(f).get("format")
        if fmt != _DCP_FORMAT:
            raise ValueError(
                f"{self._directory} holds a {fmt!r} sharded state, not "
                f"{_DCP_FORMAT!r}; the shared format is ShardedCheckpoint's")
        dcp.load(target, checkpoint_id=os.path.join(self._directory,
                                                    _SHARDED_DIR))
        return target

    @property
    def extra_metadata(self) -> Dict[str, Any]:
        if self._uri is not None:
            self._hydrate()
        if self._directory is None:
            return {}
        path = os.path.join(self._directory, _METADATA_FILE)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f).get("extra", {})
        return {}

    def __repr__(self):
        src = self._uri or self._directory or "<dict>"
        return f"Checkpoint(id={self.id}, source={src})"
