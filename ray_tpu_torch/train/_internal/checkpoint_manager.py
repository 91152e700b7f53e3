"""Durable train checkpoints: persist every reported checkpoint off-node.

Analog of the reference's train/_internal/checkpoint_manager.py
(_CheckpointManager: register_checkpoint, num_to_keep /
checkpoint_score_attribute pruning) — with the durability story built on
this repo's spill backends (_private/spill.py) instead of pyarrow
filesystems: ``RunConfig.storage_path`` is a spill URI (``file://`` /
``session://`` / ``mock-s3://`` or any registered scheme), every write
is crash-safe (tmp → fsync → rename), and the manager returns a
:meth:`Checkpoint.from_uri` handle, so the "latest checkpoint" a gang
restart resumes from survives the death of the node that reported it.

A small JSON index file per run (``train-<run>-ckpts.json``) records the
persisted sequence; a new ``Trainer`` under the same ``RunConfig.name``
loads it and auto-resumes from the newest entry. With ``session://``
this spans gang restarts within one cluster session; with ``file://`` on
shared storage or ``mock-s3://`` (and real remote schemes registered via
``register_spill_backend``) it also spans full driver restarts.

Sharded checkpoints (per-rank ``.shard-<rank>`` files + a ``.manifest``
commit record — see ``sharded_checkpoint.py``) share the same index and
seq space. The *manifest* is the commit point: :meth:`register_sharded`
writes it only after every rank's shard write was acked, and
``_load_index`` reconciles storage against committed manifests — shard
files no committed manifest references (mid-save crash debris) and
manifests with missing/corrupt shards are garbage-collected
(``ray_tpu_train_ckpt_orphans_gc_total``), while valid manifests that
merely lost their index entry (crash between commit and index write)
are adopted back. The JSON index is a rebuildable cache, never the
source of truth.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import spill
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig

logger = logging.getLogger("ray_tpu_torch.train")


def _count_persist_failure(what: str) -> None:
    try:
        from ray_tpu_torch._private import builtin_metrics, events
        builtin_metrics.train_checkpoint_persist_failures().inc()
        events.emit("train", f"durable checkpoint {what} write failed",
                    severity="error", labels={"what": what})
    except Exception:  # noqa: BLE001 - accounting never breaks training
        pass


def normalize_storage_uri(storage_path: str) -> str:
    """``RunConfig.storage_path`` → spill URI: plain paths become
    absolute ``file://`` URIs; anything with a scheme passes through."""
    if "://" in storage_path:
        return storage_path
    return "file://" + os.path.abspath(storage_path)


def _current_session_id() -> str:
    """The running runtime's session id, or "" with none up; asking
    starts no runtime."""
    from ray_tpu_torch._private.worker import global_worker
    return getattr(global_worker._runtime, "session_id", "")


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "-" for c in name)


class CheckpointManager:
    """Persists reported checkpoints for one run through a spill backend,
    honoring ``CheckpointConfig.num_to_keep`` /
    ``checkpoint_score_attribute``, and finds the newest durable
    checkpoint for auto-resume."""

    def __init__(self, storage_path: str, run_name: str,
                 checkpoint_config: Optional[CheckpointConfig] = None):
        self.config = checkpoint_config or CheckpointConfig()
        self.run_name = _sanitize(run_name or "train")
        self.base_uri = normalize_storage_uri(storage_path)
        self._backend = spill.backend_for_uri(
            self.base_uri, session_id=_current_session_id())
        # [{"uri","seq","score"}] oldest-first; sharded entries add
        # {"sharded": True, "files": [shard filenames]}. seq is
        # monotonic across restarts of the same run (resumed from the
        # index).
        self._tracked: List[Dict[str, Any]] = []
        self._seq = 0
        self._load_index()

    # -- index -------------------------------------------------------------

    @property
    def _index_filename(self) -> str:
        return f"train-{self.run_name}-ckpts.json"

    def _load_index(self) -> None:
        raw = self._backend.read(
            self._backend.uri_for(self._index_filename))
        if raw is not None:
            try:
                index = json.loads(raw.decode())
                self._seq = int(index.get("seq", 0))
                self._tracked = [
                    e for e in index.get("checkpoints", [])
                    if isinstance(e, dict) and e.get("uri")
                ]
            except (ValueError, UnicodeDecodeError):
                logger.warning("corrupt checkpoint index for run %r; "
                               "starting a fresh index", self.run_name)
        self._gc_orphans()

    def _gc_orphans(self) -> None:
        """Reconcile storage against committed manifests (runs at every
        index load — i.e. manager construction, when no save is in
        flight). Three cases: shard files referenced by no committed
        manifest (a rank died mid-save, or a pre-shrink stale rank) are
        deleted; manifests whose shards are missing/short/corrupt are
        uncommitted (manifest + surviving shards deleted); valid
        manifests absent from the index (crash after commit, before the
        index write) are adopted back in."""
        from ray_tpu_torch.train._internal import sharded_checkpoint as sc
        names = self._backend.list_files(
            prefix=sc.ckpt_prefix(self.run_name))
        shard_names = [n for n in names if sc.is_shard_file(n)]
        manifest_names = [n for n in names if sc.is_manifest_file(n)]
        if not shard_names and not manifest_names:
            return
        verify = sc.verify_checksums_default()
        indexed = {e["uri"] for e in self._tracked}
        referenced: set = set()
        removed = 0
        adopted = 0
        changed = False
        for name in manifest_names:
            uri = self._backend.uri_for(name)
            manifest = sc.read_manifest(uri)
            ok = manifest is not None and sc.validate_shards(
                self._backend, manifest, verify)
            if not ok:
                # Uncommitted/torn: drop the manifest first, then any
                # shards it names — they revert to unreferenced debris.
                self._backend.delete(uri)
                removed += 1
                if manifest is not None:
                    for shard in manifest.get("shards", []):
                        if shard["file"] in shard_names:
                            self._backend.delete(
                                self._backend.uri_for(shard["file"]))
                            shard_names.remove(shard["file"])
                            removed += 1
                if uri in indexed:
                    self._tracked = [e for e in self._tracked
                                     if e["uri"] != uri]
                    changed = True
                continue
            referenced.update(s["file"] for s in manifest["shards"])
            seq = int(manifest["seq"])
            self._seq = max(self._seq, seq)
            if uri not in indexed:
                self._tracked.append({
                    "uri": uri, "seq": seq, "score": None,
                    "sharded": True,
                    "files": [s["file"] for s in manifest["shards"]],
                })
                adopted += 1
                changed = True
        for name in shard_names:
            if name not in referenced:
                self._backend.delete(self._backend.uri_for(name))
                removed += 1
        if changed:
            self._tracked.sort(key=lambda e: e["seq"])
            self._write_index()
        if removed or adopted:
            try:
                from ray_tpu_torch._private import builtin_metrics, events
                if removed:
                    builtin_metrics.train_ckpt_orphans_gc().inc(removed)
                events.emit(
                    "train",
                    f"checkpoint GC for run {self.run_name!r}: "
                    f"{removed} orphan file(s) removed, "
                    f"{adopted} committed manifest(s) adopted",
                    severity="warning" if removed else "info",
                    labels={"run": self.run_name, "event": "ckpt_gc",
                            "removed": str(removed),
                            "adopted": str(adopted)})
            except Exception:  # noqa: BLE001 - GC accounting is best-effort
                pass

    def _write_index(self) -> None:
        payload = json.dumps({
            "seq": self._seq,
            "checkpoints": self._tracked,
        }).encode()
        try:
            self._backend.write(self._index_filename, payload)
        except spill.SpillFailure as exc:
            # The checkpoint itself landed; a stale index only costs
            # auto-resume precision, never training progress.
            logger.warning("checkpoint index write failed: %s", exc)
            _count_persist_failure("index")

    # -- registration ------------------------------------------------------

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict[str, Any]] = None) -> Checkpoint:
        """Persist one reported checkpoint; returns the durable
        :meth:`Checkpoint.from_uri` handle to restore from (or the
        original checkpoint unchanged if the write failed — training
        must not die because storage hiccuped)."""
        self._seq += 1
        filename = f"train-{self.run_name}-ckpt-{self._seq:06d}.ckpt"
        try:
            uri = self._backend.write(filename, checkpoint._payload_bytes())
        except spill.SpillFailure as exc:
            self._seq -= 1
            logger.warning(
                "durable checkpoint write failed (%s); gang restart will "
                "fall back to the in-memory checkpoint", exc)
            _count_persist_failure("checkpoint")
            return checkpoint
        score = None
        attr = self.config.checkpoint_score_attribute
        if attr and metrics is not None:
            value = metrics.get(attr)
            if isinstance(value, (int, float)):
                score = float(value)
        self._tracked.append({"uri": uri, "seq": self._seq, "score": score})
        self._prune()
        self._write_index()
        try:
            from ray_tpu_torch._private import builtin_metrics
            builtin_metrics.train_checkpoints_persisted().inc()
        except Exception:  # noqa: BLE001 - metrics never break training
            pass
        return Checkpoint.from_uri(uri)

    def next_seq_base(self) -> int:
        """The seq the next sharded save attempt should use. Handed to
        the gang at (re)start so every rank writes shard files under the
        same agreed seq; a failed/uncommitted attempt may reuse its seq
        (shard writes are atomic overwrites, and GC reaps strays)."""
        return self._seq + 1

    def register_sharded(self, seq: int, tree_meta: Dict[str, Any],
                         shard_records: List[Dict[str, Any]],
                         metrics: Optional[Dict[str, Any]] = None):
        """Phase two of a sharded save: every rank's shard write has
        been acked — write the manifest (THE commit point), index it,
        prune. Returns the durable ``ShardedCheckpoint`` handle, or
        None when the commit failed (previous checkpoint still stands;
        the uncommitted shard set is invisible and GC'd later)."""
        from ray_tpu_torch.train._internal import sharded_checkpoint as sc
        ranks = sorted(int(r["rank"]) for r in shard_records)
        if ranks != list(range(len(ranks))) or not ranks:
            raise ValueError(
                f"sharded save acked by ranks {ranks}; need a full "
                f"contiguous gang to commit")
        manifest = sc.build_manifest(self.run_name, seq, tree_meta,
                                     shard_records)
        try:
            uri = sc.write_manifest(self._backend, self.run_name, seq,
                                    manifest)
        except spill.SpillFailure as exc:
            logger.warning(
                "sharded checkpoint commit (manifest write) failed (%s); "
                "shard set seq=%d stays uncommitted", exc, seq)
            _count_persist_failure("manifest")
            return None
        self._seq = max(self._seq, int(seq))
        score = None
        attr = self.config.checkpoint_score_attribute
        if attr and metrics is not None:
            value = metrics.get(attr)
            if isinstance(value, (int, float)):
                score = float(value)
        self._tracked.append({
            "uri": uri, "seq": int(seq), "score": score, "sharded": True,
            "files": [s["file"] for s in manifest["shards"]],
        })
        self._tracked.sort(key=lambda e: e["seq"])
        self._prune()
        self._write_index()
        total_bytes = sum(int(s["bytes"]) for s in manifest["shards"])
        try:
            from ray_tpu_torch._private import builtin_metrics, events
            builtin_metrics.train_checkpoints_persisted().inc()
            events.emit(
                "train",
                f"sharded checkpoint seq={seq} committed: "
                f"{len(shard_records)} shard(s), {total_bytes} bytes, "
                f"mesh {tree_meta.get('mesh')}",
                labels={"run": self.run_name, "event": "ckpt_commit",
                        "seq": str(seq),
                        "shards": str(len(shard_records)),
                        "bytes": str(total_bytes)})
        except Exception:  # noqa: BLE001 - accounting never breaks saves
            pass
        return sc.ShardedCheckpoint(manifest, uri)

    def _delete_entry(self, entry: Dict[str, Any]) -> None:
        """Remove one checkpoint's storage. Sharded entries delete the
        manifest FIRST (uncommitting the set), then the shard files —
        a crash mid-prune leaves only unreferenced shards, which is
        exactly the orphan-GC path."""
        self._backend.delete(entry["uri"])
        for name in entry.get("files", []):
            self._backend.delete(self._backend.uri_for(name))

    def _prune(self) -> None:
        keep = self.config.num_to_keep
        if not keep or len(self._tracked) <= keep:
            return
        newest = max(self._tracked, key=lambda e: e["seq"])
        if self.config.checkpoint_score_attribute:
            # Best-by-score, but the newest checkpoint is always
            # retained — it is what a gang restart resumes from.
            reverse = self.config.checkpoint_score_order != "min"
            worst = float("-inf") if reverse else float("inf")
            ranked = sorted(
                self._tracked,
                key=lambda e: (e["score"] if e["score"] is not None
                               else worst),
                reverse=reverse)
            kept = ranked[:keep]
            if newest not in kept:
                kept[-1] = newest
        else:
            kept = sorted(self._tracked,
                          key=lambda e: e["seq"])[-keep:]
        kept_uris = {e["uri"] for e in kept}
        for entry in self._tracked:
            if entry["uri"] not in kept_uris:
                self._delete_entry(entry)
        self._tracked = sorted(kept, key=lambda e: e["seq"])

    # -- resume ------------------------------------------------------------

    def _handle(self, entry: Dict[str, Any]) -> Optional[Checkpoint]:
        if not entry.get("sharded"):
            return Checkpoint.from_uri(entry["uri"])
        from ray_tpu_torch.train._internal import sharded_checkpoint as sc
        try:
            return sc.ShardedCheckpoint.from_manifest_uri(entry["uri"])
        except ValueError:
            logger.warning("committed sharded checkpoint %s lost its "
                           "manifest; skipping", entry["uri"])
            return None

    def latest(self) -> Optional[Checkpoint]:
        """The newest persisted checkpoint of this run, or None. Only
        *committed* checkpoints live in ``_tracked`` — a shard set whose
        manifest was never written is invisible here by construction."""
        for entry in sorted(self._tracked, key=lambda e: e["seq"],
                            reverse=True):
            handle = self._handle(entry)
            if handle is not None:
                return handle
        return None

    def best(self) -> Optional[Checkpoint]:
        """The best-scored persisted checkpoint (falls back to newest
        when no score attribute is configured/recorded)."""
        scored = [e for e in self._tracked if e["score"] is not None]
        if not scored:
            return self.latest()
        reverse = self.config.checkpoint_score_order != "min"
        for entry in sorted(scored, key=lambda e: e["score"],
                            reverse=reverse):
            handle = self._handle(entry)
            if handle is not None:
                return handle
        return self.latest()
