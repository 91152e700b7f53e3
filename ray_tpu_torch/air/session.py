"""Train/Tune session: the in-loop API (report, world rank, checkpoint).

Analog of the reference's python/ray/air/session.py:41 (session.report) and
train/_internal/session.py (_TrainSession's bounded result queue). Each train
worker / trial has a _Session bound to its execution context; ``report``
blocks on a size-1 queue until the driver consumes the result — exactly the
reference's backpressure semantics.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


class StopSession(BaseException):
    """Raised inside report() when the driver stopped this worker/trial
    (e.g. an early-stopping scheduler). Inherits BaseException so user
    ``except Exception`` blocks don't swallow it."""


class _Session:
    def __init__(self, world_rank: int = 0, world_size: int = 1,
                 local_rank: int = 0, trial_id: str = "",
                 trial_name: str = "", config: Optional[dict] = None,
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[dict] = None,
                 ckpt_ctx: Optional[dict] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.trial_id = trial_id
        self.trial_name = trial_name
        self.config = config or {}
        self.loaded_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        # Sharded-checkpoint context from the BackendExecutor: the run
        # name, storage URI, and agreed seq base every rank writes its
        # shard files under (see report_sharded).
        self.ckpt_ctx = ckpt_ctx
        # Set by the TrainWorker so a chaos kill fired inside a shard
        # write makes the whole rank play dead, not just the one call.
        self.on_chaos_kill = None
        self._shard_reports = 0
        self._shard_backend = None
        # Size-1 queue: the worker blocks in report() until the driver drains
        # (reference: train/_internal/session.py:63 queue.Queue(1)).
        self.result_queue: "queue.Queue" = queue.Queue(1)
        self.continue_event = threading.Event()
        self.stop_requested = False
        self.finished = False

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None,
               shard: Optional[dict] = None) -> None:
        if self.stop_requested:
            raise StopSession()
        result = {"metrics": dict(metrics), "checkpoint": checkpoint}
        if shard is not None:
            result["shard"] = shard
        self.result_queue.put(result)
        self.continue_event.wait()
        self.continue_event.clear()
        if self.stop_requested:
            raise StopSession()

    def report_sharded(self, metrics: Dict[str, Any], state: Any,
                       specs: Optional[dict] = None,
                       axes_items=None,
                       extra: Optional[Dict[str, Any]] = None) -> None:
        """Report metrics plus THIS RANK's checkpoint shard.

        Phase one of the two-phase sharded save: the rank extracts its
        local parameter blocks from ``state`` (per ``specs``; default:
        dim 0 of every array over an ``fsdp`` axis of ``world_size``)
        and writes one ``.shard-<rank>`` file through the run's spill
        backend. The shard record rides the ordinary result payload to
        the driver as the write's ack; the driver commits the manifest
        only once every rank acked. A failed write reports
        ``{"error": ...}`` instead — the driver fails that save attempt
        cleanly and training continues from the previous checkpoint.
        """
        from ray_tpu_torch._private import chaos, spill
        from ray_tpu_torch.train._internal import sharded_checkpoint as sc
        ctx = self.ckpt_ctx
        if ctx is None:
            raise RuntimeError(
                "report_sharded needs a sharded-checkpoint context: run "
                "under a trainer with RunConfig.storage_path set")
        if self._shard_backend is None:
            self._shard_backend = spill.backend_for_uri(
                ctx["storage_uri"], session_id=ctx.get("session_id", ""))
        seq = int(ctx["seq_base"]) + self._shard_reports
        self._shard_reports += 1
        local = None
        laid_out = (None if _state_layout is None
                    else _state_layout(state, self.world_rank,
                                       self.world_size))
        if laid_out is not None:
            # A train state that is not a tree of arrays, laid out by its
            # owner: this rank's own blocks, and stand-ins of the whole
            # leaves for build_tree_meta.
            if specs is not None or axes_items is not None:
                raise ValueError("a train state's specs and axes are its "
                                 "mesh's and rules'; pass neither")
            local, flat, structure, specs, axes_items = laid_out
        if axes_items is None:
            axes_items = [("fsdp", self.world_size)]
        if local is None:
            flat, structure = sc.flatten_tree(state)
        if specs is None:
            specs = sc.default_specs(flat, axis=axes_items[0][0])
        try:
            if local is None:
                local = sc.extract_local_shard(flat, specs, axes_items,
                                               self.world_rank)
            record = sc.write_shard(self._shard_backend, ctx["run"], seq,
                                    self.world_rank, local)
        except chaos.ChaosKill:
            if self.on_chaos_kill is not None:
                self.on_chaos_kill()
            raise
        except spill.SpillFailure as exc:
            record = {"seq": seq, "rank": self.world_rank,
                      "error": str(exc)}
        if self.world_rank == 0 and "error" not in record:
            record["tree_meta"] = sc.build_tree_meta(
                flat, structure, specs, axes_items, extra)
        self.report(metrics, shard=record)


# How report_sharded lays out a train state that is not a tree of arrays:
# (state, rank, world) -> None for a state it does not know, else (the
# rank's blocks by path, whole leaves or stand-ins of their shape and
# dtype, the tree's structure, the specs, the mesh's axes). The trainer
# that owns such a state sets it (train.torch.checkpoint).
_state_layout: Optional[Callable[[Any, int, int], Optional[tuple]]] = None


def set_state_layout(layout) -> None:
    global _state_layout
    _state_layout = layout


# One session per OS thread: train workers are actor threads, so
# thread-local storage gives each worker its own session.
_local = threading.local()


def _set_session(session: Optional[_Session]) -> None:
    _local.session = session


def _get_session() -> Optional[_Session]:
    return getattr(_local, "session", None)


def _require_session() -> _Session:
    s = _get_session()
    if s is None:
        raise RuntimeError(
            "No session active: this API must be called inside a train loop "
            "or Tune trainable run by JaxTrainer/Tuner.")
    return s


# -- public API (reference: air/session.py) ------------------------------

def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _require_session().report(metrics, checkpoint)


def report_sharded(metrics: Dict[str, Any], state: Any,
                   specs: Optional[dict] = None, axes_items=None,
                   extra: Optional[Dict[str, Any]] = None) -> None:
    """Report metrics + this rank's shard of ``state`` (per-rank sharded
    checkpointing; commits when every rank of the round has reported)."""
    _require_session().report_sharded(metrics, state, specs=specs,
                                      axes_items=axes_items, extra=extra)


def get_checkpoint() -> Optional[Checkpoint]:
    return _require_session().loaded_checkpoint


def get_world_rank() -> int:
    return _require_session().world_rank


def get_world_size() -> int:
    return _require_session().world_size


def get_local_rank() -> int:
    return _require_session().local_rank


def get_trial_id() -> str:
    return _require_session().trial_id


def get_trial_name() -> str:
    return _require_session().trial_name


def get_config() -> dict:
    return dict(_require_session().config)


def get_dataset_shard(name: str = "train"):
    shard = _require_session().dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"No dataset shard named {name!r} was passed to the trainer "
            f"(available: {list(_require_session().dataset_shards)})")
    return shard
