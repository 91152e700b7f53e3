"""Built-in metrics of the port, under the names of
``ray_tpu/_private/builtin_metrics.py``: the decode loop's pair,
``@serve.batch``'s pair, spill's failures and the train checkpoints'.

Each accessor (re-)binds its metric through the registry, so
``util.metrics.clear_registry()`` in tests cannot orphan the
instrumentation: the next event simply re-registers.
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram


def serve_batch_size() -> Gauge:
    return Gauge(
        "ray_tpu_serve_batch_size",
        "Size of the last executed @serve.batch batch, per batched "
        "function (adaptive batching moves this with load).",
        tag_keys=("fn",))


def serve_batch_size_limit() -> Gauge:
    return Gauge(
        "ray_tpu_serve_batch_size_limit",
        "Current adaptive max-batch-size operating point of a "
        "@serve.batch queue (AIMD-tuned against the latency budget).",
        tag_keys=("fn",))


def serve_decode_active_slots() -> Gauge:
    return Gauge(
        "ray_tpu_serve_decode_active_slots",
        "Occupied slots in a continuous-batching decode loop, per "
        "engine (fixed-shape batch; free slots admit new sequences at "
        "iteration boundaries).",
        tag_keys=("engine",))


def serve_decode_admitted() -> Counter:
    return Counter(
        "ray_tpu_serve_decode_admitted_total",
        "Sequences admitted into a continuous-batching decode loop, "
        "by admission kind (fresh = loop was idle, running = joined a "
        "live decode batch at an iteration boundary).",
        tag_keys=("engine", "kind"))


def object_spill_failures() -> Counter:
    return Counter(
        "ray_tpu_object_spill_failures_total",
        "Spill-backend IO failures by op (write = spill kept the "
        "in-memory copy instead; restore = tier miss, recovery fell "
        "down a tier). Includes chaos-injected io_oserror faults.",
        tag_keys=("op",))


# -- train checkpoints ------------------------------------------------------
# Per-rank sharded saves (train/_internal/sharded_checkpoint.py): every
# rank writes only its local shard, the manifest commit is rank 0's.


def train_checkpoints_persisted() -> Counter:
    return Counter(
        "ray_tpu_train_checkpoints_persisted_total",
        "Reported train checkpoints persisted durably through the "
        "storage_path spill backend (what a gang restart resumes from).")


def train_checkpoint_persist_failures() -> Counter:
    return Counter(
        "ray_tpu_train_checkpoint_persist_failures_total",
        "Reported checkpoints whose durable persist raised SpillFailure "
        "(training continues on the in-memory copy; a gang restart "
        "would resume from an older checkpoint). Watched by the "
        "checkpoint_persist_failures alert rule.")


def train_ckpt_shard_bytes() -> Counter:
    return Counter(
        "ray_tpu_train_ckpt_shard_bytes_total",
        "Bytes of checkpoint shard files written, by rank — N live rank "
        "labels per save is the signature of the parallel sharded path "
        "(a single-writer monolithic save only moves rank 0).",
        tag_keys=("rank",))


def train_ckpt_save_seconds() -> Histogram:
    return Histogram(
        "ray_tpu_train_ckpt_save_seconds",
        "End-to-end sharded save wall time: slowest rank's shard write "
        "plus the manifest commit.",
        boundaries=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0, 600.0))


def train_ckpt_restore_seconds() -> Histogram:
    return Histogram(
        "ray_tpu_train_ckpt_restore_seconds",
        "Per-rank sharded checkpoint restore wall time (byte-range "
        "reads + reassembly; includes reshard overlap math when the "
        "mesh changed).",
        boundaries=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0, 600.0))


def train_ckpt_orphans_gc() -> Counter:
    return Counter(
        "ray_tpu_train_ckpt_orphans_gc_total",
        "Orphaned checkpoint files garbage-collected at index load: "
        "shard files no committed manifest references (mid-save crash "
        "debris) and manifests with missing/corrupt shards.")
