"""Tune callbacks + loggers.

Analog of the reference's tune/callback.py (Callback hooks invoked by the
trial-runner event loop) and tune/logger/ (CSVLoggerCallback,
JsonLoggerCallback writing per-trial progress files under the experiment
directory).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class Callback:
    """Hooks the trial runner invokes (reference: tune/callback.py)."""

    def setup(self, **info) -> None:
        pass

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        pass

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          error: Optional[BaseException] = None) -> None:
        pass

    def on_experiment_end(self, results: List[Any]) -> None:
        pass


class LoggerCallback(Callback):
    """Base for per-trial file loggers; resolves each trial's directory."""

    def __init__(self, experiment_dir: Optional[str] = None):
        self._experiment_dir = experiment_dir
        self._trial_dirs: Dict[str, str] = {}

    def setup(self, experiment_dir: Optional[str] = None, **info) -> None:
        if experiment_dir is not None:
            self._experiment_dir = experiment_dir

    def _trial_dir(self, trial_id: str) -> str:
        if trial_id not in self._trial_dirs:
            base = self._experiment_dir or os.path.join(
                os.path.expanduser("~"), "ray_tpu_results")
            path = os.path.join(base, trial_id)
            os.makedirs(path, exist_ok=True)
            self._trial_dirs[trial_id] = path
        return self._trial_dirs[trial_id]


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in d.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "/"))
        else:
            out[name] = value
    return out


class CSVLoggerCallback(LoggerCallback):
    """progress.csv per trial (reference: tune/logger/csv.py)."""

    def __init__(self, experiment_dir: Optional[str] = None):
        super().__init__(experiment_dir)
        self._files: Dict[str, Any] = {}
        self._writers: Dict[str, csv.DictWriter] = {}

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        flat = _flatten(result)
        if trial_id not in self._writers:
            path = os.path.join(self._trial_dir(trial_id), "progress.csv")
            f = open(path, "w", newline="")
            writer = csv.DictWriter(f, fieldnames=list(flat.keys()),
                                    extrasaction="ignore")
            writer.writeheader()
            self._files[trial_id] = f
            self._writers[trial_id] = writer
        self._writers[trial_id].writerow(flat)
        self._files[trial_id].flush()

    def on_trial_complete(self, trial_id, error=None) -> None:
        f = self._files.pop(trial_id, None)
        if f is not None:
            f.close()
        self._writers.pop(trial_id, None)

    def on_experiment_end(self, results) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._writers.clear()


class JsonLoggerCallback(LoggerCallback):
    """result.json (one JSON line per report) per trial
    (reference: tune/logger/json.py)."""

    def __init__(self, experiment_dir: Optional[str] = None):
        super().__init__(experiment_dir)
        self._seen: set = set()

    def setup(self, experiment_dir: Optional[str] = None, **info) -> None:
        super().setup(experiment_dir=experiment_dir, **info)
        # Scope the truncation guard to one fit(): a restore that reuses
        # this callback instance must truncate stale result.json again.
        self._seen.clear()

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        path = os.path.join(self._trial_dir(trial_id), "params.json")
        with open(path, "w") as f:
            json.dump(config, f, default=repr)
        if trial_id not in self._seen:
            # First start in this process: truncate any stale result.json
            # left by a pre-restore run of the same trial (a PBT exploit
            # relaunch in the same process keeps appending).
            self._seen.add(trial_id)
            result_path = os.path.join(self._trial_dir(trial_id),
                                       "result.json")
            open(result_path, "w").close()

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        path = os.path.join(self._trial_dir(trial_id), "result.json")
        with open(path, "a") as f:
            f.write(json.dumps(result, default=repr) + "\n")


def _tb_events_record(payload: bytes) -> bytes:
    """Frame one TFRecord: length, masked-crc(length), payload,
    masked-crc(payload) — the event-file format TensorBoard reads."""
    import struct

    def crc32c(data: bytes) -> int:
        # Pure-python CRC32C (Castagnoli), table-driven.
        table = _CRC32C_TABLE
        crc = 0xFFFFFFFF
        for b in data:
            crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF

    def mask(crc: int) -> int:
        return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF

    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", mask(crc32c(header)))
            + payload + struct.pack("<I", mask(crc32c(payload))))


def _make_crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(num: int, wire: int, payload: bytes) -> bytes:
    return _pb_varint((num << 3) | wire) + payload


def _tb_scalar_event(step: int, wall_time: float, tag: str,
                     value: float) -> bytes:
    """Hand-encoded tensorflow.Event proto holding one scalar Summary
    (Event{wall_time=1, step=2, summary=5{value=1{tag=1, simple_value=2}}})."""
    import struct
    sv = _pb_field(1, 2, _pb_varint(len(tag.encode()))
                   + tag.encode())  # Summary.Value.tag
    sv += _pb_field(2, 5, struct.pack("<f", float(value)))  # simple_value
    summary_value = _pb_field(1, 2, _pb_varint(len(sv)) + sv)
    event = _pb_field(1, 1, struct.pack("<d", wall_time))
    event += _pb_field(2, 0, _pb_varint(step))
    event += _pb_field(5, 2, _pb_varint(len(summary_value)) + summary_value)
    return event


class TBXLoggerCallback(LoggerCallback):
    """TensorBoard event files per trial, written natively (no tensorboard
    dependency) — the analog of the reference's tune/logger/tensorboardx.py.
    Numeric result fields become scalar summaries keyed ``ray/tune/<name>``.
    """

    def __init__(self, experiment_dir: Optional[str] = None):
        super().__init__(experiment_dir)
        self._files: Dict[str, Any] = {}
        self._steps: Dict[str, int] = {}

    def _file(self, trial_id: str):
        if trial_id not in self._files:
            import socket
            import time as _time
            fname = (f"events.out.tfevents.{int(_time.time())}."
                     f"{socket.gethostname()}")
            path = os.path.join(self._trial_dir(trial_id), fname)
            f = open(path, "ab")
            # File-version header event.
            import struct
            ver = b"brain.Event:2"
            event = (_pb_field(1, 1, struct.pack("<d", _time.time()))
                     + _pb_field(3, 2, _pb_varint(len(ver)) + ver))
            f.write(_tb_events_record(event))
            self._files[trial_id] = f
        return self._files[trial_id]

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        import numbers
        import time as _time
        f = self._file(trial_id)
        step = self._steps.get(trial_id, 0) + 1
        self._steps[trial_id] = step
        step_val = result.get("training_iteration", step)
        for key, value in _flatten(result).items():
            if isinstance(value, numbers.Number) and not isinstance(
                    value, bool):
                f.write(_tb_events_record(_tb_scalar_event(
                    int(step_val), _time.time(), f"ray/tune/{key}",
                    float(value))))
        f.flush()

    def on_trial_complete(self, trial_id, error=None) -> None:
        f = self._files.pop(trial_id, None)
        if f is not None:
            f.close()

    def on_experiment_end(self, results) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class WandbLoggerCallback(Callback):
    """Weights & Biases logging (reference: air/callbacks/wandb.py). Gated:
    raises at setup if the wandb package is unavailable."""

    def __init__(self, project: str, group: Optional[str] = None,
                 **init_kwargs):
        self.project = project
        self.group = group
        self.init_kwargs = init_kwargs
        self._runs: Dict[str, Any] = {}

    def setup(self, **info) -> None:
        try:
            import wandb  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "WandbLoggerCallback requires the `wandb` package, which "
                "is not installed in this environment.") from exc

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        import wandb
        self._runs[trial_id] = wandb.init(
            project=self.project, group=self.group, name=trial_id,
            config=config, reinit=True, **self.init_kwargs)

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        run = self._runs.get(trial_id)
        if run is not None:
            run.log(_flatten(result))

    def on_trial_complete(self, trial_id, error=None) -> None:
        run = self._runs.pop(trial_id, None)
        if run is not None:
            run.finish()


class MLflowLoggerCallback(Callback):
    """MLflow tracking (reference: air/callbacks/mlflow.py). Gated: raises
    at setup if mlflow is unavailable."""

    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: str = "ray_tpu"):
        self.tracking_uri = tracking_uri
        self.experiment_name = experiment_name
        self._run_ids: Dict[str, str] = {}

    def setup(self, **info) -> None:
        try:
            import mlflow
            from mlflow.tracking import MlflowClient
        except ImportError as exc:
            raise ImportError(
                "MLflowLoggerCallback requires the `mlflow` package, which "
                "is not installed in this environment.") from exc
        if self.tracking_uri:
            mlflow.set_tracking_uri(self.tracking_uri)
        # Client API throughout: concurrent trials must not share mlflow's
        # fluent (thread-local stack) run state — ending one trial's run
        # must never terminate another's.
        self._client = MlflowClient()
        exp = self._client.get_experiment_by_name(self.experiment_name)
        self._experiment_id = (exp.experiment_id if exp is not None else
                               self._client.create_experiment(
                                   self.experiment_name))

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        run = self._client.create_run(
            self._experiment_id, tags={"mlflow.runName": trial_id})
        self._run_ids[trial_id] = run.info.run_id
        for k, v in _flatten(config).items():
            self._client.log_param(run.info.run_id, k, v)

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        import numbers
        run_id = self._run_ids.get(trial_id)
        if run_id:
            for k, v in _flatten(result).items():
                if isinstance(v, numbers.Number) and not isinstance(v, bool):
                    self._client.log_metric(run_id, k, float(v))

    def on_trial_complete(self, trial_id, error=None) -> None:
        run_id = self._run_ids.pop(trial_id, None)
        if run_id:
            self._client.set_terminated(
                run_id, status="FAILED" if error else "FINISHED")


class SyncerCallback(Callback):
    """Mirror trial/experiment output to a destination directory after
    every result (the local-FS analog of the reference's tune/syncer.py
    cloud upload; 'file://' and plain paths supported)."""

    def __init__(self, upload_dir: str, sync_period_s: float = 300.0):
        # Reference default: sync every 300s — a full-tree copy per result
        # would stall the (synchronous) callback loop.
        self.upload_dir = upload_dir[7:] if upload_dir.startswith(
            "file://") else upload_dir
        self.sync_period_s = sync_period_s
        self._last_sync: Optional[float] = None
        self._experiment_dir: Optional[str] = None

    def setup(self, experiment_dir: Optional[str] = None, **info) -> None:
        self._experiment_dir = experiment_dir

    def _sync(self, force: bool = False) -> None:
        import shutil
        import time as _time
        if not self._experiment_dir or not os.path.isdir(
                self._experiment_dir):
            return
        now = _time.monotonic()
        if (not force and self._last_sync is not None
                and now - self._last_sync < self.sync_period_s):
            return
        self._last_sync = now
        dest = os.path.join(self.upload_dir,
                            os.path.basename(self._experiment_dir))
        shutil.copytree(self._experiment_dir, dest, dirs_exist_ok=True)

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        self._sync()

    def on_experiment_end(self, results) -> None:
        self._sync(force=True)
