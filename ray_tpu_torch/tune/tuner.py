"""Tuner + trial runner + ResultGrid.

Analog of the reference's tune/tuner.py:44 (Tuner.fit) and the
TrialRunner.step event loop (tune/execution/trial_runner.py:268,931): each
trial is an actor (reference: ray_trial_executor.py:191); the runner
multiplexes trial results with ray.wait, feeds the scheduler and searcher,
stops trials early on scheduler decisions, restarts trials from donor
checkpoints on PBT EXPLOIT, invokes callbacks, and snapshots experiment
state for ``Tuner.restore`` (reference: tune/execution/trial_runner.py
checkpointing + tuner.py Tuner.restore).
"""

from __future__ import annotations

import json
import logging
import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._internal.worker_group import TrainWorker
from ray_tpu_torch.tune.schedulers import CONTINUE, EXPLOIT, FIFOScheduler, STOP
from ray_tpu_torch.tune.search import Searcher, generate_variants

logger = logging.getLogger("ray_tpu_torch.tune")

_EXPERIMENT_STATE_FILE = "experiment_state.json"


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    search_alg: Optional[Searcher] = None
    seed: int = 0


@dataclass
class _Trial:
    trial_id: str
    config: Dict[str, Any]
    actor: Any = None
    history: List[dict] = field(default_factory=list)
    iteration: int = 0
    error: Optional[BaseException] = None
    done: bool = False
    stopped: bool = False
    checkpoint: Any = None


class ResultGrid:
    def __init__(self, results: List[Result], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("Specify metric= (none set in TuneConfig)")
        candidates = []
        for r in self._results:
            values = [h[metric] for h in r.metrics_history if metric in h]
            if not values:
                continue
            best = max(values) if mode == "max" else min(values)
            candidates.append((best, r))
        if not candidates:
            raise ValueError(f"No trial reported metric {metric!r}")
        candidates.sort(key=lambda t: t[0], reverse=(mode == "max"))
        return candidates[0][1]

    def get_dataframe(self):
        import pandas as pd
        rows = []
        for r in self._results:
            row = dict(r.metrics)
            row["trial_id"] = r.trial_id
            row.update({f"config/{k}": v for k, v in r.config.items()})
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(self, trainable: Callable = None, *,
                 param_space: Optional[dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 _restored_state: Optional[dict] = None):
        from ray_tpu_torch.train.base_trainer import BaseTrainer
        if isinstance(trainable, BaseTrainer):
            self._trainable = trainable.as_trainable()
        else:
            self._trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._trial_resources = getattr(
            trainable, "_tune_resources", None) or {"num_cpus": 1}
        self._restored_state = _restored_state

    # -- restore (reference: tune/tuner.py Tuner.restore) -----------------

    @classmethod
    def restore(cls, path: str, trainable: Callable, *,
                param_space: Optional[dict] = None,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[RunConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its directory: finished
        trials keep their recorded results, unfinished ones rerun.

        Schedulers, searchers, stop criteria, and callbacks are not
        serialized in the experiment snapshot — pass the same ``tune_config``
        / ``run_config`` objects used for the original run to keep their
        semantics on the resumed trials (reference: tune/tuner.py
        Tuner.restore takes the re-specified trainable the same way)."""
        import dataclasses

        state_file = os.path.join(path, _EXPERIMENT_STATE_FILE)
        with open(state_file) as f:
            state = json.load(f)
        if tune_config is None:
            tune_config = TuneConfig(
                metric=state["metric"], mode=state["mode"],
                num_samples=state["num_samples"])
        else:
            # Merge into a copy — never mutate the caller's object.
            updates = {}
            if tune_config.metric is None:
                # metric and mode travel together: backfilling one from the
                # snapshot but not the other could flip the optimization
                # direction.
                updates["metric"] = state["metric"]
                updates["mode"] = state["mode"]
            if tune_config.num_samples < state["num_samples"]:
                updates["num_samples"] = state["num_samples"]
            tune_config = dataclasses.replace(tune_config, **updates)
        if run_config is None:
            run_config = RunConfig(name=state.get("name"),
                                   storage_path=state.get("storage_path"))
        else:
            updates = {}
            if run_config.name is None:
                updates["name"] = state.get("name")
            if run_config.storage_path is None:
                updates["storage_path"] = state.get("storage_path")
            run_config = dataclasses.replace(run_config, **updates)
        return cls(trainable, param_space=param_space or {},
                   tune_config=tune_config, run_config=run_config,
                   _restored_state=state)

    def experiment_dir(self) -> Optional[str]:
        if not self.run_config.storage_path:
            return None
        name = self.run_config.name or "tune_experiment"
        return os.path.join(self.run_config.storage_path, name)

    def _snapshot(self, trials: List[_Trial], num_created: int,
                  pending_configs: Optional[list] = None) -> None:
        exp_dir = self.experiment_dir()
        if not exp_dir:
            return
        os.makedirs(exp_dir, exist_ok=True)
        state = {
            "pending_configs": _jsonable(pending_configs or []),
            "metric": self.tune_config.metric,
            "mode": self.tune_config.mode,
            "num_samples": self.tune_config.num_samples,
            "name": self.run_config.name,
            "storage_path": self.run_config.storage_path,
            "num_created": num_created,
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "config": _jsonable(t.config),
                    "done": t.done,
                    "error": repr(t.error) if t.error is not None else None,
                    "history": _jsonable(t.history),
                }
                for t in trials
            ],
        }
        tmp = os.path.join(exp_dir, _EXPERIMENT_STATE_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(exp_dir, _EXPERIMENT_STATE_FILE))

    # -- the event loop ---------------------------------------------------

    def fit(self) -> ResultGrid:
        cfg = self.tune_config
        scheduler = cfg.scheduler or FIFOScheduler()
        if hasattr(scheduler, "set_metric") and cfg.metric:
            scheduler.set_metric(cfg.metric, cfg.mode)
        searcher = cfg.search_alg
        if searcher is not None:
            searcher.set_search_properties(cfg.metric, cfg.mode,
                                           self.param_space,
                                           num_samples=cfg.num_samples)
            target_trials = searcher.expected_trials(cfg.num_samples)
            variants = None
        else:
            variants = list(generate_variants(
                self.param_space, cfg.num_samples, cfg.seed))
            target_trials = len(variants)

        callbacks = list(getattr(self.run_config, "callbacks", None) or [])
        for cb in callbacks:
            cb.setup(experiment_dir=self.experiment_dir())

        trials: List[_Trial] = []
        num_created = 0

        # Restored experiments: replay finished trials, requeue the rest.
        restore_queue: List[_Trial] = []
        if self._restored_state is not None:
            for ts in self._restored_state["trials"]:
                trial = _Trial(trial_id=ts["trial_id"], config=ts["config"],
                               history=ts["history"], done=ts["done"])
                num_created += 1
                if ts["done"] and ts["error"] is None:
                    trials.append(trial)
                    if searcher is not None:
                        # Replay the recorded outcome so the searcher's
                        # model includes pre-crash observations.
                        searcher.register_completed(
                            trial.trial_id, trial.config,
                            trial.history[-1] if trial.history else None)
                else:
                    trial.done = False
                    trial.history = []
                    restore_queue.append(trial)
                    if searcher is not None:
                        # Register as pending so the searcher credits the
                        # rerun's completion to this config (it never
                        # suggest()-ed the trial in this process).
                        searcher.register_pending(trial.trial_id,
                                                  trial.config)
            for config in self._restored_state.get("pending_configs", []):
                trial = _Trial(
                    trial_id=(f"trial_{num_created:05d}_"
                              f"{uuid.uuid4().hex[:4]}"),
                    config=config)
                num_created += 1
                restore_queue.append(trial)
            if searcher is not None:
                # A restored searcher keeps producing its remaining samples.
                target_trials = max(num_created, target_trials)
            else:
                target_trials = num_created
            # The placeholder variants built from the (empty) restore
            # param_space must never leak into snapshots as pending work.
            variants = None

        max_concurrent = cfg.max_concurrent_trials or max(target_trials, 1)
        running: Dict[Any, _Trial] = {}  # outstanding result ref -> trial

        def next_trial() -> Optional[_Trial]:
            nonlocal num_created
            if restore_queue:
                return restore_queue.pop(0)
            if num_created >= target_trials:
                return None
            if searcher is not None:
                trial_id = f"trial_{num_created:05d}_{uuid.uuid4().hex[:4]}"
                config = searcher.suggest(trial_id)
                if config is None:
                    return None  # exhausted or concurrency-limited
                num_created += 1
                return _Trial(trial_id=trial_id, config=config)
            config = variants[num_created]
            trial = _Trial(
                trial_id=f"trial_{num_created:05d}_{uuid.uuid4().hex[:4]}",
                config=config)
            num_created += 1
            return trial

        def launch(trial: _Trial, checkpoint=None):
            actor_cls = TrainWorker.options(**self._trial_resources)
            trial.actor = actor_cls.remote(0, 1)
            # Don't block on creation: actor tasks are ordered, so the
            # result stream ref resolves once the trial actually starts —
            # trials queue naturally behind available resources.
            trial.actor.start_training.remote(
                self._trainable, trial.config,
                {"trial_id": trial.trial_id, "trial_name": trial.trial_id},
                checkpoint)
            ref = trial.actor.get_next_result.remote()
            running[ref] = trial
            if trial not in trials:
                trials.append(trial)
            if hasattr(scheduler, "on_trial_start"):
                scheduler.on_trial_start(trial.trial_id, trial.config)
            for cb in callbacks:
                cb.on_trial_start(trial.trial_id, trial.config)

        def fill_slots():
            while len(running) < max_concurrent:
                trial = next_trial()
                if trial is None:
                    break
                launch(trial)

        fill_slots()

        while running:
            ready, _ = ray_tpu_torch.wait(list(running.keys()), num_returns=1,
                                    timeout=None)
            ref = ready[0]
            trial = running.pop(ref)
            payload = ray_tpu_torch.get(ref)
            if payload.get("finished") or payload.get("timeout"):
                trial.done = True
                trial.error = payload.get("error")
                if payload.get("timeout"):
                    trial.error = TimeoutError("trial timed out")
                ray_tpu_torch.kill(trial.actor)
                if searcher is not None:
                    searcher.on_trial_complete(
                        trial.trial_id,
                        trial.history[-1] if trial.history else None,
                        error=trial.error is not None)
                for cb in callbacks:
                    cb.on_trial_complete(trial.trial_id, trial.error)
                self._snapshot(trials, num_created,
                               variants[num_created:] if variants else [])
                fill_slots()
                continue
            metrics = dict(payload.get("metrics", {}))
            if payload.get("checkpoint") is not None:
                trial.checkpoint = payload["checkpoint"]
            trial.iteration += 1
            metrics.setdefault("training_iteration", trial.iteration)
            trial.history.append(metrics)
            for cb in callbacks:
                cb.on_trial_result(trial.trial_id, metrics)
            decision = scheduler.on_result(trial.trial_id, metrics)
            if decision == EXPLOIT:
                donor_id, new_config = scheduler.exploit_info(trial.trial_id)
                donor = next((t for t in trials
                              if t.trial_id == donor_id), None)
                donor_ckpt = donor.checkpoint if donor is not None else None
                if donor_ckpt is not None:
                    logger.info("PBT: %s exploits %s",
                                trial.trial_id, donor_id)
                    # Restart this trial from the donor's checkpoint with
                    # the mutated config (reference: pbt.py _exploit).
                    scheduler.commit_exploit(trial.trial_id)
                    # Stop the trial and wait for its end: a trainer's gang
                    # is shut down, and its lease freed, before the kill.
                    trial.actor.request_stop.remote()
                    while not ray_tpu_torch.get(
                            trial.actor.get_next_result.remote()).get(
                                "finished"):
                        pass
                    ray_tpu_torch.kill(trial.actor)
                    trial.config = new_config
                    launch(trial, checkpoint=donor_ckpt)
                    continue
                # Donor has no checkpoint yet: restarting would lose all
                # progress for nothing — keep the trial running
                # (reference pbt.py skips checkpointless exploits). The
                # scheduler must forget the tentative exploit too.
                scheduler.abort_exploit(trial.trial_id)
                decision = CONTINUE
            if decision == STOP or self._hit_stop_criteria(metrics):
                trial.stopped = True
                trial.actor.request_stop.remote()
            # Re-arm the result stream for this trial.
            ref = trial.actor.get_next_result.remote()
            running[ref] = trial

        results = [
            Result(metrics=t.history[-1] if t.history else {},
                   metrics_history=t.history, config=t.config,
                   error=t.error, trial_id=t.trial_id,
                   checkpoint=t.checkpoint)
            for t in trials
        ]
        self._snapshot(trials, num_created,
                       variants[num_created:] if variants else [])
        for cb in callbacks:
            cb.on_experiment_end(results)
        errs = [r for r in results if r.error is not None]
        if errs:
            logger.warning("%d/%d trials errored", len(errs), len(results))
        return ResultGrid(results, cfg.metric, cfg.mode)

    def _hit_stop_criteria(self, metrics: dict) -> bool:
        stop = self.run_config.stop if self.run_config else None
        if not stop:
            return False
        return any(metrics.get(k) is not None and metrics[k] >= v
                   for k, v in stop.items())


def _jsonable(obj):
    """Deep-copy obj keeping only JSON-serializable leaves (repr others)."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        pass
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return repr(obj)
