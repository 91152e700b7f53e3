"""Trial schedulers: FIFO, ASHA, HyperBand, median stopping, and PBT.

Analogs of the reference's tune/schedulers/: async_hyperband.py
(ASHAScheduler), hyperband.py (HyperBandScheduler), median_stopping_rule.py
(MedianStoppingRule), and pbt.py (PopulationBasedTraining). Schedulers see
every trial report via ``on_result`` and return CONTINUE / STOP / EXPLOIT;
EXPLOIT (PBT only) tells the runner to restart the trial from a stronger
trial's checkpoint with a mutated config (fetched via ``exploit_info``).
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    def on_result(self, trial_id: str, metrics: dict) -> str:
        return CONTINUE


class ASHAScheduler:
    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = None, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestone -> {trial_id: signed metric at crossing}
        self._rungs: Dict[int, Dict[str, float]] = {}
        rung = grace_period
        while rung < max_t:
            self._rungs[rung] = {}
            rung *= reduction_factor

    def set_metric(self, metric: str, mode: str):
        if self.metric is None:
            self.metric = metric
            self.mode = mode

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        signed = value if self.mode == "max" else -value
        for rung in sorted(self._rungs, reverse=True):
            if t < rung:
                continue
            recorded = self._rungs[rung]
            # Record this trial's value at its first crossing of the rung.
            recorded.setdefault(trial_id, signed)
            # Decide on every report past the rung (not just at crossing):
            # a weak trial that crossed before enough peers had recorded is
            # still cut as soon as the quantile is established.
            if len(recorded) >= self.rf:
                ordered = sorted(recorded.values(), reverse=True)
                cutoff = ordered[max(0, len(ordered) // self.rf - 1)]
                if recorded[trial_id] < cutoff:
                    return STOP
            break
        return CONTINUE


class HyperBandScheduler:
    """Synchronous HyperBand (reference: tune/schedulers/hyperband.py).

    Trials are assigned round-robin to brackets; each bracket runs
    successive halving: at each milestone, the bottom ``1 - 1/eta`` of the
    bracket's live trials are stopped. Synchronous semantics are
    approximated per report: a trial reaching a milestone is held against
    the values recorded so far at that milestone and cut once enough peers
    have reported.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = None, mode: str = "max",
                 max_t: int = 81, reduction_factor: int = 3):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.eta = reduction_factor
        # s_max + 1 brackets per generation; bracket s holds up to eta^s
        # trials starting with budget r = max_t / eta^s.
        # round() before int(): log(1000)/log(10) = 2.999... must give 3.
        self.s_max = int(round(math.log(max_t) / math.log(self.eta), 10))
        # Flat list of live brackets: (milestones, capacity, count). A new
        # generation of brackets is appended when all existing ones fill,
        # as the reference creates fresh bracket cohorts on demand.
        self._brackets: List[list] = []
        self._trial_bracket: Dict[str, int] = {}
        self._new_generation()

    def _new_generation(self) -> None:
        # Most exploratory bracket (largest s, smallest initial budget)
        # fills first.
        for s in range(self.s_max, -1, -1):
            r = max(1, int(self.max_t / (self.eta ** s)))
            milestones: Dict[int, Dict[str, float]] = {}
            t = r
            while t < self.max_t:
                milestones[t] = {}
                t *= self.eta
            self._brackets.append([milestones, self.eta ** s, 0])

    def set_metric(self, metric: str, mode: str):
        if self.metric is None:
            self.metric = metric
            self.mode = mode

    def _bracket_for(self, trial_id: str) -> Dict[int, Dict[str, float]]:
        if trial_id not in self._trial_bracket:
            index = next((i for i, (_, cap, n) in enumerate(self._brackets)
                          if n < cap), None)
            if index is None:
                index = len(self._brackets)
                self._new_generation()
            self._brackets[index][2] += 1
            self._trial_bracket[trial_id] = index
        return self._brackets[self._trial_bracket[trial_id]][0]

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        signed = value if self.mode == "max" else -value
        milestones = self._bracket_for(trial_id)
        for milestone in sorted(milestones, reverse=True):
            if t < milestone:
                continue
            recorded = milestones[milestone]
            recorded.setdefault(trial_id, signed)
            if len(recorded) >= self.eta:
                ordered = sorted(recorded.values(), reverse=True)
                keep = max(1, len(ordered) // self.eta)
                cutoff = ordered[keep - 1]
                if recorded[trial_id] < cutoff:
                    return STOP
            break
        return CONTINUE


class MedianStoppingRule:
    """Stop a trial whose best result so far is worse than the median of
    the running averages of all completed-enough peers at the same time
    step (reference: tune/schedulers/median_stopping_rule.py).
    """

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = None, mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3,
                 hard_stop: bool = True):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.hard_stop = hard_stop
        # trial_id -> list of (t, signed value)
        self._history: Dict[str, List[Tuple[float, float]]] = {}

    def set_metric(self, metric: str, mode: str):
        if self.metric is None:
            self.metric = metric
            self.mode = mode

    def _running_avg(self, trial_id: str, up_to_t: float) -> Optional[float]:
        points = [v for (t, v) in self._history.get(trial_id, ())
                  if t <= up_to_t]
        return sum(points) / len(points) if points else None

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        signed = value if self.mode == "max" else -value
        self._history.setdefault(trial_id, []).append((t, signed))
        if t < self.grace_period:
            return CONTINUE
        peer_avgs = [
            avg for other, hist in self._history.items()
            if other != trial_id
            for avg in [self._running_avg(other, t)]
            if avg is not None
        ]
        if len(peer_avgs) < self.min_samples:
            return CONTINUE
        peer_avgs.sort()
        median = peer_avgs[len(peer_avgs) // 2]
        best = max(v for (_, v) in self._history[trial_id])
        if best < median:
            return STOP if self.hard_stop else CONTINUE
        return CONTINUE


class PopulationBasedTraining:
    """PBT (reference: tune/schedulers/pbt.py).

    Every ``perturbation_interval`` steps of ``time_attr``, a trial in the
    bottom ``quantile_fraction`` of the population exploits a trial from the
    top quantile: the runner restarts it from the donor's latest checkpoint
    with a mutated copy of the donor's config. ``on_result`` returns EXPLOIT
    for such trials; the runner then calls ``exploit_info(trial_id)``.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str = None, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 perturbation_factors: Tuple[float, float] = (0.8, 1.2),
                 custom_explore_fn: Optional[Callable[[dict], dict]] = None,
                 seed: int = 0):
        if not 0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.factors = perturbation_factors
        self.custom_explore_fn = custom_explore_fn
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = {}
        self._scores: Dict[str, float] = {}  # trial_id -> latest signed
        self._configs: Dict[str, dict] = {}  # trial_id -> current config
        self._exploit: Dict[str, Tuple[str, dict]] = {}
        self.num_perturbations = 0

    def set_metric(self, metric: str, mode: str):
        if self.metric is None:
            self.metric = metric
            self.mode = mode

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        self._configs[trial_id] = dict(config)

    def _quantiles(self) -> Tuple[List[str], List[str]]:
        ordered = sorted(self._scores, key=self._scores.get)
        if len(ordered) <= 1:
            return [], []
        num = int(math.ceil(len(ordered) * self.quantile))
        num = min(num, len(ordered) // 2)
        if num < 1:
            return [], []
        return ordered[:num], ordered[-num:]

    def _explore(self, config: dict) -> dict:
        from ray_tpu_torch.tune.search import Domain
        new = dict(config)
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob or key not in new:
                if isinstance(spec, Domain):
                    new[key] = spec.sample(self._rng)
                elif isinstance(spec, (list, tuple)):
                    new[key] = self._rng.choice(list(spec))
                elif callable(spec):
                    new[key] = spec()
            elif isinstance(spec, (list, tuple)):
                # Discrete list spec: step to an adjacent allowed value —
                # never perturb off the list (reference pbt.py semantics).
                values = list(spec)
                if new.get(key) in values:
                    i = values.index(new[key])
                    i = max(0, min(len(values) - 1,
                                   i + self._rng.choice((-1, 1))))
                    new[key] = values[i]
                else:
                    new[key] = self._rng.choice(values)
            elif isinstance(new.get(key), (int, float)) and not isinstance(
                    new.get(key), bool):
                factor = self._rng.choice(self.factors)
                mutated = new[key] * factor
                new[key] = type(config[key])(mutated) \
                    if isinstance(config[key], int) else mutated
        if self.custom_explore_fn is not None:
            new = self.custom_explore_fn(new)
        return new

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        signed = value if self.mode == "max" else -value
        self._scores[trial_id] = signed
        last = self._last_perturb.get(trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        lower, upper = self._quantiles()
        if trial_id not in lower or not upper:
            return CONTINUE
        donor = self._rng.choice(upper)
        donor_config = self._configs.get(donor, {})
        new_config = self._explore(donor_config)
        # Tentative until the runner confirms: if the donor has no
        # checkpoint yet the runner aborts, and this trial's recorded
        # config must stay what it is actually running.
        self._exploit[trial_id] = (donor, new_config)
        return EXPLOIT

    def exploit_info(self, trial_id: str) -> Tuple[str, dict]:
        """(donor_trial_id, mutated_config) for a trial told to EXPLOIT.
        Peek only — the runner then calls commit_exploit or abort_exploit."""
        return self._exploit[trial_id]

    def commit_exploit(self, trial_id: str) -> None:
        """The runner actually restarted the trial from the donor."""
        donor, new_config = self._exploit.pop(trial_id)
        self._configs[trial_id] = dict(new_config)
        self.num_perturbations += 1

    def abort_exploit(self, trial_id: str) -> None:
        """The exploit was skipped (e.g. donor had no checkpoint)."""
        self._exploit.pop(trial_id, None)
