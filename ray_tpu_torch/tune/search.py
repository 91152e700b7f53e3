"""Search spaces + variant generation.

Analog of the reference's tune/search/ (sample.py Domains,
basic_variant.py BasicVariantGenerator): grid_search entries expand as a
cross-product, Domain objects sample per trial, num_samples multiplies the
grid — matching reference semantics.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        import math
        self.log_low, self.log_high = math.log(low), math.log(high)

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(self.log_low, self.log_high))


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class RandInt(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class QUniform(Domain):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        value = rng.uniform(self.low, self.high)
        return round(value / self.q) * self.q


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def quniform(low, high, q) -> QUniform:
    return QUniform(low, high, q)


def grid_search(values) -> Dict[str, list]:
    return {"grid_search": list(values)}


def _is_grid(value) -> bool:
    return isinstance(value, dict) and set(value.keys()) == {"grid_search"}


def _expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cross-product over grid_search entries (non-recursive keys only at
    top level; nested dicts are recursed)."""
    variants: List[Dict[str, Any]] = [{}]
    for key, value in space.items():
        if _is_grid(value):
            variants = [dict(v, **{key: g}) for v in variants
                        for g in value["grid_search"]]
        elif isinstance(value, dict) and not _is_grid(value):
            subvariants = _expand_grid(value)
            variants = [dict(v, **{key: sub}) for v in variants
                        for sub in subvariants]
        else:
            variants = [dict(v, **{key: value}) for v in variants]
    return variants


def _sample_domains(config: Dict[str, Any], rng: random.Random
                    ) -> Dict[str, Any]:
    out = {}
    for key, value in config.items():
        if isinstance(value, Domain):
            out[key] = value.sample(rng)
        elif _is_grid(value):
            # Unexpanded grid marker (searcher path, where there is no
            # upfront cross-product): sample one of the grid values.
            out[key] = rng.choice(value["grid_search"])
        elif isinstance(value, dict):
            out[key] = _sample_domains(value, rng)
        elif callable(value) and getattr(value, "_tune_sample_fn", False):
            out[key] = value(None)
        else:
            out[key] = value
    return out


def sample_from(fn):
    """tune.sample_from equivalent."""
    fn._tune_sample_fn = True
    return fn


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> Iterator[Dict[str, Any]]:
    rng = random.Random(seed)
    grid = _expand_grid(param_space or {})
    for _ in range(num_samples):
        for variant in grid:
            yield _sample_domains(variant, rng)


# -- Searcher interface (reference: tune/search/searcher.py Searcher) -----

class Searcher:
    """Suggests configs and learns from completed trials.

    Analog of the reference's tune/search/searcher.py: ``suggest`` returns
    the next config (or None when exhausted), ``on_trial_complete`` feeds
    the final result back.
    """

    def set_search_properties(self, metric: str, mode: str,
                              param_space: Dict[str, Any],
                              num_samples: Optional[int] = None) -> None:
        self.metric = metric
        self.mode = mode
        self.param_space = param_space

    def expected_trials(self, num_samples: int) -> int:
        """Total trials this searcher intends to produce for the runner's
        ``num_samples`` setting (grid-expanding searchers return more)."""
        return num_samples

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None,
                          error: bool = False) -> None:
        pass

    def register_completed(self, trial_id: str, config: Dict[str, Any],
                           result: Optional[dict],
                           error: bool = False) -> None:
        """Feed an externally-recorded completed trial (restore replay):
        like on_trial_complete but with the config supplied, since the
        searcher never suggested it in this process."""
        pass

    def register_pending(self, trial_id: str,
                         config: Dict[str, Any]) -> None:
        """Adopt an externally-created in-flight trial (restore requeue) so
        its eventual on_trial_complete is credited to this config."""
        pass


class BasicVariantGenerator(Searcher):
    """Grid cross-product x num_samples with Domain sampling — the default
    searcher (reference: tune/search/basic_variant.py)."""

    def __init__(self, num_samples: int = 1, seed: int = 0):
        self.num_samples = num_samples
        self.seed = seed
        self._it: Optional[Iterator[Dict[str, Any]]] = None

    def set_search_properties(self, metric, mode, param_space,
                              num_samples=None):
        super().set_search_properties(metric, mode, param_space)
        if num_samples is not None:
            self.num_samples = max(self.num_samples, num_samples)
        self._it = generate_variants(param_space, self.num_samples,
                                     self.seed)

    def expected_trials(self, num_samples: int) -> int:
        grid = len(_expand_grid(self.param_space or {}))
        return max(self.num_samples, num_samples) * max(grid, 1)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        try:
            return next(self._it)
        except StopIteration:
            return None


class TPESearcher(Searcher):
    """Tree-structured-Parzen-style sequential searcher (the native analog
    of the reference's external-library searchers, tune/search/hyperopt/).

    After ``n_initial_points`` random configs, observations are split at the
    ``gamma`` quantile into good/bad sets; candidates are drawn from the
    good set's kernel density and scored by the good/bad density ratio.
    Numeric Domains only; non-numeric keys fall back to random sampling.
    """

    def __init__(self, n_initial_points: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._observations: List[tuple] = []  # (config, signed score)
        self._pending: Dict[str, Dict[str, Any]] = {}

    def _numeric_keys(self) -> List[str]:
        return [k for k, v in self.param_space.items()
                if isinstance(v, (Uniform, LogUniform, RandInt, QUniform))]

    def _random_config(self) -> Dict[str, Any]:
        return _sample_domains(self.param_space, self._rng)

    @staticmethod
    def _kde_logpdf(x: float, points: List[float], bandwidth: float
                    ) -> float:
        import math
        if not points:
            return 0.0
        total = 0.0
        for p in points:
            z = (x - p) / bandwidth
            total += math.exp(-0.5 * z * z)
        return math.log(total / (len(points) * bandwidth) + 1e-12)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        keys = self._numeric_keys()
        if len(self._observations) < self.n_initial or not keys:
            config = self._random_config()
            self._pending[trial_id] = config
            return config
        ordered = sorted(self._observations, key=lambda o: -o[1])
        n_good = max(1, int(len(ordered) * self.gamma))
        good = [c for c, _ in ordered[:n_good]]
        bad = [c for c, _ in ordered[n_good:]] or good
        best, best_score = None, None
        for _ in range(self.n_candidates):
            candidate = self._random_config()
            # Mutate candidate toward the good set on numeric keys.
            donor = self._rng.choice(good)
            for key in keys:
                if self._rng.random() < 0.75:
                    candidate[key] = donor[key]
            score = 0.0
            for key in keys:
                values_g = [c[key] for c in good]
                values_b = [c[key] for c in bad]
                spread = (max(values_g + values_b) -
                          min(values_g + values_b)) or 1.0
                bw = max(spread / 4.0, 1e-9)
                score += (self._kde_logpdf(candidate[key], values_g, bw) -
                          self._kde_logpdf(candidate[key], values_b, bw))
            if best_score is None or score > best_score:
                best, best_score = candidate, score
        self._pending[trial_id] = best
        return best

    def on_trial_complete(self, trial_id, result=None, error=False):
        config = self._pending.pop(trial_id, None)
        self._observe(config, result, error)

    def register_completed(self, trial_id, config, result, error=False):
        self._observe(config, result, error)

    def register_pending(self, trial_id, config):
        self._pending[trial_id] = dict(config)

    def _observe(self, config, result, error):
        if config is None or error or not result:
            return
        value = result.get(self.metric)
        if value is None:
            return
        signed = value if self.mode == "max" else -value
        self._observations.append((config, signed))


class BOHBSearcher(TPESearcher):
    """Native BOHB (Falkner et al. 2018): TPE-style density-ratio
    suggestions whose model is built from observations at the LARGEST
    budget with enough samples — pair with HyperBandScheduler, whose
    rungs stop trials at different training_iteration budgets, exactly
    the reference's TuneBOHB + HB pairing (tune/search/bohb/ wraps the
    external hpbandster; this is the in-tree equivalent).

    Budgets are read from the completing trial's ``training_iteration``
    (the scheduler's rung = how long the trial was allowed to run);
    a model over high-budget observations transfers to suggestions for
    new (low-budget) trials, which is BOHB's core move."""

    def __init__(self, n_initial_points: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, min_points_per_budget: int = 6,
                 seed: int = 0):
        super().__init__(n_initial_points=n_initial_points, gamma=gamma,
                         n_candidates=n_candidates, seed=seed)
        self.min_points_per_budget = min_points_per_budget
        self._by_budget: Dict[int, List[tuple]] = {}

    def _observe(self, config, result, error):
        if config is None or error or not result:
            return
        value = result.get(self.metric)
        if value is None:
            return
        signed = value if self.mode == "max" else -value
        budget = int(result.get("training_iteration", 1) or 1)
        self._by_budget.setdefault(budget, []).append((config, signed))
        self._refresh_model()

    def _refresh_model(self) -> None:
        """Point _observations at the largest budget with enough
        samples (falling back to pooling everything below it)."""
        for budget in sorted(self._by_budget, reverse=True):
            rows = self._by_budget[budget]
            if len(rows) >= self.min_points_per_budget:
                self._observations = list(rows)
                return
        pooled: List[tuple] = []
        for rows in self._by_budget.values():
            pooled.extend(rows)
        self._observations = pooled

    def model_budget(self) -> Optional[int]:
        """The budget whose observations currently drive suggestions
        (None while pooling across budgets)."""
        for budget in sorted(self._by_budget, reverse=True):
            if len(self._by_budget[budget]) >=                     self.min_points_per_budget:
                return budget
        return None


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference: tune/search/
    concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, param_space,
                              num_samples=None):
        super().set_search_properties(metric, mode, param_space)
        self.searcher.set_search_properties(metric, mode, param_space,
                                            num_samples)

    def expected_trials(self, num_samples: int) -> int:
        return self.searcher.expected_trials(num_samples)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return None
        config = self.searcher.suggest(trial_id)
        if config is not None:
            self._live.add(trial_id)
        return config

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    def register_completed(self, trial_id, config, result, error=False):
        self.searcher.register_completed(trial_id, config, result, error)

    def register_pending(self, trial_id, config):
        # The requeued trial occupies a concurrency slot like any other
        # in-flight suggestion; it frees on completion.
        self._live.add(trial_id)
        self.searcher.register_pending(trial_id, config)


class BayesOptSearch(Searcher):
    """Gaussian-process Bayesian optimization (the native analog of the
    reference's tune/search/bayesopt/ wrapper around bayes_opt).

    Numeric domains are normalized to [0, 1] (log-scaled for LogUniform); a
    GP with an RBF kernel is fit on completed observations (numpy Cholesky)
    and the next config maximizes Expected Improvement over random
    candidates. Non-numeric keys fall back to random sampling.
    """

    def __init__(self, n_initial_points: int = 6, n_candidates: int = 256,
                 kernel_scale: float = 0.2, noise: float = 1e-6,
                 seed: int = 0):
        self.n_initial = n_initial_points
        self.n_candidates = n_candidates
        self.kernel_scale = kernel_scale
        self.noise = noise
        self._rng = random.Random(seed)
        self._observations: List[tuple] = []  # (config, signed score)
        self._pending: Dict[str, Dict[str, Any]] = {}

    def _numeric_keys(self) -> List[str]:
        return [k for k in sorted(self.param_space)
                if isinstance(self.param_space[k],
                              (Uniform, LogUniform, RandInt, QUniform))]

    def _to_unit(self, key: str, value: float) -> float:
        import math
        dom = self.param_space[key]
        if isinstance(dom, LogUniform):
            lo, hi = dom.log_low, dom.log_high
            return (math.log(value) - lo) / max(hi - lo, 1e-12)
        lo, hi = float(dom.low), float(dom.high)
        return (float(value) - lo) / max(hi - lo, 1e-12)

    def _features(self, config: Dict[str, Any]):
        import numpy as np
        return np.asarray([self._to_unit(k, config[k])
                           for k in self._numeric_keys()])

    def _gp_posterior(self, X, y, Xc):
        """GP posterior mean/std at candidates Xc (RBF kernel)."""
        import numpy as np

        def rbf(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / self.kernel_scale ** 2)

        K = rbf(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
        Ks = rbf(X, Xc)
        mu = Ks.T @ alpha
        v = np.linalg.solve(L, Ks)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return mu, np.sqrt(var)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        import numpy as np
        keys = self._numeric_keys()
        if len(self._observations) < self.n_initial or not keys:
            config = _sample_domains(self.param_space, self._rng)
            self._pending[trial_id] = config
            return config
        X = np.stack([self._features(c) for c, _ in self._observations])
        y = np.asarray([s for _, s in self._observations], dtype=float)
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mean) / y_std
        candidates = [_sample_domains(self.param_space, self._rng)
                      for _ in range(self.n_candidates)]
        Xc = np.stack([self._features(c) for c in candidates])
        mu, sigma = self._gp_posterior(X, yn, Xc)
        best = yn.max()
        # Expected Improvement.
        z = (mu - best) / sigma
        phi = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
        Phi = 0.5 * (1.0 + np.vectorize(math_erf)(z / np.sqrt(2)))
        ei = sigma * (z * Phi + phi)
        config = candidates[int(ei.argmax())]
        self._pending[trial_id] = config
        return config

    def on_trial_complete(self, trial_id, result=None, error=False):
        config = self._pending.pop(trial_id, None)
        self._observe(config, result, error)

    def register_completed(self, trial_id, config, result, error=False):
        self._observe(config, result, error)

    def register_pending(self, trial_id, config):
        self._pending[trial_id] = dict(config)

    def _observe(self, config, result, error):
        if config is None or error or not result:
            return
        value = result.get(self.metric)
        if value is None:
            return
        signed = value if self.mode == "max" else -value
        self._observations.append((config, signed))


def math_erf(x: float) -> float:
    import math
    return math.erf(x)


#: Reference-named alias (tune/search/bohb/ TuneBOHB): the budget-aware
#: searcher IS the BOHB sampling component; pair with HyperBandScheduler
#: for the reference's HB_BOHB.
TuneBOHB = BOHBSearcher
