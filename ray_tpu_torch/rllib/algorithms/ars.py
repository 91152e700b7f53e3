"""ARS: augmented random search.

The port of ``ray_tpu/rllib/algorithms/ars.py`` (the reference's
rllib/algorithms/ars, Mania et al. 2018): the same antithetic
random-perturbation machinery as ES (shared noise table, evaluator
actors), but the update keeps only the ``deltas_used`` best directions
(ranked by max(r+, r-)), weights them by the raw return difference, and
scales the step by the standard deviation of the used returns instead of
rank shaping — the "V1-t" variant of the paper, on the catalog MLP
policy.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.algorithms.es import ES, ESConfig


class ARSConfig(ESConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ARS)
        self.noise_stdev = 0.05
        self.stepsize = 0.03
        self.deltas_used = 8  # top directions kept per update

    def training(self, *, deltas_used=None, **kwargs) -> "ARSConfig":
        super().training(**kwargs)
        if deltas_used is not None:
            self.deltas_used = deltas_used
        return self


class ARS(ES):
    _default_config_class = ARSConfig

    def _gradient(self, indices, returns_pos, returns_neg) -> np.ndarray:
        config: ARSConfig = self.config
        dim = self._theta.numel()
        # Keep the top-k directions by best-of-pair return.
        scores = np.maximum(returns_pos, returns_neg)
        k = min(config.deltas_used, len(indices))
        top = np.argsort(scores)[::-1][:k]
        used = np.concatenate([returns_pos[top], returns_neg[top]])
        sigma_r = max(float(used.std()), 1e-6)
        g = np.zeros(dim, np.float32)
        for i in top:
            g += (returns_pos[i] - returns_neg[i]) * \
                self._noise[indices[i]:indices[i] + dim]
        return g / (k * sigma_r)
