"""A3C: asynchronous advantage actor-critic.

The port of ``ray_tpu/rllib/algorithms/a3c.py`` (the reference's
rllib/algorithms/a3c): same loss as A2C, but gradients are computed from
per-worker batches and applied in *arrival order* — each worker samples
with the weights it was handed at launch, so later updates in a round are
computed against slightly stale parameters (the hogwild-style asynchrony
that distinguishes A3C from A2C's synchronous barrier). One training_step
launches every worker once and drains completions with
``ray_tpu_torch.wait``; each batch is applied by the learner on
``config.device``.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig


class A3CConfig(A2CConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or A3C)
        self.lr = 1e-3
        self.grad_clip = 40.0


class A3C(A2C):
    _default_config_class = A3CConfig

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: A3CConfig = self.config
        workers = self.workers.remote_workers
        per_worker = max(config.train_batch_size // len(workers), 1)
        # Launch: every worker gets the current weights, then samples.
        weights_ref = ray_tpu_torch.put(self.get_weights())
        pending = {}
        for w in workers:
            w.set_weights.remote(weights_ref)
            pending[w.sample.remote(per_worker)] = w
        metrics: Dict[str, Any] = {}
        n_applied = 0
        # Drain in completion order; each batch's gradient was computed
        # from launch-time weights but is applied to the newest params.
        while pending:
            done, _ = ray_tpu_torch.wait(list(pending), num_returns=1)
            ref = done[0]
            pending.pop(ref)
            batch = ray_tpu_torch.get(ref)
            self._timesteps_total += len(batch)
            metrics = self.learn_on_batch(batch)
            n_applied += 1
        out = dict(metrics)
        out["async_grad_updates"] = n_applied
        return out
