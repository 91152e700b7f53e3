"""CQL: conservative Q-learning for offline RL.

The port of ``ray_tpu/rllib/algorithms/cql.py`` (the reference's
rllib/algorithms/cql, built on its SAC stack, as here): SAC's twin-critic
maximum-entropy update plus the CQL(H) conservative regularizer — for
each critic, push down a log-sum-exp over out-of-distribution actions
(uniform proposals and current-policy samples at s and s',
importance-corrected by their log-densities) and push up the Q of the
logged dataset actions. Offline-only: the replay buffer is filled once
from JSON experience files and never touched by rollouts.

The proposals' noise is explicit, as SAC's: :meth:`CQL.draw_noise` adds
"rand" (``[n, B, A]`` uniforms in [0, 1), scaled to the Box as
``jax.random.uniform(minval=low, maxval=high)`` scales them), "cur" and
"next" (``[n, B, A]`` standard normals for the policy samples at s and
s').
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig, q_apply


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or CQL)
        self.num_rollout_workers = 0  # offline: WorkerSet stays empty
        self.min_q_weight = 5.0
        self.num_ood_actions = 4  # proposals per source per state
        self.num_train_batches_per_iteration = 32

    def training(self, *, min_q_weight=None, num_ood_actions=None,
                 **kwargs) -> "CQLConfig":
        super().training(**kwargs)
        if min_q_weight is not None:
            self.min_q_weight = min_q_weight
        if num_ood_actions is not None:
            self.num_ood_actions = num_ood_actions
        return self


class CQL(SAC):
    _default_config_class = CQLConfig

    def __init__(self, config=None, **kwargs):
        cfg = config or self.get_default_config()
        if not cfg.input_:
            raise ValueError(
                "CQL is offline-only: set "
                "config.offline_data(input_=<dir of JSON experience files>)")
        super().__init__(config=config, **kwargs)

    def draw_noise(self, batch: int) -> Dict[str, torch.Tensor]:
        noise = super().draw_noise(batch)
        policy = self.local_policy
        shape = (self.config.num_ood_actions, batch, policy.act_dim)
        noise["rand"] = torch.rand(shape, generator=self._gen,
                                   device=policy.device)
        for k in ("cur", "next"):
            noise[k] = torch.randn(shape, generator=self._gen,
                                   device=policy.device)
        return noise

    def _conservative_penalty(self, q_params, actor_params, mb, noise):
        config: CQLConfig = self.config
        policy = self.local_policy
        n = config.num_ood_actions
        low, high = policy.low_t, policy.high_t
        batch = mb["obs"].shape[0]

        # Proposal set: uniform actions + policy samples at s and s',
        # each importance-corrected by its proposal log-density (CQL(H)).
        rand_a = torch.maximum(low, noise["rand"] * (high - low) + low)
        log_unif = -torch.log(high - low).sum()  # density of U[low, high]

        def pi_samples(obs, eps):
            # The n samples of each state as one batch of n * B rows.
            rows = obs.reshape((1,) + obs.shape).expand(
                (n,) + obs.shape).reshape((n * batch,) + obs.shape[1:])
            a, logp = policy.logp_and_sample(
                actor_params, rows, eps.reshape(n * batch, -1))
            return a.reshape(n, batch, -1), logp.reshape(n, batch)

        with torch.no_grad():
            cur_a, cur_logp = pi_samples(mb["obs"], noise["cur"])
            next_a, next_logp = pi_samples(mb["new_obs"], noise["next"])

        obs_rows = mb["obs"].reshape((1,) + mb["obs"].shape).expand(
            (n,) + mb["obs"].shape).reshape(
                (n * batch,) + mb["obs"].shape[1:])
        penalty = 0.0
        for name in ("q1", "q2"):
            def q_at(actions):
                return q_apply(q_params[name], obs_rows,
                               actions.reshape(n * batch, -1)).reshape(
                                   n, batch)  # (n, B)

            cat = torch.cat([
                q_at(rand_a) - log_unif,
                q_at(cur_a) - cur_logp,
                q_at(next_a) - next_logp,
            ], dim=0)  # (3n, B)
            ood = torch.logsumexp(cat, dim=0) - math.log(3 * n)
            data_q = q_apply(q_params[name], mb["obs"], mb["actions"])
            penalty = penalty + (ood - data_q).mean()
        return config.min_q_weight * penalty

    def setup(self, config: CQLConfig) -> None:
        super().setup(config)
        from ray_tpu_torch.rllib.offline.json_reader import JsonReader
        from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer
        data = JsonReader(config.input_).read_all()
        if len(data) > self._buffer.capacity:
            # Offline training must see the whole dataset — never let the
            # inherited online-replay capacity ring-drop rows silently.
            self._buffer = ReplayBuffer(len(data), seed=config.seed)
        self._buffer.add(data)
        self._dataset_size = len(data)

    def training_step(self) -> Dict[str, Any]:
        config: CQLConfig = self.config
        out = self._train_on_buffer(config.num_train_batches_per_iteration)
        self._timesteps_total += (config.num_train_batches_per_iteration
                                  * config.train_batch_size)
        out["dataset_size"] = self._dataset_size
        return out
