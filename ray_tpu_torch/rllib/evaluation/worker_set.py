"""WorkerSet: the fleet of rollout actors.

Analog of the reference's rllib/evaluation/worker_set.py:78: creates N
RolloutWorker actors, broadcasts weights, gathers sampled batches and
episode stats in parallel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import ray_tpu_torch
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class WorkerSet:
    def __init__(self, env_creator: Callable, policy_config: Dict[str, Any],
                 num_workers: int, seed: int = 0,
                 num_cpus_per_worker: float = 1.0):
        self.is_multi_agent = bool(policy_config.get("policies"))
        if self.is_multi_agent:
            from ray_tpu_torch.rllib.evaluation.multi_agent_worker import (
                MultiAgentRolloutWorker)
            worker_cls = MultiAgentRolloutWorker
        else:
            worker_cls = RolloutWorker
        # Workers that derive per-worker state (APEX exploration epsilons)
        # need to know the fleet size.
        policy_config = dict(policy_config, num_workers=num_workers)
        cls = ray_tpu_torch.remote(worker_cls)
        self._workers = [
            cls.options(num_cpus=num_cpus_per_worker).remote(
                env_creator, policy_config, worker_index=i + 1, seed=seed)
            for i in range(num_workers)]

    @property
    def remote_workers(self) -> List[Any]:
        return self._workers

    def num_workers(self) -> int:
        return len(self._workers)

    def sync_weights(self, weights_ref) -> None:
        ray_tpu_torch.get([w.set_weights.remote(weights_ref)
                     for w in self._workers])

    def sample(self, steps_per_worker: int):
        batches = ray_tpu_torch.get([w.sample.remote(steps_per_worker)
                               for w in self._workers])
        if self.is_multi_agent:
            from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch
            return MultiAgentBatch.concat_samples(batches)
        return SampleBatch.concat_samples(batches)

    def episode_stats(self) -> Dict[str, float]:
        import numpy as np
        stats = ray_tpu_torch.get([w.episode_stats.remote()
                             for w in self._workers])
        rewards = [s["episode_reward_mean"] for s in stats
                   if s["episodes"] > 0]
        lengths = [s["episode_len_mean"] for s in stats
                   if s["episodes"] > 0]
        return {
            "episodes_total": sum(s["episodes"] for s in stats),
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "episode_len_mean": float(np.mean(lengths)) if lengths
            else float("nan"),
        }

    def stop(self) -> None:
        for w in self._workers:
            ray_tpu_torch.kill(w)
