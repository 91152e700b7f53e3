"""SampleBatch: columnar container for trajectories.

Analog of the reference's rllib/policy/sample_batch.py: a dict of equal-
length numpy arrays with the standard column names, plus concat / slice /
shuffle / minibatch helpers. Kept as host numpy; the learner device_puts
whole minibatches (TPU-first: one transfer per SGD step).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np


class SampleBatch(dict):
    OBS = "obs"
    NEXT_OBS = "new_obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    ACTION_LOGP = "action_logp"
    VF_PREDS = "vf_preds"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"
    EPS_ID = "eps_id"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in keys})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, seed: Optional[int] = None) -> "SampleBatch":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, minibatch_size: int,
                    seed: Optional[int] = None) -> Iterator["SampleBatch"]:
        shuffled = self.shuffle(seed)
        for start in range(0, len(self), minibatch_size):
            mb = shuffled.slice(start, start + minibatch_size)
            if len(mb) == minibatch_size:
                yield mb

    def split_by_episode(self) -> List["SampleBatch"]:
        if self.EPS_ID not in self:
            return [self]
        eps = self[self.EPS_ID]
        out = []
        start = 0
        for i in range(1, len(eps) + 1):
            if i == len(eps) or eps[i] != eps[start]:
                out.append(self.slice(start, i))
                start = i
        return out


class MultiAgentBatch:
    """Per-policy SampleBatches from one joint rollout (analog of the
    reference's policy/sample_batch.py MultiAgentBatch): maps policy id →
    SampleBatch, with env_steps counting JOINT environment steps (each of
    which may contribute a row to several policies)."""

    def __init__(self, policy_batches, env_steps: int):
        self.policy_batches = dict(policy_batches)
        self.count = int(env_steps)

    def env_steps(self) -> int:
        return self.count

    def agent_steps(self) -> int:
        return sum(len(b) for b in self.policy_batches.values())

    def __len__(self) -> int:
        return self.count

    @staticmethod
    def concat_samples(batches) -> "MultiAgentBatch":
        merged = {}
        steps = 0
        for batch in batches:
            steps += batch.count
            for pid, sb in batch.policy_batches.items():
                merged.setdefault(pid, []).append(sb)
        return MultiAgentBatch(
            {pid: SampleBatch.concat_samples(parts)
             for pid, parts in merged.items()}, steps)
