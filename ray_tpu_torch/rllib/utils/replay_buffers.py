"""Replay buffers (reference: rllib/utils/replay_buffers/replay_buffer.py):
uniform ReplayBuffer + PrioritizedReplayBuffer over SampleBatch storage."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class ReplayBuffer:
    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._rows: List[dict] = []
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._rows)

    def add(self, batch: SampleBatch) -> None:
        for i in range(len(batch)):
            row = {k: v[i] for k, v in batch.items()}
            if len(self._rows) < self.capacity:
                self._rows.append(row)
            else:
                self._rows[self._next] = row
                self._next = (self._next + 1) % self.capacity

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, len(self._rows), num_items)
        keys = self._rows[0].keys()
        return SampleBatch(
            {k: np.stack([self._rows[i][k] for i in idx]) for k in keys})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (alpha) with IS weights (beta)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._priorities: List[float] = []
        self._max_priority = 1.0

    def add(self, batch: SampleBatch) -> None:
        for i in range(len(batch)):
            row = {k: v[i] for k, v in batch.items()}
            if len(self._rows) < self.capacity:
                self._rows.append(row)
                self._priorities.append(self._max_priority)
            else:
                self._rows[self._next] = row
                self._priorities[self._next] = self._max_priority
                self._next = (self._next + 1) % self.capacity

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        pri = np.asarray(self._priorities) ** self.alpha
        probs = pri / pri.sum()
        idx = self._rng.choice(len(self._rows), num_items, p=probs)
        weights = (len(self._rows) * probs[idx]) ** (-beta)
        weights = weights / weights.max()
        keys = self._rows[0].keys()
        out = SampleBatch(
            {k: np.stack([self._rows[i][k] for i in idx]) for k in keys})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx, priorities) -> None:
        for i, p in zip(idx, priorities):
            self._priorities[int(i)] = float(abs(p)) + 1e-6
            self._max_priority = max(self._max_priority, self._priorities[int(i)])


def n_step_transform(batch: "SampleBatch", n: int,
                     gamma: float) -> "SampleBatch":
    """Rewrite transitions as n-step returns (reference: rllib's
    adjust_nstep in replay-buffer utils): reward_t <- sum_i gamma^i
    r_{t+i}, new_obs_t <- obs after the window, terminated_t <- whether
    the window hit a terminal. Windows never cross episode boundaries
    (terminated/truncated/eps_id seams). Windows cut short at a
    non-terminal boundary cover k < n steps, so each row carries its own
    bootstrap discount gamma^k in "n_step_discount" — the learner uses it
    instead of a fixed gamma^n.
    """
    if n <= 1:
        return batch
    size = len(batch)
    rewards = np.asarray(batch[SampleBatch.REWARDS], np.float64)
    terminated = np.asarray(batch[SampleBatch.TERMINATEDS])
    truncated = batch.get(SampleBatch.TRUNCATEDS)
    eps_id = batch.get(SampleBatch.EPS_ID)
    new_obs = np.asarray(batch[SampleBatch.NEXT_OBS])

    def boundary(t):  # episode ends AFTER step t
        return bool(terminated[t]) or \
            (truncated is not None and bool(truncated[t])) or \
            (eps_id is not None and t + 1 < size
             and eps_id[t] != eps_id[t + 1])

    out_r = np.zeros(size, np.float32)
    out_disc = np.zeros(size, np.float32)
    out_new_obs = new_obs.copy()
    out_term = np.asarray(terminated, np.float32).copy()
    for t in range(size):
        acc, disc = 0.0, 1.0
        for i in range(n):
            j = t + i
            if j >= size:
                break
            acc += disc * rewards[j]
            disc *= gamma
            out_new_obs[t] = new_obs[j]
            out_term[t] = np.float32(terminated[j])
            if boundary(j):
                break
        out_r[t] = acc
        out_disc[t] = disc  # gamma^k for the k steps actually covered
    out = SampleBatch(dict(batch))
    out[SampleBatch.REWARDS] = out_r
    out[SampleBatch.NEXT_OBS] = out_new_obs
    out[SampleBatch.TERMINATEDS] = out_term
    out["n_step_discount"] = out_disc
    return out


class SequenceReplayBuffer:
    """Episode-organized replay for recurrent learners (reference:
    R2D2's sequence storage in rllib/algorithms/r2d2 + replay_buffers/
    utils): stores whole episodes, samples fixed-length windows with the
    recurrent state recorded at the window start, zero-padding short
    windows with a validity mask."""

    def __init__(self, capacity_episodes: int = 2000,
                 seed: Optional[int] = None):
        self.capacity = capacity_episodes
        self._episodes: List[dict] = []
        self._next = 0
        self._steps = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._steps

    def add(self, batch: SampleBatch) -> None:
        for ep in batch.split_by_episode():
            data = {k: np.asarray(v) for k, v in ep.items()}
            self._steps += len(ep)
            if len(self._episodes) < self.capacity:
                self._episodes.append(data)
            else:
                evicted = self._episodes[self._next]
                self._steps -= len(next(iter(evicted.values())))
                self._episodes[self._next] = data
                self._next = (self._next + 1) % self.capacity

    def sample(self, num_seqs: int, seq_len: int) -> dict:
        """-> dict of [num_seqs, seq_len, ...] arrays plus "mask"
        [num_seqs, seq_len] (1 = real step) and "h0"/"c0" from the
        stored per-step recurrent state at each window start."""
        assert self._episodes, "sample() on an empty buffer"
        keys = self._episodes[0].keys()
        out = {k: [] for k in keys}
        masks = []
        for _ in range(num_seqs):
            ep = self._episodes[self._rng.integers(len(self._episodes))]
            ep_len = len(next(iter(ep.values())))
            start = int(self._rng.integers(
                0, max(ep_len - seq_len, 0) + 1))
            end = min(start + seq_len, ep_len)
            pad = seq_len - (end - start)
            for k in keys:
                window = ep[k][start:end]
                if pad:
                    window = np.concatenate(
                        [window, np.zeros((pad,) + window.shape[1:],
                                          window.dtype)])
                out[k].append(window)
            masks.append(np.concatenate(
                [np.ones(end - start, np.float32),
                 np.zeros(pad, np.float32)]))
        stacked = {k: np.stack(v) for k, v in out.items()}
        stacked["mask"] = np.stack(masks)
        # Window-start recurrent state (stored pre-step by the policy;
        # absent for consumers with no per-step recurrent columns, e.g.
        # Dreamer's world-model sequences).
        if "lstm_h" in stacked:
            stacked["h0"] = stacked.pop("lstm_h")[:, 0]
        if "lstm_c" in stacked:
            stacked["c0"] = stacked.pop("lstm_c")[:, 0]
        return stacked
