"""RecSim-style slate recommendation environment.

Analog of the RecSim "interest evolution" environment the reference's
SlateQ is written against (reference: rllib/algorithms/slateq/slateq.py
targets google-research/recsim; rllib/env/wrappers/recsim.py adapts it).
A user with a latent interest vector is shown a slate of ``slate_size``
documents out of ``num_candidates`` per step; a conditional-logit choice
model (with a no-click option) picks at most one document; clicking
yields engagement reward and nudges the user's interest toward the
clicked document's topic. The myopic greedy policy (recommend the
highest-immediate-engagement docs) is suboptimal when quality and
clickbaitiness are anti-correlated — the long-term-value signal SlateQ
exists to capture.

Observation: a flat ``Box`` concatenating the user interest vector and
the per-candidate feature rows ``[topic (T), quality (1)]``, i.e.
``T + C * (T + 1)`` floats. Action: ``MultiDiscrete([C] * slate_size)``
— a slate of candidate indices (the shape the reference's RecSim
wrapper exposes, rllib/env/wrappers/recsim.py
MultiDiscreteToDiscreteActionWrapper's input). Duplicate indices are
legal (the conditional logit runs over the slate as presented — a
repeated document simply occupies two positions), so generic consumers
like the RandomAgent baseline can ``action_space.sample()`` safely;
SlateQ itself always emits distinct slates.
"""

from __future__ import annotations

from typing import Optional

import gymnasium as gym
import numpy as np


class RecSimEnv(gym.Env):
    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.num_candidates = int(config.get("num_candidates", 10))
        self.slate_size = int(config.get("slate_size", 3))
        self.num_topics = int(config.get("num_topics", 5))
        self.horizon = int(config.get("horizon", 50))
        #: choice-model temperature: higher = clickier users.
        self.choice_beta = float(config.get("choice_beta", 5.0))
        self.no_click_score = float(config.get("no_click_score", 1.0))
        #: interest drift rate toward clicked topics.
        self.interest_lr = float(config.get("interest_lr", 0.3))
        #: anti-correlation between immediate appeal and quality — the
        #: "clickbait" knob that makes myopic ranking suboptimal.
        self.clickbait = float(config.get("clickbait", 0.8))
        T, C = self.num_topics, self.num_candidates
        self.observation_space = gym.spaces.Box(
            -np.inf, np.inf, (T + C * (T + 1),), np.float32)
        self.action_space = gym.spaces.MultiDiscrete(
            [C] * self.slate_size)
        self._rng = np.random.default_rng(config.get("seed"))
        self._user = None
        self._docs = None
        self._t = 0

    # -- internals -------------------------------------------------------

    def _sample_docs(self) -> np.ndarray:
        """[C, T+1] rows of topic-simplex + quality. Quality is
        anti-correlated with peak topic appeal by ``clickbait``."""
        C, T = self.num_candidates, self.num_topics
        topics = self._rng.dirichlet(np.full(T, 0.3), size=C)
        appeal = topics.max(-1)
        noise = self._rng.random(C)
        quality = (1 - self.clickbait) * noise + \
            self.clickbait * (1.0 - appeal)
        return np.concatenate(
            [topics, quality[:, None]], axis=-1).astype(np.float32)

    def _obs(self) -> np.ndarray:
        return np.concatenate(
            [self._user, self._docs.reshape(-1)]).astype(np.float32)

    def choice_probs(self, slate: np.ndarray) -> np.ndarray:
        """True conditional-logit click distribution over the slate's
        items plus the trailing no-click option — exposed so tests can
        assert against the ground truth the agent must learn."""
        topics = self._docs[slate, :-1]
        scores = self.choice_beta * (topics @ self._user)
        logits = np.concatenate([scores, [self.no_click_score]])
        e = np.exp(logits - logits.max())
        return e / e.sum()

    # -- gym API ---------------------------------------------------------

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        T = self.num_topics
        u = self._rng.dirichlet(np.full(T, 0.5))
        self._user = u.astype(np.float32)
        self._docs = self._sample_docs()
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        slate = np.asarray(action, np.int64).reshape(-1)
        if slate.size != self.slate_size or slate.min() < 0 or \
                slate.max() >= self.num_candidates:
            raise ValueError(
                f"slate must be {self.slate_size} doc indices in "
                f"[0, {self.num_candidates}), got {slate!r}")
        probs = self.choice_probs(slate)
        pick = self._rng.choice(self.slate_size + 1, p=probs)
        reward = 0.0
        if pick < self.slate_size:  # a real click, not the null option
            doc = self._docs[slate[pick]]
            topic, quality = doc[:-1], float(doc[-1])
            reward = quality
            u = self._user + self.interest_lr * \
                (topic - self._user) * quality
            self._user = (u / max(u.sum(), 1e-6)).astype(np.float32)
        self._docs = self._sample_docs()
        self._t += 1
        done = self._t >= self.horizon
        return self._obs(), float(reward), done, False, \
            {"clicked": int(pick) if pick < self.slate_size else -1}

    def split_obs(self, obs: np.ndarray):
        """(user [T], docs [C, T+1]) view of a flat observation."""
        T, C = self.num_topics, self.num_candidates
        return obs[:T], obs[T:].reshape(C, T + 1)
