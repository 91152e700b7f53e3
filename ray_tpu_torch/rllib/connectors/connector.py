"""Connectors: composable observation/action transform pipelines.

Analog of the reference's rllib/connectors/: small stateful transforms
applied between env and policy (obs side) and between policy and env
(action side), serialized with the policy so inference-time preprocessing
matches training-time exactly.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


class Connector:
    def __call__(self, x):
        raise NotImplementedError

    def apply_readonly(self, x):
        """Transform without mutating connector state (stateless connectors
        are their own read-only form). Used for NEXT_OBS, which must see the
        same normalization as OBS but must not double-count frames."""
        return self(x)

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class FlattenObs(Connector):
    """Flatten any observation to a rank-1 float32 vector."""

    def __call__(self, obs):
        return np.asarray(obs, np.float32).reshape(-1)


class MeanStdFilter(Connector):
    """Running mean/std observation normalization (the reference's
    MeanStdFilter, rllib/utils/filter.py): Welford accumulation, applied
    as (x - mean) / std."""

    def __init__(self, clip: float = 10.0):
        self.clip = clip
        self._n = 0
        self._mean = None
        self._m2 = None

    def __call__(self, obs):
        x = np.asarray(obs, np.float64).reshape(-1)
        if self._mean is None:
            self._mean = np.zeros_like(x)
            self._m2 = np.zeros_like(x)
        self._n += 1
        delta = x - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (x - self._mean)
        return self._normalize(x)

    def apply_readonly(self, obs):
        x = np.asarray(obs, np.float64).reshape(-1)
        if self._mean is None:
            return x.astype(np.float32)
        return self._normalize(x)

    def _normalize(self, x):
        std = np.sqrt(self._m2 / max(self._n - 1, 1)) + 1e-8
        out = (x - self._mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self):
        return {"n": self._n,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state):
        self._n = state["n"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class ClipActions(Connector):
    """Clip continuous actions into the Box bounds before env.step."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, action):
        return np.clip(action, self.low, self.high)


class ObsConnectorPipeline(Connector):
    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, obs):
        for c in self.connectors:
            obs = c(obs)
        return obs

    def apply_readonly(self, obs):
        for c in self.connectors:
            obs = c.apply_readonly(obs)
        return obs

    def get_state(self):
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class ActionConnectorPipeline(ObsConnectorPipeline):
    pass


def get_connectors(policy_config: Dict[str, Any], obs_space, action_space
                   ) -> (ObsConnectorPipeline, ActionConnectorPipeline):
    """Build pipelines from the ``observation_filter`` / ``clip_actions``
    entries of a policy config."""
    from ray_tpu_torch.rllib.models.catalog import ModelCatalog
    obs_connectors: List[Connector] = []
    if not ModelCatalog.is_image_space(obs_space):
        obs_connectors.append(FlattenObs())
        if policy_config.get("observation_filter") == "MeanStdFilter":
            obs_connectors.append(MeanStdFilter())
    action_connectors: List[Connector] = []
    if policy_config.get("clip_actions", True) and hasattr(
            action_space, "low") and hasattr(action_space, "high"):
        action_connectors.append(
            ClipActions(action_space.low, action_space.high))
    return (ObsConnectorPipeline(obs_connectors),
            ActionConnectorPipeline(action_connectors))
