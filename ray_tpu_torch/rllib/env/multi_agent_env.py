"""MultiAgentEnv: the multi-agent environment contract.

Analog of the reference's rllib/env/multi_agent_env.py: one env hosting
several agents; every API surface is keyed by agent id. reset() returns
(obs_dict, info_dict); step(action_dict) returns per-agent obs/reward/
terminated/truncated/info dicts, with the special "__all__" key in
terminateds/truncateds ending the episode for everyone. Agents may come
and go between steps (only agents present in the obs dict act next step).
"""

from __future__ import annotations

from typing import Any, Dict, Set, Tuple


class MultiAgentEnv:
    #: ids of all agents that can ever appear (subclasses set this).
    agent_ids: Set[str] = set()

    def reset(self, *, seed=None, options=None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        """→ (obs, rewards, terminateds, truncateds, infos), all keyed by
        agent id; terminateds/truncateds also carry "__all__"."""
        raise NotImplementedError

    def observation_space_for(self, agent_id: str):
        """Per-agent observation space (override for heterogeneous
        agents; defaults to a shared ``observation_space`` attribute)."""
        return self.observation_space

    def action_space_for(self, agent_id: str):
        return self.action_space

    def close(self) -> None:
        pass
