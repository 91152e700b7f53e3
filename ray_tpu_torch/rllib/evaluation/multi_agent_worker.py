"""MultiAgentRolloutWorker: joint-episode sampling over a MultiAgentEnv.

The port of ``ray_tpu/rllib/evaluation/multi_agent_worker.py``, its
policies on ``rollout_backend`` as a ``RolloutWorker``'s. Analog of the
reference's multi-agent sampling path (rollout_worker.py +
sampler.py with a policy map): one env hosting several agents, each
mapped to a policy by ``policy_mapping_fn``; every joint step routes each
present agent's observation through its policy, and completed per-agent
trajectories are GAE-postprocessed against that policy's value head and
appended to the policy's batch. sample() returns a MultiAgentBatch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.torch_policy import compute_gae
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch

_ROW_KEYS = (SampleBatch.OBS, SampleBatch.NEXT_OBS, SampleBatch.ACTIONS,
             SampleBatch.REWARDS, SampleBatch.TERMINATEDS,
             SampleBatch.TRUNCATEDS, SampleBatch.ACTION_LOGP,
             SampleBatch.VF_PREDS, SampleBatch.EPS_ID)


def resolve_policy_specs(policies: Dict[str, Any],
                         policy_mapping_fn: Callable[[str], str],
                         env) -> Dict[str, tuple]:
    """Fill in None policy specs from the env's per-agent spaces (the
    first mapped agent defines the spaces, as in the reference)."""
    resolved = {}
    for agent_id in sorted(env.agent_ids):
        pid = policy_mapping_fn(agent_id)
        if pid not in policies:
            raise ValueError(
                f"policy_mapping_fn({agent_id!r}) -> {pid!r}, which is not "
                f"in config.policies {sorted(policies)}")
        if pid not in resolved:
            spec = policies[pid]
            if spec is None:
                spec = (env.observation_space_for(agent_id),
                        env.action_space_for(agent_id))
            resolved[pid] = tuple(spec)
    missing = set(policies) - set(resolved)
    if missing:
        raise ValueError(
            f"Policies {sorted(missing)} are not reachable from any agent "
            "via policy_mapping_fn")
    return resolved


class MultiAgentRolloutWorker:
    def __init__(self, env_creator: Callable, policy_config: Dict[str, Any],
                 worker_index: int = 0, seed: int = 0):
        from ray_tpu_torch.rllib.evaluation.rollout_worker import \
            rollout_device
        self.env = env_creator(policy_config.get("env_config") or {})
        policies = policy_config["policies"]
        self.policy_mapping_fn = policy_config["policy_mapping_fn"]
        specs = resolve_policy_specs(policies, self.policy_mapping_fn,
                                     self.env)
        from ray_tpu_torch.rllib.connectors import get_connectors
        self.policies = {}
        self.obs_connectors = {}
        self.action_connectors = {}
        self._writers = {}
        output_dir = policy_config.get("output")
        for i, (pid, (obs_space, act_space)) in enumerate(
                sorted(specs.items())):
            # 1000× spacing decorrelates (worker, policy) pairs — plain
            # seed + worker_index + i would give (w=1, i=1) and (w=2, i=0)
            # identical PRNG streams (mirrors the _eps_id spacing below).
            self.policies[pid] = make_policy(
                policy_config, obs_space, act_space,
                seed=seed + 1000 * worker_index + i,
                device=rollout_device(policy_config))
            # Per-policy connector pipelines (stateful filters like
            # MeanStd must track each policy's own observation stream).
            self.obs_connectors[pid], self.action_connectors[pid] = \
                get_connectors(policy_config, obs_space, act_space)
            if output_dir:
                import os

                from ray_tpu_torch.rllib.offline.json_writer import JsonWriter
                self._writers[pid] = JsonWriter(
                    os.path.join(output_dir, pid),
                    worker_index=worker_index)
        self.gamma = policy_config.get("gamma", 0.99)
        self.lam = policy_config.get("lambda", 0.95)
        self.worker_index = worker_index
        # One generator for every policy (all on rollout_device).
        self._key = next(iter(self.policies.values())).make_generator(
            2000 + seed + worker_index)
        self._eps_id = worker_index * 1_000_000
        self._obs, _ = self.env.reset(seed=seed + worker_index)
        # In-progress per-agent trajectories for the current episode.
        self._trajectories: Dict[str, Dict[str, list]] = {}
        self._episode_reward = 0.0
        self._episode_len = 0
        self.completed_rewards: list = []
        self.completed_lengths: list = []

    # -- weights ---------------------------------------------------------

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)
        return True

    def get_weights(self) -> Dict[str, Any]:
        return {pid: p.get_weights() for pid, p in self.policies.items()}

    # -- sampling --------------------------------------------------------

    def _traj(self, agent_id: str) -> Dict[str, list]:
        traj = self._trajectories.get(agent_id)
        if traj is None:
            traj = self._trajectories[agent_id] = {k: [] for k in _ROW_KEYS}
        return traj

    def _flush_agent(self, agent_id: str, builders: Dict[str, list],
                     terminated: bool) -> None:
        """Close an agent trajectory: GAE against the agent's policy
        (bootstrapping non-terminal tails) and hand it to the policy's
        batch builder."""
        traj = self._trajectories.pop(agent_id, None)
        if not traj or not traj[SampleBatch.OBS]:
            return
        pid = self.policy_mapping_fn(agent_id)
        policy = self.policies[pid]
        batch = SampleBatch({k: np.asarray(v) for k, v in traj.items()})
        last_value = 0.0
        if not terminated:
            last_obs = batch[SampleBatch.NEXT_OBS][-1]
            last_value = float(policy.compute_values(
                np.asarray(last_obs, np.float32)[None])[0])
        batch = compute_gae(batch, self.gamma, self.lam, last_value)
        builders.setdefault(pid, []).append(batch)

    def sample(self, num_steps: int) -> MultiAgentBatch:
        builders: Dict[str, list] = {}
        for _ in range(num_steps):
            actions: Dict[str, Any] = {}
            step_meta: Dict[str, tuple] = {}
            for agent_id, obs in self._obs.items():
                pid = self.policy_mapping_fn(agent_id)
                policy = self.policies[pid]
                obs_arr = np.asarray(self.obs_connectors[pid](obs),
                                     np.float32)
                action, logp, value = policy.compute_actions(
                    obs_arr[None], self._key)
                act = action[0]
                act_env = (int(act) if policy.discrete
                           else np.asarray(act))
                if self.action_connectors[pid].connectors:
                    act_env = self.action_connectors[pid](act_env)
                actions[agent_id] = act_env
                step_meta[agent_id] = (obs_arr, act, logp[0], value[0])
            nxt, rewards, terminateds, truncateds, _ = self.env.step(
                actions)
            term_all = bool(terminateds.get("__all__", False))
            done_all = bool(term_all or truncateds.get("__all__", False))
            for agent_id, (obs_arr, act, logp, value) in step_meta.items():
                traj = self._traj(agent_id)
                term = bool(terminateds.get(agent_id, False))
                trunc = bool(truncateds.get(agent_id, False))
                reward = float(rewards.get(agent_id, 0.0))
                pid = self.policy_mapping_fn(agent_id)
                traj[SampleBatch.OBS].append(obs_arr)
                next_raw = nxt.get(agent_id, obs_arr)
                traj[SampleBatch.NEXT_OBS].append(np.asarray(
                    self.obs_connectors[pid].apply_readonly(next_raw),
                    np.float32))
                traj[SampleBatch.ACTIONS].append(act)
                traj[SampleBatch.REWARDS].append(np.float32(reward))
                traj[SampleBatch.TERMINATEDS].append(np.float32(term))
                traj[SampleBatch.TRUNCATEDS].append(np.float32(trunc))
                traj[SampleBatch.ACTION_LOGP].append(logp)
                traj[SampleBatch.VF_PREDS].append(value)
                traj[SampleBatch.EPS_ID].append(self._eps_id)
                self._episode_reward += reward
                if term or trunc or done_all:
                    # terminateds['__all__'] without a per-agent flag is a
                    # genuine terminal for every agent (the MultiAgentEnv
                    # contract: '__all__' ends the episode for everyone) —
                    # bootstrapping gamma*V(last_obs) there would bias GAE
                    # targets. Truncation ('__all__' in truncateds, or a
                    # per-agent trunc) still bootstraps.
                    self._flush_agent(
                        agent_id, builders,
                        terminated=term or (term_all and not trunc))
            self._episode_len += 1
            if done_all:
                for agent_id in list(self._trajectories):
                    self._flush_agent(agent_id, builders,
                                      terminated=term_all)
                self.completed_rewards.append(self._episode_reward)
                self.completed_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                self._eps_id += 1
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        # Fragment boundary: flush alive agents with bootstrapped tails so
        # the learner sees complete GAE fields every round.
        for agent_id in list(self._trajectories):
            self._flush_agent(agent_id, builders, terminated=False)
        policy_batches = {pid: SampleBatch.concat_samples(parts)
                          for pid, parts in builders.items()}
        for pid, writer in self._writers.items():
            if pid in policy_batches:
                writer.write(policy_batches[pid])
        return MultiAgentBatch(policy_batches, env_steps=num_steps)

    def episode_stats(self, window: int = 100) -> Dict[str, float]:
        rewards = self.completed_rewards[-window:]
        lengths = self.completed_lengths[-window:]
        return {
            "episodes": len(self.completed_rewards),
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else float("nan"),
            "episode_len_mean": float(np.mean(lengths)) if lengths
            else float("nan"),
        }
