"""RolloutWorker: environment-sampling actor.

The port of ``ray_tpu/rllib/evaluation/rollout_worker.py`` (the
reference's rllib/evaluation/rollout_worker.py:165, sample :878): owns
env instances + a policy copy, steps them for
rollout_fragment_length, postprocesses (GAE for actor-critic policies; raw
transitions for off-policy ones), returns a SampleBatch. Created as actors
by WorkerSet; weights sync via set_weights before every sampling round.
Observations/actions pass through connector pipelines
(rllib/connectors/connector.py), and sampled batches can be mirrored to
offline JSON output (rllib/offline/json_writer.py).

Samplers run on the host and the learner on the card, as in the JAX
package (its ppo.py: rollouts on the CPU, the learner on the
accelerator): the worker's policy lives on
``rollout_backend`` ("cpu" by default; None is the process default, the
CUDA card), where the JAX worker pins its process's JAX platform. Its
PRNG key is a ``torch.Generator`` on that device (the JAX worker's key,
split per step), one draw per step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.connectors import get_connectors
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.torch_policy import compute_gae
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def _make_env(env_creator, env_config):
    env = env_creator(env_config or {})
    from ray_tpu_torch.rllib.env.external_env import ExternalEnv, GymAdapter
    if isinstance(env, ExternalEnv):
        # Self-driving env (reference: external_env.py ExternalEnvWrapper):
        # invert its queue protocol back into reset()/step() so the
        # standard samplers (and their batched inference) drive it.
        return GymAdapter(env)
    return env


def rollout_device(policy_config: Dict[str, Any]):
    """The device of a sampler's policy: ``rollout_backend``, the CPU
    unless the config says otherwise (None: the CUDA card)."""
    return policy_config.get("rollout_backend", "cpu")


class RolloutWorker:
    def __init__(self, env_creator: Callable, policy_config: Dict[str, Any],
                 worker_index: int = 0, seed: int = 0):
        self.env = _make_env(env_creator, policy_config.get("env_config"))
        obs_space = self.env.observation_space
        self.policy = make_policy(policy_config, obs_space,
                                  self.env.action_space,
                                  seed=seed + worker_index,
                                  device=rollout_device(policy_config))
        self.obs_connectors, self.action_connectors = get_connectors(
            policy_config, obs_space, self.env.action_space)
        if policy_config.get("per_worker_epsilon") and \
                hasattr(self.policy, "epsilon"):
            # APEX exploration ladder (Horgan et al. 2018): worker i of N
            # keeps a FIXED epsilon = 0.4^(1 + 7*i/(N-1)) — a spread of
            # exploration rates instead of one central schedule.
            n = max(int(policy_config.get("num_workers", 1)), 1)
            alpha = 7.0
            frac = (worker_index - 1) / max(n - 1, 1)
            self.policy.epsilon = 0.4 ** (1.0 + alpha * frac)
            self.policy.fixed_epsilon = True
        self.gamma = policy_config.get("gamma", 0.99)
        self.lam = policy_config.get("lambda", 0.95)
        self.worker_index = worker_index
        self._key = self.policy.make_generator(1000 + seed + worker_index)
        self._obs, _ = self.env.reset(seed=seed + worker_index)
        self._eps_id = worker_index * 1_000_000
        # Vectorized sampling (reference: num_envs_per_worker) batches
        # policy inference over N sibling envs — one forward pass per
        # step for ALL envs, the sampler-throughput lever. Recurrent
        # policies (per-episode hidden state rows) stay on the serial
        # path.
        self.num_envs = max(int(policy_config.get(
            "num_envs_per_worker", 1) or 1), 1)
        # hasattr, not truthiness: recurrent policies expose state_rows
        # from construction but only fill it after the first step.
        if self.num_envs > 1 and not hasattr(self.policy, "state_rows"):
            from ray_tpu_torch.rllib.connectors import get_connectors as _gc
            self._vec_envs = [self.env]
            self._vec_obs_conn = [self.obs_connectors]
            for i in range(1, self.num_envs):
                env_i = _make_env(env_creator,
                                  policy_config.get("env_config"))
                obs_conn_i, _ = _gc(policy_config, obs_space,
                                    env_i.action_space)
                self._vec_envs.append(env_i)
                self._vec_obs_conn.append(obs_conn_i)
            self._vec_obs = [self._obs] + [
                e.reset(seed=seed + worker_index + 7919 * i)[0]
                for i, e in enumerate(self._vec_envs) if i > 0]
            self._vec_eps = [self._eps_id + i
                             for i in range(self.num_envs)]
            self._eps_id += self.num_envs
            self._vec_ep_reward = [0.0] * self.num_envs
            self._vec_ep_len = [0] * self.num_envs
        else:
            self.num_envs = 1
        self._episode_reward = 0.0
        self._episode_len = 0
        self.completed_rewards: list = []
        self.completed_lengths: list = []
        self._writer = None
        output_dir = policy_config.get("output")
        if output_dir:
            from ray_tpu_torch.rllib.offline.json_writer import JsonWriter
            self._writer = JsonWriter(output_dir, worker_index=worker_index)

    def set_weights(self, weights) -> bool:
        self.policy.set_weights(weights)
        return True

    def apply(self, fn, *args, **kwargs):
        """Run ``fn(self, ...)`` on the worker (reference:
        RolloutWorker.apply) — the seam algorithm-owned worker-side
        logic ships through (DDPPO's decentralized learner lives in a
        function applied here)."""
        return fn(self, *args, **kwargs)

    def init_collective_group(self, world_size: int, rank: int,
                              backend: str = "tpu",
                              group_name: str = "default"):
        """Join a collective group (util/collective) from this worker —
        what create_collective_group invokes (DDPPO's gradient
        allreduce ring spans the rollout workers)."""
        from ray_tpu_torch.util import collective
        collective.init_collective_group(world_size, rank, backend,
                                         group_name)
        return rank

    def get_weights(self):
        return self.policy.get_weights()

    def sample(self, num_steps: int) -> SampleBatch:
        if self.num_envs > 1:
            return self._sample_vectorized(num_steps)
        rows = {k: [] for k in (
            SampleBatch.OBS, SampleBatch.NEXT_OBS, SampleBatch.ACTIONS,
            SampleBatch.REWARDS, SampleBatch.TERMINATEDS,
            SampleBatch.TRUNCATEDS, SampleBatch.ACTION_LOGP,
            SampleBatch.VF_PREDS, SampleBatch.EPS_ID)}
        for _ in range(num_steps):
            obs = np.asarray(self.obs_connectors(self._obs))
            action, logp, value = self.policy.compute_actions(obs[None],
                                                              self._key)
            # Recurrent policies publish their PRE-step hidden state per
            # transition (R2D2: the learner re-seeds the recurrence from
            # any stored window start).
            for k, v in getattr(self.policy, "state_rows", {}).items():
                rows.setdefault(k, []).append(v)
            act = action[0]
            act_env = int(act) if self.policy.discrete else np.asarray(act)
            if self.action_connectors.connectors:
                act_env = self.action_connectors(act_env)
            nxt, reward, terminated, truncated, _ = self.env.step(act_env)
            # NEXT_OBS passes the pipeline read-only: it must see the same
            # normalization as OBS, but stateful filters only consume each
            # frame once (at its OBS position next iteration).
            rows[SampleBatch.OBS].append(obs)
            rows[SampleBatch.NEXT_OBS].append(
                np.asarray(self.obs_connectors.apply_readonly(nxt)))
            rows[SampleBatch.ACTIONS].append(act)
            rows[SampleBatch.REWARDS].append(np.float32(reward))
            rows[SampleBatch.TERMINATEDS].append(np.float32(terminated))
            rows[SampleBatch.TRUNCATEDS].append(np.float32(truncated))
            rows[SampleBatch.ACTION_LOGP].append(logp[0])
            rows[SampleBatch.VF_PREDS].append(value[0])
            rows[SampleBatch.EPS_ID].append(self._eps_id)
            self._episode_reward += float(reward)
            self._episode_len += 1
            if terminated or truncated:
                self.completed_rewards.append(self._episode_reward)
                self.completed_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                self._eps_id += 1
                self._obs, _ = self.env.reset()
                reset_state = getattr(self.policy, "reset_state", None)
                if callable(reset_state):
                    reset_state()  # recurrent state dies with the episode
            else:
                self._obs = nxt
        batch = self._postprocess(SampleBatch(rows))
        if self._writer is not None:
            self._writer.write(batch)
        return batch

    def _sample_vectorized(self, num_steps: int) -> SampleBatch:
        """Round-robin N envs with BATCHED policy inference; emits
        ceil(num_steps / N) steps per env. Each env keeps its own
        stateful obs-connector pipeline, episode ids, and GAE bootstrap
        (postprocessed per env so value targets never cross envs)."""
        steps_per_env = max((num_steps + self.num_envs - 1) //
                            self.num_envs, 1)
        N = self.num_envs
        per_env_rows = [
            {k: [] for k in (
                SampleBatch.OBS, SampleBatch.NEXT_OBS,
                SampleBatch.ACTIONS, SampleBatch.REWARDS,
                SampleBatch.TERMINATEDS, SampleBatch.TRUNCATEDS,
                SampleBatch.ACTION_LOGP, SampleBatch.VF_PREDS,
                SampleBatch.EPS_ID)}
            for _ in range(N)]
        for _ in range(steps_per_env):
            obs_batch = np.stack([
                np.asarray(self._vec_obs_conn[i](self._vec_obs[i]))
                for i in range(N)])
            actions, logps, values = self.policy.compute_actions(
                obs_batch, self._key)
            for i in range(N):
                act = actions[i]
                act_env = (int(act) if self.policy.discrete
                           else np.asarray(act))
                if self.action_connectors.connectors:
                    act_env = self.action_connectors(act_env)
                nxt, reward, terminated, truncated, _ = \
                    self._vec_envs[i].step(act_env)
                rows = per_env_rows[i]
                rows[SampleBatch.OBS].append(obs_batch[i])
                rows[SampleBatch.NEXT_OBS].append(np.asarray(
                    self._vec_obs_conn[i].apply_readonly(nxt)))
                rows[SampleBatch.ACTIONS].append(act)
                rows[SampleBatch.REWARDS].append(np.float32(reward))
                rows[SampleBatch.TERMINATEDS].append(
                    np.float32(terminated))
                rows[SampleBatch.TRUNCATEDS].append(
                    np.float32(truncated))
                rows[SampleBatch.ACTION_LOGP].append(logps[i])
                rows[SampleBatch.VF_PREDS].append(values[i])
                rows[SampleBatch.EPS_ID].append(self._vec_eps[i])
                self._vec_ep_reward[i] += float(reward)
                self._vec_ep_len[i] += 1
                if terminated or truncated:
                    self.completed_rewards.append(
                        self._vec_ep_reward[i])
                    self.completed_lengths.append(self._vec_ep_len[i])
                    self._vec_ep_reward[i] = 0.0
                    self._vec_ep_len[i] = 0
                    self._vec_eps[i] = self._eps_id
                    self._eps_id += 1
                    self._vec_obs[i], _ = self._vec_envs[i].reset()
                else:
                    self._vec_obs[i] = nxt
        batches = []
        for i in range(N):
            batch = SampleBatch(per_env_rows[i])
            batches.append(self._postprocess(
                batch, bootstrap_obs_raw=self._vec_obs[i],
                obs_conn=self._vec_obs_conn[i]))
        out = SampleBatch.concat_samples(batches)
        if self._writer is not None:
            self._writer.write(out)
        return out

    def _postprocess(self, batch: SampleBatch,
                     bootstrap_obs_raw=None,
                     obs_conn=None) -> SampleBatch:
        if not getattr(self.policy, "needs_gae", True):
            return batch
        if bootstrap_obs_raw is None:
            bootstrap_obs_raw = self._obs
        if obs_conn is None:
            obs_conn = self.obs_connectors
        # GAE per episode fragment; bootstrap truncated/continuing tails.
        fragments = []
        for frag in batch.split_by_episode():
            last_terminated = frag[SampleBatch.TERMINATEDS][-1] > 0
            if last_terminated:
                last_value = 0.0
            else:
                bootstrap_obs = np.asarray(
                    obs_conn.apply_readonly(bootstrap_obs_raw))
                last_value = float(self.policy.compute_values(
                    bootstrap_obs[None])[0])
            fragments.append(compute_gae(frag, self.gamma, self.lam,
                                         last_value))
        return SampleBatch.concat_samples(fragments)

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
