"""Algorithm: the RLlib driver loop.

The port of ``ray_tpu/rllib/algorithms/algorithm.py``: its policies (the
learner's copies) live on ``config.device``, the CUDA card unless the
config asks for the CPU (``.resources(device="cpu")``); its rollout
workers sample on the CPU. ``get_weights`` and ``save`` write the JAX
package's numpy tree, so an ``algorithm_state.pkl`` of either package
restores in the other. The greedy action is a recurrent policy's own
(``compute_greedy``, which advances its state), the argmax of a
value-based policy's Q values, a SAC or TD3 actor's mean, and otherwise
the actor-critic's logits' argmax or mean.

Analog of the reference's rllib/algorithms/algorithm.py:150 (step :744,
training_step :1322): owns a WorkerSet and a learner policy; each train()
call broadcasts weights, samples, runs the algorithm's update, and returns
a result dict. Tune-compatible: implements the Trainable protocol surface
(train/save/restore/stop) so Tuner can tune algorithms.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.evaluation.worker_set import WorkerSet
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor


class Algorithm:
    _default_config_class = AlgorithmConfig
    # Algorithms that run their own rollout/evaluation actors (ES/ARS)
    # instead of the standard WorkerSet set this to keep it empty.
    _own_rollout_actors = False
    # Algorithms whose learner handles a policy map (PPO today); others
    # reject config.multi_agent() up front instead of crashing in setup.
    _supports_multi_agent = False
    # Algorithms that learn parameters of their own (``self.params``: QMix,
    # MADDPG, SlateQ) rather than the policy's; learner_state reads them.
    _owns_params = False

    def __init__(self, config: Optional[AlgorithmConfig] = None, env=None,
                 **kwargs):
        if config is None:
            config = self.get_default_config()
        if env is not None:
            config.env = env
        self.config = config
        self.iteration = 0
        self._timesteps_total = 0
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        env_creator = config.env_creator()
        self._env_creator = env_creator
        probe_env = env_creator({})
        from ray_tpu_torch.rllib.policy import make_policy
        self.is_multi_agent = getattr(config, "is_multi_agent", False)
        if self.is_multi_agent:
            if not self._supports_multi_agent:
                raise ValueError(
                    f"{type(self).__name__} does not support "
                    "config.multi_agent() yet; multi-agent training is "
                    "available on PPO.")
            if config.policy_mapping_fn is None:
                raise ValueError(
                    "Multi-agent configs need a policy_mapping_fn: "
                    "config.multi_agent(policies=..., "
                    "policy_mapping_fn=lambda agent_id: ...)")
            from ray_tpu_torch.rllib.evaluation.multi_agent_worker import (
                resolve_policy_specs)
            specs = resolve_policy_specs(
                config.policies, config.policy_mapping_fn, probe_env)
            self.local_policies = {
                pid: make_policy(config.policy_config(), obs_space,
                                 act_space, seed=config.seed + i,
                                 device=config.device)
                for i, (pid, (obs_space, act_space)) in enumerate(
                    sorted(specs.items()))}
            self.local_policy = None
        else:
            self.local_policy = make_policy(
                config.policy_config(), probe_env.observation_space,
                probe_env.action_space, seed=config.seed,
                device=config.device)
        probe_env.close() if hasattr(probe_env, "close") else None
        # Callable input_ = EXTERNAL experience source (reference:
        # policy_server_input usage — config.offline_data(input_=lambda
        # ctx: PolicyServerInput(ctx, host, port))): the algorithm trains
        # from it instead of its own rollout workers; ctx hands the
        # source the live training policy for server-side inference.
        self.external_input = None
        input_cfg = getattr(config, "input_", None)
        if callable(input_cfg):
            class InputContext:
                policy = self.local_policy
                gamma = getattr(config, "gamma", 0.99)
                lam = getattr(config, "lambda_", 0.95)

            self.external_input = input_cfg(InputContext())
        self.workers = WorkerSet(
            env_creator, config.policy_config(),
            # Zero sampling actors only for offline/external algorithms
            # (input_ set); online algorithms keep the >=1 fallback —
            # their training_step divides by worker count.
            num_workers=(0 if (self._own_rollout_actors
                               or self.external_input is not None
                               or (config.num_rollout_workers == 0
                                   and getattr(config, "input_", None)))
                         else max(config.num_rollout_workers, 1)),
            seed=config.seed,
            num_cpus_per_worker=config.num_cpus_per_worker)
        self.setup(config)

    def _sample_batch(self, per_worker: int):
        """Training data for one step: the external input (client-server
        RL) when configured, this algorithm's rollout workers otherwise."""
        if self.external_input is not None:
            return self.external_input.next_batch(
                self.config.train_batch_size)
        return self.workers.sample(per_worker)

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return cls._default_config_class(algo_class=cls)

    def setup(self, config: AlgorithmConfig) -> None:
        """Algorithm-specific initialization (optimizers etc.)."""

    # -- Trainable protocol ---------------------------------------------

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        self.iteration += 1
        results = self.training_step()
        stats = (self.external_input.episode_stats()
                 if self.external_input is not None
                 else self.workers.episode_stats())
        for k, v in stats.items():
            # training_step wins if it already reported the metric (e.g.
            # ES/ARS compute episode stats from their own evaluators).
            results.setdefault(k, v)
        results.update({
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "time_this_iter_s": time.monotonic() - t0,
        })
        interval = getattr(self.config, "evaluation_interval", 0)
        if interval and self.iteration % interval == 0:
            results["evaluation"] = self.evaluate()
        return results

    def evaluate(self) -> Dict[str, Any]:
        """Greedy evaluation episodes on a fresh local env (analog of the
        reference's Algorithm.evaluate with an evaluation WorkerSet;
        single-env here since the local policy is the learner copy)."""
        if self.is_multi_agent:
            # Joint greedy eval needs per-agent routing; the rollout
            # workers' episode stats already track joint returns.
            return self.workers.episode_stats()
        duration = getattr(self.config, "evaluation_duration", 3)
        env = self._env_creator(self.config.env_config)
        from ray_tpu_torch.rllib.connectors import get_connectors
        obs_conn, act_conn = get_connectors(
            self.config.policy_config(), env.observation_space,
            env.action_space)
        rewards, lengths = [], []
        for ep in range(duration):
            obs, _ = env.reset(seed=10_000 + ep)
            total, steps, done = 0.0, 0, False
            while not done and steps < 10_000:
                action = self.compute_single_action(obs_conn(obs))
                if act_conn.connectors:
                    action = act_conn(action)
                obs, reward, terminated, truncated, _ = env.step(action)
                total += float(reward)
                steps += 1
                done = terminated or truncated
            rewards.append(total)
            lengths.append(steps)
        if hasattr(env, "close"):
            env.close()
        return {
            "episode_reward_mean": float(np.mean(rewards)),
            "episode_len_mean": float(np.mean(lengths)),
            "episodes_this_eval": duration,
        }

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_weights(self):
        if self.is_multi_agent:
            return {pid: p.get_weights()
                    for pid, p in self.local_policies.items()}
        return self.local_policy.get_weights()

    def set_weights(self, weights) -> None:
        if self.is_multi_agent:
            for pid, w in weights.items():
                self.local_policies[pid].set_weights(w)
            return
        self.local_policy.set_weights(weights)

    def compute_single_action(self, obs, explore: bool = False,
                              policy_id: Optional[str] = None):
        if self.is_multi_agent:
            if policy_id is None:
                raise ValueError(
                    "Multi-agent algorithms need "
                    "compute_single_action(obs, policy_id=...)")
            policy = self.local_policies[policy_id]
        else:
            policy = self.local_policy
        obs = np.asarray(obs, np.float32)[None]
        if explore:
            gen = policy.make_generator(int(time.monotonic_ns()) % (2**31))
            a, _, _ = policy.compute_actions(obs, gen)
            return a[0] if policy.discrete is False else int(a[0])
        if hasattr(policy, "compute_greedy"):
            return policy.compute_greedy(obs)
        x = as_tensor(obs, policy.device)
        if hasattr(policy, "q_values"):  # value-based: greedy = argmax Q
            with torch.no_grad():
                q = policy.q_values(policy.params, x)
            return int(q.argmax(-1)[0])
        if hasattr(policy, "dist_params"):  # SAC: mean action
            with torch.no_grad():
                mu, _ = policy.dist_params(policy.params, x)
            a = np.tanh(mu.cpu().numpy()[0])
            return policy.low + (a + 1.0) * 0.5 * (policy.high - policy.low)
        with torch.no_grad():
            logits = policy.logits(policy.params, x)
        logits = logits.cpu().numpy()
        if policy.discrete:
            return int(logits.argmax(-1)[0])
        return logits[0]

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        import os
        import tempfile
        checkpoint_dir = checkpoint_dir or tempfile.mkdtemp(
            prefix="rllib_ckpt_")
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump({
                "weights": self.get_weights(),
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_path: str) -> None:
        import os
        if os.path.isdir(checkpoint_path):
            checkpoint_path = os.path.join(checkpoint_path,
                                           "algorithm_state.pkl")
        with open(checkpoint_path, "rb") as f:
            state = pickle.load(f)
        self.set_weights(state["weights"])
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]

    def stop(self) -> None:
        self.workers.stop()
