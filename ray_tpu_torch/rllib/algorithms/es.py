"""ES: OpenAI-style evolution strategies.

The port of ``ray_tpu/rllib/algorithms/es.py`` (the reference's
rllib/algorithms/es): derivative-free policy search. A shared Gaussian
noise table lives in the object store; evaluator actors (on the CPU) draw
antithetic perturbation pairs theta ± sigma*eps (eps = a slice of the
table addressed by index, so only indices travel back), roll out one
episode per perturbation, and the driver combines centered-rank weighted
noise into a gradient estimate applied with optax's Adam to the flat
parameter vector on ``config.device`` (the CUDA card unless the config
asks for the CPU). No backpropagation anywhere.

The flat vector is laid out as ``jax.flatten_util.ravel_pytree`` lays it
out (:func:`ravel`: the leaves in sorted-key order, each raveled in C
order), so a noise index perturbs the same weights in both packages.

Differences from the reference: no observation mean/std filter (the
connector-level MeanStd filter covers that capability elsewhere), and the
policy is the standard catalog MLP rather than a bespoke ES net.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import init_optimizer
from ray_tpu_torch.rllib.policy.torch_policy import (as_tensor, named_leaves,
                                                     unflatten)


def ravel(tree: Any) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """``jax.flatten_util.ravel_pytree``: the tree's leaves, in
    ``jax.tree_util``'s order (dict keys sorted), each raveled in C order
    and concatenated into one float32 vector on their device; and the
    inverse, which lays a vector (on any device) out as the tree, each
    leaf a copy that requires gradients as the tree's did."""
    leaves = named_leaves(tree)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in leaves.values()])
    shapes = [(name, tuple(t.shape), t.numel(), t.requires_grad)
              for name, t in leaves.items()]

    def unravel(vector: torch.Tensor) -> Any:
        out, offset = {}, 0
        for name, shape, size, grad in shapes:
            out[name] = vector[offset:offset + size].reshape(
                shape).clone().requires_grad_(grad)
            offset += size
        return unflatten(tree, out)

    return flat, unravel


def create_shared_noise(count: int = 1_000_000, seed: int = 42
                        ) -> np.ndarray:
    """The shared noise table (reference: es/utils.py create_shared_noise):
    one big float32 Gaussian array; perturbations are random slices."""
    return np.random.default_rng(seed).standard_normal(
        count).astype(np.float32)


def centered_ranks(x: np.ndarray) -> np.ndarray:
    """Rank-transform returns to [-0.5, 0.5] (reference:
    es/utils.py compute_centered_ranks) — scale-free fitness shaping."""
    ranks = np.empty(x.size, dtype=np.float32)
    ranks[x.ravel().argsort()] = np.arange(x.size, dtype=np.float32)
    return (ranks / (x.size - 1) - 0.5).reshape(x.shape)


class ESWorker:
    """Perturbation evaluator actor: holds the env, a policy skeleton on
    the CPU and the noise table; evaluates antithetic pairs
    deterministically."""

    def __init__(self, env_creator, policy_config, noise, worker_index=0,
                 seed=0):
        from ray_tpu_torch.rllib.policy import make_policy
        self.env = env_creator(policy_config.get("env_config") or {})
        self.policy = make_policy(policy_config,
                                  self.env.observation_space,
                                  self.env.action_space, seed=seed,
                                  device="cpu")
        _, self._unravel = ravel(self.policy.params)
        self.noise = np.asarray(noise)
        self._rng = np.random.default_rng(seed * 1000 + worker_index)
        self.worker_index = worker_index
        if not self.policy.discrete:
            space = self.env.action_space
            self._low = np.asarray(space.low, np.float32)
            self._high = np.asarray(space.high, np.float32)

    def _rollout(self, theta: np.ndarray, horizon: int):
        params = self._unravel(torch.from_numpy(theta))
        obs, _ = self.env.reset(
            seed=int(self._rng.integers(0, 2**31 - 1)))
        total, steps, done = 0.0, 0, False
        while not done and steps < horizon:
            with torch.no_grad():
                logits = self.policy.logits(params, as_tensor(
                    np.asarray(obs, np.float32).reshape(1, -1),
                    "cpu")).numpy()
            if self.policy.discrete:
                action = int(logits.argmax(-1)[0])
            else:
                # A perturbed unbounded head can leave the action space;
                # clip like the clip_actions connector does elsewhere.
                action = np.clip(logits[0], self._low, self._high)
            obs, reward, terminated, truncated, _ = self.env.step(action)
            total += float(reward)
            steps += 1
            done = terminated or truncated
        return total, steps

    def do_rollouts(self, theta: np.ndarray, num_pairs: int, sigma: float,
                    horizon: int) -> Dict[str, Any]:
        theta = np.asarray(theta, np.float32)
        dim = theta.size
        indices, r_pos, r_neg, lengths = [], [], [], []
        for _ in range(num_pairs):
            idx = int(self._rng.integers(0, self.noise.size - dim + 1))
            eps = self.noise[idx:idx + dim]
            ret_p, len_p = self._rollout(theta + sigma * eps, horizon)
            ret_n, len_n = self._rollout(theta - sigma * eps, horizon)
            indices.append(idx)
            r_pos.append(ret_p)
            r_neg.append(ret_n)
            lengths.extend((len_p, len_n))
        return {
            "noise_indices": np.asarray(indices, np.int64),
            "returns_pos": np.asarray(r_pos, np.float32),
            "returns_neg": np.asarray(r_neg, np.float32),
            "lengths": np.asarray(lengths, np.int64),
        }


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ES)
        self.num_rollout_workers = 2       # evaluator actors
        self.noise_stdev = 0.05
        self.stepsize = 0.03
        self.num_rollout_pairs_per_worker = 10
        self.episode_horizon = 1000
        self.noise_table_size = 1_000_000
        self.fcnet_hiddens = (32, 32)

    def training(self, *, noise_stdev=None, stepsize=None,
                 num_rollout_pairs_per_worker=None, episode_horizon=None,
                 noise_table_size=None, **kwargs) -> "ESConfig":
        super().training(**kwargs)
        for name, val in (
                ("noise_stdev", noise_stdev), ("stepsize", stepsize),
                ("num_rollout_pairs_per_worker",
                 num_rollout_pairs_per_worker),
                ("episode_horizon", episode_horizon),
                ("noise_table_size", noise_table_size)):
            if val is not None:
                setattr(self, name, val)
        return self


class ES(Algorithm):
    _default_config_class = ESConfig
    _own_rollout_actors = True
    _learner_trees = ("_theta",)
    _learner_opts = {"_opt_state": "_theta"}
    _learner_values = ()

    def setup(self, config: ESConfig) -> None:
        self._theta, self._unravel = ravel(self.local_policy.params)
        if int(self._theta.numel()) > config.noise_table_size:
            raise ValueError(
                f"Policy has {int(self._theta.numel())} parameters but the "
                f"shared noise table holds only {config.noise_table_size}; "
                "raise config.training(noise_table_size=...) above the "
                "parameter count")
        self._noise = create_shared_noise(config.noise_table_size,
                                          seed=config.seed + 123)
        noise_ref = ray_tpu_torch.put(self._noise)
        worker_cls = ray_tpu_torch.remote(ESWorker)
        self._es_workers = [
            worker_cls.options(num_cpus=config.num_cpus_per_worker).remote(
                self._env_creator, config.policy_config(), noise_ref,
                worker_index=i + 1, seed=config.seed)
            for i in range(max(config.num_rollout_workers, 1))]
        self._optimizer = optim.adam(config.stepsize)
        self._opt_state = init_optimizer(self._optimizer, self._theta)
        self._episodes_total = 0

    def _after_load(self) -> None:
        self.local_policy.params = self._unravel(self._theta)

    def _gradient(self, indices, returns_pos, returns_neg) -> np.ndarray:
        """Centered-rank antithetic gradient estimate (maximization), on
        the host."""
        dim = self._theta.numel()
        ranks = centered_ranks(
            np.concatenate([returns_pos, returns_neg]))
        w = ranks[:len(returns_pos)] - ranks[len(returns_pos):]
        g = np.zeros(dim, np.float32)
        for weight, idx in zip(w, indices):
            g += weight * self._noise[idx:idx + dim]
        return g / max(len(indices), 1)

    def learn_on_returns(self, indices, returns_pos, returns_neg
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """One Adam step of theta, on the learner's device, from the
        perturbations' returns; returns the gradient estimate and the
        update (numpy)."""
        grad = self._gradient(indices, returns_pos, returns_neg)
        # optax minimizes; ES ascends the return.
        updates = {"": torch.from_numpy(-grad).to(self._theta.device)}
        updates, self._opt_state = self._optimizer.update(
            updates, self._opt_state, {"": self._theta})
        optim.apply_updates({"": self._theta}, updates)
        self.local_policy.params = self._unravel(self._theta)
        return grad, updates[""].cpu().numpy()

    def training_step(self) -> Dict[str, Any]:
        config: ESConfig = self.config
        theta_ref = ray_tpu_torch.put(self._theta.cpu().numpy())
        results = ray_tpu_torch.get([
            w.do_rollouts.remote(theta_ref,
                                 config.num_rollout_pairs_per_worker,
                                 config.noise_stdev,
                                 config.episode_horizon)
            for w in self._es_workers])
        indices = np.concatenate([r["noise_indices"] for r in results])
        returns_pos = np.concatenate([r["returns_pos"] for r in results])
        returns_neg = np.concatenate([r["returns_neg"] for r in results])
        lengths = np.concatenate([r["lengths"] for r in results])
        self._timesteps_total += int(lengths.sum())
        self._episodes_total += lengths.size

        grad, updates = self.learn_on_returns(indices, returns_pos,
                                              returns_neg)
        all_returns = np.concatenate([returns_pos, returns_neg])
        theta = self._theta.cpu().numpy()
        return {
            "episode_reward_mean": float(all_returns.mean()),
            "episode_reward_max": float(all_returns.max()),
            "episode_len_mean": float(lengths.mean()),
            "episodes_total": self._episodes_total,
            "grad_norm": float(np.linalg.norm(grad)),
            "update_ratio": float(
                np.linalg.norm(updates) / (np.linalg.norm(theta) + 1e-8)),
        }

    def stop(self) -> None:
        for w in self._es_workers:
            ray_tpu_torch.kill(w)
        super().stop()
