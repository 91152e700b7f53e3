"""MBMPO: model-based meta-policy optimization.

The port of ``ray_tpu/rllib/algorithms/mbmpo.py`` (the reference's
rllib/algorithms/mbmpo; Clavera et al. 2018): learn an ENSEMBLE of
dynamics models from real transitions, then treat EACH model as a
meta-learning task: the policy inner-adapts on imagined rollouts through
model k and the outer (first-order) step averages the post-adaptation
gradients across models (MAML's step, ``maml.first_order_step``). The
real env is touched only to refresh the transition buffer.

Env contract: Box actions (read by their ``low``/``high`` attributes) and
a ``reward_fn(s, a, s') -> float`` the imagination can evaluate without
the env (env/examples.py PointGoalEnv).

Ensemble dynamics: K MLPs predicting normalized Δs from normalized
(s, a), drawn one after the other from one generator, each with its own
optax Adam; inputs and targets standardized by statistics of the real
buffer (numpy on the host, on the device for each call). The ensemble,
the policy and the meta-update live on ``config.device`` (the CUDA card
unless the config asks for the CPU); imagined batches run through one
model at a time, their rewards on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.maml import first_order_step, inner_update
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.models.catalog import mlp_apply, mlp_init
from ray_tpu_torch.rllib.policy.torch_policy import (action_dims, as_tensor,
                                                     from_jax_params,
                                                     to_numpy)


class MBMPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MBMPO)
        self.lr = 1e-2                  # meta (outer) policy lr
        self.inner_lr = 0.1
        self.dynamics_lr = 1e-3
        self.ensemble_size = 3
        self.dynamics_hiddens = (64, 64)
        self.dynamics_epochs = 40
        self.dynamics_batch_size = 256
        self.real_steps_per_iteration = 400
        self.imagined_episodes = 16
        self.imagined_horizon = 20
        self.max_episode_steps = 30
        self.explore_noise = 0.3
        self.buffer_capacity = 20_000

    def training(self, *, inner_lr=None, dynamics_lr=None,
                 ensemble_size=None, dynamics_hiddens=None,
                 dynamics_epochs=None, dynamics_batch_size=None,
                 real_steps_per_iteration=None, imagined_episodes=None,
                 imagined_horizon=None, max_episode_steps=None,
                 explore_noise=None, **kwargs) -> "MBMPOConfig":
        super().training(**kwargs)
        for name, val in (
                ("inner_lr", inner_lr), ("dynamics_lr", dynamics_lr),
                ("ensemble_size", ensemble_size),
                ("dynamics_hiddens", dynamics_hiddens),
                ("dynamics_epochs", dynamics_epochs),
                ("dynamics_batch_size", dynamics_batch_size),
                ("real_steps_per_iteration", real_steps_per_iteration),
                ("imagined_episodes", imagined_episodes),
                ("imagined_horizon", imagined_horizon),
                ("max_episode_steps", max_episode_steps),
                ("explore_noise", explore_noise)):
            if val is not None:
                setattr(self, name, val)
        return self


def _normalized_input(stats, s, a):
    return torch.cat([(s - stats["s_mean"]) / stats["s_std"],
                      (a - stats["a_mean"]) / stats["a_std"]], -1)


def dyn_forward(p, stats, s, a):
    """The next state a dynamics model predicts: ``s`` plus its
    de-normalized Δs."""
    delta_n = mlp_apply(p, _normalized_input(stats, s, a))
    return s + delta_n * stats["d_std"] + stats["d_mean"]


def dyn_loss(p, stats, s, a, s_next):
    pred_n = mlp_apply(p, _normalized_input(stats, s, a))
    target_n = ((s_next - s) - stats["d_mean"]) / stats["d_std"]
    return ((pred_n - target_n) ** 2).mean()


class MBMPO(Algorithm):
    _default_config_class = MBMPOConfig
    _own_rollout_actors = True
    _learner_trees = ("dyn_params",)
    _learner_opts = {"_dyn_states": "dyn_params", "_meta_state": "params"}
    _learner_values = ("_stats",)

    def setup(self, config: MBMPOConfig) -> None:
        env = self._env_creator(config.env_config)
        if not hasattr(env, "reward_fn"):
            raise ValueError(
                "MBMPO needs an env exposing reward_fn(s, a, s') — "
                "imagined rollouts must be rewardable without the env "
                "(see env/examples.py PointGoalEnv)")
        space = env.action_space
        if action_dims(space)[0] or not hasattr(space, "low"):
            raise ValueError("MBMPO supports Box action spaces")
        self._env = env
        policy = self.local_policy
        self.device = policy.device
        self.obs_dim = policy.obs_dim
        self.act_dim = policy.act_dim
        hid = list(config.dynamics_hiddens)
        gen = torch.Generator().manual_seed(config.seed + 11)
        in_dim = self.obs_dim + self.act_dim
        self.dyn_params = [
            mlp_init(gen, [in_dim, *hid, self.obs_dim], self.device)
            for _ in range(config.ensemble_size)]
        self._dyn_opt = optim.adam(config.dynamics_lr)
        self._dyn_states = [init_optimizer(self._dyn_opt, p)
                            for p in self.dyn_params]
        self._meta_opt = optim.adam(config.lr)
        self._meta_state = init_optimizer(self._meta_opt, policy.params)
        self._rng = np.random.default_rng(config.seed)
        self._gen = policy.make_generator(config.seed + 23)

        # Running normalization stats (updated from the real buffer).
        self._stats = {
            "s_mean": np.zeros(self.obs_dim, np.float32),
            "s_std": np.ones(self.obs_dim, np.float32),
            "a_mean": np.zeros(self.act_dim, np.float32),
            "a_std": np.ones(self.act_dim, np.float32),
            "d_mean": np.zeros(self.obs_dim, np.float32),
            "d_std": np.ones(self.obs_dim, np.float32),
        }
        self._buffer_s: List[np.ndarray] = []
        self._buffer_a: List[np.ndarray] = []
        self._buffer_ns: List[np.ndarray] = []
        self._episode_rewards: List[float] = []

    def _device_stats(self) -> Dict[str, torch.Tensor]:
        return {k: as_tensor(v, self.device) for k, v in self._stats.items()}

    # -- real-env interaction -------------------------------------------

    def _collect_real(self, steps: int) -> None:
        config: MBMPOConfig = self.config
        policy = self.local_policy
        obs, _ = self._env.reset(
            seed=int(self._rng.integers(1 << 30)))
        ep_reward, ep_len = 0.0, 0
        for _ in range(steps):
            vec = np.asarray(obs, np.float32).reshape(1, -1)
            action, _, _ = policy.compute_actions(vec, self._gen)
            a = np.asarray(action[0], np.float32)
            a = a + config.explore_noise * \
                self._rng.standard_normal(a.shape).astype(np.float32)
            nxt, r, term, trunc, _ = self._env.step(a)
            self._buffer_s.append(vec[0])
            self._buffer_a.append(a)
            self._buffer_ns.append(
                np.asarray(nxt, np.float32).reshape(-1))
            ep_reward += float(r)
            ep_len += 1
            self._timesteps_total += 1
            if term or trunc or ep_len >= config.max_episode_steps:
                self._episode_rewards.append(ep_reward)
                ep_reward, ep_len = 0.0, 0
                obs, _ = self._env.reset()
            else:
                obs = nxt
        cap = config.buffer_capacity
        del self._buffer_s[:-cap]
        del self._buffer_a[:-cap]
        del self._buffer_ns[:-cap]

    def _dyn_update(self, k: int, stats, s, a, s_next) -> torch.Tensor:
        """One Adam step of ensemble member ``k``; returns its loss."""
        grads, metrics = loss_grads(
            lambda p, _b: (dyn_loss(p, stats, s, a, s_next), {}),
            self.dyn_params[k], None)
        self._dyn_states[k] = apply_grads(self._dyn_opt, self.dyn_params[k],
                                          self._dyn_states[k], grads)
        return metrics["total_loss"]

    def _fit_dynamics(self) -> float:
        """Refresh the statistics from the buffer and fit every member on
        its own bootstrap resamples; returns the mean of their last
        losses."""
        config: MBMPOConfig = self.config
        s = np.stack(self._buffer_s)
        a = np.stack(self._buffer_a)
        ns = np.stack(self._buffer_ns)
        d = ns - s
        for name, arr in (("s", s), ("a", a), ("d", d)):
            self._stats[f"{name}_mean"] = arr.mean(0).astype(np.float32)
            self._stats[f"{name}_std"] = np.maximum(
                arr.std(0), 1e-3).astype(np.float32)
        stats = self._device_stats()
        n = len(s)
        bs = min(config.dynamics_batch_size, n)
        losses = []
        for k in range(config.ensemble_size):
            # Each member sees its own bootstrap resample (the ensemble
            # diversity mechanism).
            rng = np.random.default_rng(1000 * k + self.iteration)
            for _ in range(config.dynamics_epochs):
                idx = rng.integers(0, n, bs)
                loss = self._dyn_update(
                    k, stats, *(as_tensor(x[idx], self.device)
                                for x in (s, a, ns)))
            losses.append(float(loss))
        return float(np.mean(losses))

    # -- imagination -----------------------------------------------------

    def _imagine_batch(self, params, model_idx: int):
        """Roll imagined episodes through ensemble member ``model_idx``
        under ``params``; returns REINFORCE tensors (obs, act, adv) and
        the mean imagined return."""
        config: MBMPOConfig = self.config
        policy = self.local_policy
        stats = self._device_stats()
        E, H = config.imagined_episodes, config.imagined_horizon
        # Start states resampled from REAL data.
        idx = self._rng.integers(0, len(self._buffer_s), E)
        s = np.stack([self._buffer_s[i] for i in idx])
        saved = policy.params
        policy.params = params
        obs_rows, act_rows, rew_rows = [], [], []
        try:
            for _ in range(H):
                a, _, _ = policy.compute_actions(s, self._gen)
                with torch.no_grad():
                    s_next = dyn_forward(
                        self.dyn_params[model_idx], stats,
                        as_tensor(s, self.device),
                        as_tensor(a, self.device)).cpu().numpy()
                r = np.asarray([
                    self._env.reward_fn(s[i], a[i], s_next[i])
                    for i in range(E)], np.float32)
                obs_rows.append(s)
                act_rows.append(a)
                rew_rows.append(r)
                s = s_next
        finally:
            policy.params = saved
        rew = np.stack(rew_rows, 1)              # [E, H]
        rets = np.cumsum(rew[:, ::-1], axis=1)[:, ::-1]
        adv = rets - rets.mean()
        adv = adv / max(adv.std(), 1e-6)
        obs = np.stack(obs_rows, 1).reshape(E * H, -1)
        act = np.stack(act_rows, 1).reshape(E * H, -1)
        return (as_tensor(obs, self.device), as_tensor(act, self.device),
                as_tensor(adv.reshape(-1).astype(np.float32), self.device),
                float(rew.sum(1).mean()))

    def dynamics_disagreement(self, s: np.ndarray, a: np.ndarray
                              ) -> float:
        """Std of ensemble next-state predictions — the model
        uncertainty gauge."""
        stats = self._device_stats()
        with torch.no_grad():
            preds = [dyn_forward(p, stats, as_tensor(s, self.device),
                                 as_tensor(a, self.device)).cpu().numpy()
                     for p in self.dyn_params]
        return float(np.stack(preds).std(0).mean())

    # -- meta loop -------------------------------------------------------

    def learn_on_tasks(self, tasks) -> None:
        """One meta-update on the learner's device over one task per
        model, each ``(pre_batch, post_batch)`` of ``(obs, actions,
        advantages)`` tensors: one inner step on the pre batch, then
        MAML's first-order step."""
        policy = self.local_policy
        self._meta_state = first_order_step(
            policy, self._meta_opt, self._meta_state,
            [(inner_update(policy, policy.params, pre,
                           self.config.inner_lr), post)
             for pre, post in tasks])

    def training_step(self) -> Dict[str, Any]:
        config: MBMPOConfig = self.config
        policy = self.local_policy
        self._collect_real(config.real_steps_per_iteration)
        dyn_loss_mean = self._fit_dynamics()

        tasks = []
        imag_returns = []
        for k in range(config.ensemble_size):
            obs, act, adv, _ = self._imagine_batch(policy.params, k)
            adapted = inner_update(policy, policy.params, (obs, act, adv),
                                   config.inner_lr)
            obs2, act2, adv2, post_ret = self._imagine_batch(adapted, k)
            tasks.append((adapted, (obs2, act2, adv2)))
            imag_returns.append(post_ret)
        self._meta_state = first_order_step(policy, self._meta_opt,
                                            self._meta_state, tasks)

        window = self._episode_rewards[-50:]
        return {
            "dynamics_loss": dyn_loss_mean,
            "imagined_return_mean": float(np.mean(imag_returns)),
            "episode_reward_mean": (float(np.mean(window)) if window
                                    else float("nan")),
            "episodes_total": len(self._episode_rewards),
        }

    def get_weights(self):
        return {"policy": self.local_policy.get_weights(),
                "dynamics": [to_numpy(p) for p in self.dyn_params],
                "stats": dict(self._stats)}

    def set_weights(self, weights) -> None:
        self.local_policy.set_weights(weights["policy"])
        self.dyn_params = [from_jax_params(p, self.device)
                           for p in weights["dynamics"]]
        self._stats = dict(weights["stats"])

    def stop(self) -> None:
        close = getattr(self._env, "close", None)
        if callable(close):
            close()
