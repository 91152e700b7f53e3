"""MAML: model-agnostic meta-learning for RL (first-order).

The port of ``ray_tpu/rllib/algorithms/maml.py`` (the reference's
rllib/algorithms/maml; Finn et al. 2017): meta-train policy
initializations that ADAPT to a new task in a handful of gradient steps.
Each meta-iteration samples tasks from ``task_sampler`` (env_config
variations, e.g. hidden goals the observation never reveals); per task,
the INNER loop collects episodes with the meta-policy and takes
``inner_steps`` REINFORCE steps ``p - inner_lr * g``; the OUTER update
averages the post-adaptation policy gradients across tasks, taken at the
ADAPTED parameters (first-order MAML: the Hessian term dropped), and
steps the meta-parameters with optax's Adam.

The policy is the standard :class:`TorchPolicy`; its parameters, the
inner steps and the meta-update live on ``config.device`` (the CUDA card
unless the config asks for the CPU), the episodes run on the host with
actions drawn on the policy's device from its generator.
:func:`first_order_step` is the part MBMPO shares: the adapted
parameters' gradients summed over tasks, averaged, and one meta step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.torch_policy import (as_tensor, named_leaves,
                                                     unflatten)


class MAMLConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MAML)
        self.inner_lr = 0.1
        self.lr = 1e-2                  # meta (outer) learning rate
        self.inner_steps = 1
        self.episodes_per_inner_batch = 8
        self.tasks_per_iteration = 5
        self.max_episode_steps = 30
        #: callable (rng) -> env_config for one sampled task; set via
        #: .training(task_sampler=...). Defaults to the identity task.
        self.task_sampler: Optional[Callable] = None

    def training(self, *, inner_lr=None, inner_steps=None,
                 episodes_per_inner_batch=None, tasks_per_iteration=None,
                 max_episode_steps=None, task_sampler=None,
                 **kwargs) -> "MAMLConfig":
        super().training(**kwargs)
        for name, val in (
                ("inner_lr", inner_lr), ("inner_steps", inner_steps),
                ("episodes_per_inner_batch", episodes_per_inner_batch),
                ("tasks_per_iteration", tasks_per_iteration),
                ("max_episode_steps", max_episode_steps),
                ("task_sampler", task_sampler)):
            if val is not None:
                setattr(self, name, val)
        return self


def reinforce_grads(policy, params, obs, actions, advantages
                    ) -> Dict[str, torch.Tensor]:
    """``jax.grad`` of ``-(logp * advantages).mean()`` at ``params``, by
    parameter name (zeros for the value head, which it does not reach)."""
    def loss_fn(p, _batch):
        logp = policy.logp(p, obs, actions)
        return -(logp * advantages).mean(), {}

    return loss_grads(loss_fn, params, None)[0]


def inner_update(policy, params, batch, inner_lr: float):
    """One inner REINFORCE step ``p - inner_lr * g``: a new parameter tree
    that takes gradients (the first-order outer gradient is taken at
    it)."""
    grads = reinforce_grads(policy, params, *batch)
    return unflatten(params, {
        n: (p.detach() - inner_lr * grads[n]).requires_grad_()
        for n, p in named_leaves(params).items()})


def first_order_step(policy, optimizer, opt_state, tasks: Sequence[Tuple]):
    """The meta-update of first-order MAML over ``tasks``, each ``(adapted
    parameters, post batch)`` with the batch ``(obs, actions,
    advantages)`` tensors: the post batch's gradient at the adapted
    parameters, summed over tasks and divided by their count, steps
    ``policy.params`` in place; returns the optimizer state."""
    meta: Optional[Dict[str, torch.Tensor]] = None
    for adapted, post in tasks:
        g = reinforce_grads(policy, adapted, *post)
        meta = g if meta is None else {n: meta[n] + g[n] for n in meta}
    meta = {n: g / len(tasks) for n, g in meta.items()}
    return apply_grads(optimizer, policy.params, opt_state, meta)


class MAML(Algorithm):
    _default_config_class = MAMLConfig
    _own_rollout_actors = True
    _learner_trees = ()
    _learner_opts = {"_meta_state": "params"}
    _learner_values = ()

    def setup(self, config: MAMLConfig) -> None:
        policy = self.local_policy
        self._meta_opt = optim.adam(config.lr)
        self._meta_state = init_optimizer(self._meta_opt, policy.params)
        self._rng = np.random.default_rng(config.seed)
        self._gen = policy.make_generator(config.seed + 3)
        self._episode_rewards: List[float] = []
        self._post_adapt_rewards: List[float] = []

    def _inner_update(self, params, obs, actions, advantages):
        return inner_update(self.local_policy, params,
                            (obs, actions, advantages), self.config.inner_lr)

    # -- rollout helpers -------------------------------------------------

    def _collect(self, env, params, episodes: int):
        """REINFORCE batch on the policy's device: (obs, actions,
        standardized returns-to-go, mean episode return)."""
        policy = self.local_policy
        config: MAMLConfig = self.config
        all_obs, all_act, all_ret = [], [], []
        ep_returns = []
        saved = policy.params
        policy.params = params
        try:
            for _ in range(episodes):
                obs, _ = env.reset(
                    seed=int(self._rng.integers(1 << 30)))
                rows_obs, rows_act, rows_rew = [], [], []
                for _ in range(config.max_episode_steps):
                    vec = np.asarray(obs, np.float32).reshape(1, -1)
                    action, _, _ = policy.compute_actions(vec, self._gen)
                    act = action[0]
                    act_env = (int(act) if policy.discrete
                               else np.asarray(act))
                    obs, r, term, trunc, _ = env.step(act_env)
                    rows_obs.append(vec[0])
                    rows_act.append(act)
                    rows_rew.append(float(r))
                    if term or trunc:
                        break
                rets = np.cumsum(rows_rew[::-1])[::-1]
                all_obs.append(np.stack(rows_obs))
                all_act.append(np.stack(rows_act))
                all_ret.append(np.asarray(rets, np.float32))
                ep_returns.append(float(np.sum(rows_rew)))
        finally:
            policy.params = saved
        # Flattened returns-to-go, globally standardized.
        rets = np.stack(all_ret)                     # [E, T]
        adv = rets - rets.mean()
        adv = adv / max(adv.std(), 1e-6)
        device = policy.device
        return (as_tensor(np.concatenate(all_obs), device),
                as_tensor(np.concatenate(all_act), device),
                as_tensor(adv.reshape(-1), device),
                float(np.mean(ep_returns)))

    def _adapt_params(self, env, params):
        """Run the inner loop; returns (adapted params, pre-adapt
        return)."""
        config: MAMLConfig = self.config
        pre = None
        for _ in range(config.inner_steps):
            obs, act, ret, mean_ret = self._collect(
                env, params, config.episodes_per_inner_batch)
            if pre is None:
                pre = mean_ret
            params = self._inner_update(params, obs, act, ret)
        return params, pre

    def adapt(self, env, inner_steps: Optional[int] = None):
        """Deployment-time adaptation: inner-loop the meta-policy on a
        fresh task env; returns adapted params (use with
        policy.compute_actions)."""
        config: MAMLConfig = self.config
        params = self.local_policy.params
        steps = (config.inner_steps if inner_steps is None
                 else inner_steps)
        for _ in range(steps):
            obs, act, ret, _ = self._collect(
                env, params, config.episodes_per_inner_batch)
            params = self._inner_update(params, obs, act, ret)
        return params

    def learn_on_tasks(self, tasks: Sequence[Tuple]) -> None:
        """One meta-update on the learner's device over ``tasks``, each
        ``(pre_batches, post_batch)`` of ``(obs, actions, advantages)``
        tensors: the meta-parameters adapted on the pre batches in turn,
        then :func:`first_order_step`."""
        adapted = []
        for pre_batches, post in tasks:
            params = self.local_policy.params
            for batch in pre_batches:
                params = self._inner_update(params, *batch)
            adapted.append((params, post))
        self._meta_state = first_order_step(
            self.local_policy, self._meta_opt, self._meta_state, adapted)

    # -- meta loop -------------------------------------------------------

    def training_step(self) -> Dict[str, Any]:
        config: MAMLConfig = self.config
        sampler = config.task_sampler or (lambda rng: {})
        policy = self.local_policy
        tasks = []
        pre_returns, post_returns = [], []
        for _ in range(config.tasks_per_iteration):
            env = self._env_creator(
                dict(config.env_config, **sampler(self._rng)))
            try:
                adapted, pre = self._adapt_params(env, policy.params)
                obs, act, ret, post = self._collect(
                    env, adapted, config.episodes_per_inner_batch)
                tasks.append((adapted, (obs, act, ret)))
                pre_returns.append(pre)
                post_returns.append(post)
                self._timesteps_total += int(obs.shape[0])
            finally:
                close = getattr(env, "close", None)
                if callable(close):
                    close()
        # First-order MAML: the outer gradient at the ADAPTED parameters,
        # applied to the meta-parameters.
        self._meta_state = first_order_step(policy, self._meta_opt,
                                            self._meta_state, tasks)
        pre, post = float(np.mean(pre_returns)), \
            float(np.mean(post_returns))
        self._episode_rewards.append(post)
        self._post_adapt_rewards.append(post)
        return {
            "pre_adaptation_return": pre,
            "post_adaptation_return": post,
            "adaptation_gain": post - pre,
            "episode_reward_mean": post,
        }

    def get_weights(self):
        return self.local_policy.get_weights()

    def set_weights(self, weights) -> None:
        self.local_policy.set_weights(weights)
