"""CRR: critic-regularized regression for offline RL.

The port of ``ray_tpu/rllib/algorithms/crr.py`` (the reference's
rllib/algorithms/crr; Wang et al. 2020, "Critic Regularized Regression"):
behavior cloning where each logged action's log-likelihood is WEIGHTED by
its advantage under a learned critic, so the policy imitates only the
parts of the dataset the critic thinks beat the current policy.

Updates from a once-loaded JSON dataset (bc.py's offline contract):
  * critic: TD toward ``r + gamma * E_{a'~pi}[Q_target(s', a')]``
    (exact expectation for Discrete; policy samples for Box),
  * actor: ``-f(A(s,a)) * log pi(a|s)`` with ``A = Q(s,a) -
    E_{a~pi}Q(s,a)`` and ``f`` either ``binary`` (1[A>0]) or ``exp``
    (exp(A/beta), clipped).

The actor is the standard :class:`TorchPolicy`; the critic is owned here
(Q(s, .) for Discrete, Q(s, a) for Box). The learner runs on
``config.device`` (the CUDA card unless the config asks for the CPU) with
optax's Adam. The JAX update draws the Box expectation's policy samples
from ``fold_in`` keys inside its jit; here that noise is explicit
(:meth:`CRR.draw_noise`): ``n_action_samples`` standard normals per row
for the critic's next actions ("critic") and the actor's ("actor").
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.learner_state import target_copy
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.models.catalog import mlp_apply, mlp_init
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor, named_leaves

_COLUMNS = ((SampleBatch.OBS, "obs"), (SampleBatch.ACTIONS, "actions"),
            (SampleBatch.REWARDS, "rewards"),
            (SampleBatch.NEXT_OBS, "new_obs"),
            (SampleBatch.TERMINATEDS, "terminateds"))


class CRRConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or CRR)
        self.lr = 3e-4
        self.critic_lr = 3e-4
        self.train_batch_size = 256
        self.num_rollout_workers = 0   # offline: WorkerSet stays empty
        self.num_train_batches_per_iteration = 64
        self.tau = 0.005
        self.weight_type = "binary"    # "binary" | "exp"
        self.beta = 1.0                # exp temperature
        self.weight_clip = 20.0
        self.n_action_samples = 4      # E_{a~pi}Q estimator (Box only)

    def training(self, *, critic_lr=None, tau=None, weight_type=None,
                 beta=None, weight_clip=None, n_action_samples=None,
                 num_train_batches_per_iteration=None,
                 **kwargs) -> "CRRConfig":
        super().training(**kwargs)
        for name, val in (("critic_lr", critic_lr), ("tau", tau),
                          ("weight_type", weight_type), ("beta", beta),
                          ("weight_clip", weight_clip),
                          ("n_action_samples", n_action_samples),
                          ("num_train_batches_per_iteration",
                           num_train_batches_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self


class CRR(Algorithm):
    _default_config_class = CRRConfig
    _learner_trees = ("_q_params", "_q_target")
    _learner_opts = {"_actor_state": "params", "_critic_state": "_q_params"}
    _learner_values = ()

    def __init__(self, config=None, **kwargs):
        cfg = config or self.get_default_config()
        if not cfg.input_:
            raise ValueError(
                "CRR is offline-only: set config.offline_data("
                "input_=<dir of JSON experience files>)")
        if cfg.weight_type not in ("binary", "exp"):
            raise ValueError(
                f"weight_type must be 'binary' or 'exp', got "
                f"{cfg.weight_type!r}")
        super().__init__(config=config, **kwargs)

    def setup(self, config: CRRConfig) -> None:
        from ray_tpu_torch.rllib.offline.json_reader import JsonReader

        self._reader = JsonReader(config.input_)
        policy = self.local_policy
        device = policy.device
        q_out = policy.act_dim if policy.discrete else 1
        q_in = (policy.obs_dim if policy.discrete
                else policy.obs_dim + policy.act_dim)
        self._q_params = mlp_init(
            torch.Generator().manual_seed(config.seed + 7),
            [q_in, *config.fcnet_hiddens, q_out], device)
        self._q_target = target_copy(self._q_params)
        self._actor_opt = optim.adam(config.lr)
        self._critic_opt = optim.adam(config.critic_lr)
        self._actor_state = init_optimizer(self._actor_opt, policy.params)
        self._critic_state = init_optimizer(self._critic_opt, self._q_params)
        self._gen = torch.Generator(device=device).manual_seed(
            config.seed + 13)

    # -- the critic's view of the policy ---------------------------------

    def _q_of(self, qp, obs, actions):
        if self.local_policy.discrete:
            return torch.gather(mlp_apply(qp, obs), -1,
                                actions[..., None].long())[..., 0]
        return mlp_apply(qp, torch.cat([obs, actions], -1))[..., 0]

    def _exp_q(self, qp, actor_params, obs, noise):
        """``E_{a~pi}[Q(s, a)]``: exact over a categorical; the mean over
        the Box policy's samples ``mean + std * noise[i]``."""
        policy = self.local_policy
        logits = policy.logits(actor_params, obs)
        if policy.discrete:
            return (torch.softmax(logits, -1) * mlp_apply(qp, obs)).sum(-1)
        std = torch.exp(actor_params["log_std"])
        return torch.stack([self._q_of(qp, obs, logits + std * eps)
                            for eps in noise]).mean(0)

    def draw_noise(self, batch: int) -> Optional[Dict[str, torch.Tensor]]:
        """The update's noise for ``batch`` rows from the learner's
        generator: None for a categorical policy; for a Box one, "critic"
        and "actor", ``[n_action_samples, batch, act_dim]`` standard
        normals each."""
        policy = self.local_policy
        if policy.discrete:
            return None
        shape = (self.config.n_action_samples, batch, policy.act_dim)
        return {k: torch.randn(shape, generator=self._gen,
                               device=policy.device)
                for k in ("critic", "actor")}

    def _critic_loss(self, qp, mb, noise):
        config: CRRConfig = self.config
        with torch.no_grad():
            q_next = self._exp_q(self._q_target, self.local_policy.params,
                                 mb["new_obs"],
                                 None if noise is None else noise["critic"])
            target = mb["rewards"] + config.gamma * \
                (1.0 - mb["terminateds"]) * q_next
        q = self._q_of(qp, mb["obs"], mb["actions"])
        return ((q - target) ** 2).mean(), {}

    def _actor_loss(self, actor_params, mb, noise):
        config: CRRConfig = self.config
        with torch.no_grad():
            q = self._q_of(self._q_params, mb["obs"], mb["actions"])
            v = self._exp_q(self._q_params, actor_params, mb["obs"],
                            None if noise is None else noise["actor"])
            adv = q - v
            if config.weight_type == "binary":
                w = (adv > 0).to(torch.float32)
            else:
                w = torch.clamp(torch.exp(adv / config.beta), 0.0,
                                config.weight_clip)
        logp = self.local_policy.logp(actor_params, mb["obs"],
                                      mb["actions"])
        return -(w * logp).mean(), {"weight_mean": w.mean()}

    def learn_on_batch(self, mb: SampleBatch,
                       noise: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, float]:
        """One update on a minibatch of logged rows (the critic's step,
        then the actor's against the stepped critic, then the target's
        polyak step), with ``noise`` (:meth:`draw_noise`'s layout; drawn
        from the learner's generator when None)."""
        policy = self.local_policy
        tau = self.config.tau
        device_mb = {
            name: as_tensor(np.asarray(mb[col], np.float32)
                            if name != "actions" else mb[col],
                            policy.device)
            for col, name in _COLUMNS}
        if noise is None:
            noise = self.draw_noise(len(device_mb["obs"]))
        c_grads, c_metrics = loss_grads(
            lambda qp, b: self._critic_loss(qp, b, noise), self._q_params,
            device_mb)
        self._critic_state = apply_grads(self._critic_opt, self._q_params,
                                         self._critic_state, c_grads)
        a_grads, a_metrics = loss_grads(
            lambda ap, b: self._actor_loss(ap, b, noise), policy.params,
            device_mb)
        self._actor_state = apply_grads(self._actor_opt, policy.params,
                                        self._actor_state, a_grads)
        with torch.no_grad():
            for t, p in zip(named_leaves(self._q_target).values(),
                            named_leaves(self._q_params).values()):
                t.copy_((1 - tau) * t + tau * p)
        return {"critic_loss": float(c_metrics["total_loss"]),
                "actor_loss": float(a_metrics["total_loss"]),
                "weight_mean": float(a_metrics["weight_mean"])}

    def training_step(self) -> Dict[str, Any]:
        config: CRRConfig = self.config
        metrics: Dict[str, Any] = {}
        for _ in range(config.num_train_batches_per_iteration):
            mb = self._reader.next_batch(config.train_batch_size)
            self._timesteps_total += config.train_batch_size
            metrics = self.learn_on_batch(mb)
        return metrics
