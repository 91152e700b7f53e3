"""PPO: clipped-surrogate policy optimization with a torch learner.

The port of ``ray_tpu/rllib/algorithms/ppo.py`` (the reference's
rllib/algorithms/ppo, torch loss in ppo_torch_policy.py): sample via
WorkerSet, normalize advantages, run several epochs of minibatch SGD on
the clipped surrogate + value + entropy loss with optax's Adam
(``parallel/optim.py``). The learner's policy lives on ``config.device``,
the CUDA card unless the config asks for the CPU; the samplers run on the
CPU.

``learner_backend`` only chooses the SGD schedule, as in the JAX package;
the learner stays on ``config.device``. Unset, each epoch walks
``SampleBatch.minibatches(mb, seed=epoch)``, one update per minibatch.
Set (any true value, such as the JAX package's backend names), the batch
goes to the policy's device once per iteration and each epoch takes
``floor(n / mb)`` minibatches of one permutation from
``np.random.default_rng(iteration)``, indexed there: the JAX package's
``lax.scan`` over ``perm`` in one program.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.core.learner_group import learner_options
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import (as_tensor,
                                                     from_jax_params,
                                                     named_leaves, to_numpy,
                                                     tree_map, unflatten)


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or PPO)
        self.clip_param = 0.2
        self.num_sgd_iter = 8
        self.sgd_minibatch_size = 128
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.kl_target = 0.02
        self.lambda_ = 0.95
        self.lr = 3e-4
        #: Set: the fused SGD schedule (one permutation per epoch, the
        #: minibatches indexed on the policy's device). None = one update
        #: per minibatch. Either runs on config.device.
        self.learner_backend = None
        #: >0: a LEARNER GROUP of this many gradient-shard actors
        #: (reference: rl_trainer/trainer_runner.py TrainerRunner +
        #: multi_gpu_learner_thread) — each minibatch splits across
        #: them, gradients average row-weighted, every shard applies
        #: the same averaged update (synchronous DP; optimizer states
        #: stay identical across shards).
        self.num_learners = 0

    def training(self, *, clip_param=None, num_sgd_iter=None,
                 sgd_minibatch_size=None, vf_loss_coeff=None,
                 entropy_coeff=None, learner_backend=None,
                 num_learners=None,
                 **kwargs) -> "PPOConfig":
        super().training(**kwargs)
        if learner_backend is not None:
            self.learner_backend = learner_backend
        if num_learners is not None:
            self.num_learners = num_learners
        if clip_param is not None:
            self.clip_param = clip_param
        if num_sgd_iter is not None:
            self.num_sgd_iter = num_sgd_iter
        if sgd_minibatch_size is not None:
            self.sgd_minibatch_size = sgd_minibatch_size
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        return self


def make_ppo_loss(policy, clip: float, vf_coeff: float,
                  ent_coeff: float):
    """The clipped-surrogate PPO loss bound to ``policy``. Returns
    ``loss_fn(params, mb) -> (total, metrics)``."""

    def loss_fn(params, mb):
        logp = policy.logp(params, mb["obs"], mb["actions"])
        ratio = torch.exp(logp - mb["old_logp"])
        adv = mb["advantages"]
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        values = policy._value(params, mb["obs"])
        vf_loss = torch.mean((values - mb["value_targets"]) ** 2)
        entropy = torch.mean(policy.entropy(params, mb["obs"]))
        total = (-torch.mean(surrogate) + vf_coeff * vf_loss
                 - ent_coeff * entropy)
        approx_kl = torch.mean(mb["old_logp"] - logp)
        return total, {"policy_loss": -torch.mean(surrogate),
                       "vf_loss": vf_loss, "entropy": entropy,
                       "approx_kl": approx_kl}

    return loss_fn


def _sgd_batch(batch: SampleBatch, adv: np.ndarray) -> Dict[str, Any]:
    """The loss's columns of a GAE-complete batch, advantages normalized."""
    return {
        "obs": np.asarray(batch[SampleBatch.OBS], np.float32),
        "actions": np.asarray(batch[SampleBatch.ACTIONS]),
        "old_logp": np.asarray(batch[SampleBatch.ACTION_LOGP], np.float32),
        "advantages": adv.astype(np.float32),
        "value_targets": np.asarray(batch[SampleBatch.VALUE_TARGETS],
                                    np.float32),
    }


def _normalized_advantages(batch: SampleBatch) -> np.ndarray:
    adv = batch[SampleBatch.ADVANTAGES]
    return (adv - adv.mean()) / max(adv.std(), 1e-6)


class _PPOGradShard:
    """One learner-group shard (reference: trainer_runner's RLTrainer
    actor): holds a replica of the policy params + optimizer state on its
    device, computes gradients on its minibatch slice, applies the group's
    averaged gradients. All shards apply IDENTICAL averaged updates, so
    params and optimizer states stay synchronized without a broadcast
    per step."""

    def __init__(self, policy, clip, vf_coeff, ent_coeff, lr, device=None):
        self.device = resolve_device(device)
        # A replica of its own: updates are in place, and a thread actor
        # may be handed the driver's policy object itself.
        self.params = from_jax_params(policy.get_weights(), self.device)
        self._loss_fn = make_ppo_loss(policy, clip, vf_coeff, ent_coeff)
        self._optimizer = optim.adam(lr)
        self.opt_state = init_optimizer(self._optimizer, self.params)

    def compute_gradients(self, mb):
        device_mb = {k: as_tensor(v, self.device) for k, v in mb.items()}
        g, metrics = loss_grads(self._loss_fn, self.params, device_mb)
        return (to_numpy(unflatten(self.params, g)),
                {k: float(v) for k, v in metrics.items()})

    def apply_gradients(self, g):
        grads = named_leaves(from_jax_params(g, self.device))
        self.opt_state = apply_grads(
            self._optimizer, self.params, self.opt_state,
            {n: t.detach() for n, t in grads.items()})
        return True

    def get_params(self):
        return to_numpy(self.params)


class PPO(Algorithm):
    _default_config_class = PPOConfig
    _supports_multi_agent = True

    def _build_update(self, policy, config: PPOConfig):
        """One clipped-surrogate update bound to ``policy``, in place on
        the parameters it is given, and its Adam state on the policy's
        device (multi-agent builds one per policy in the map)."""
        optimizer = optim.adam(config.lr)
        opt_state = init_optimizer(optimizer, policy.params)
        loss_fn = make_ppo_loss(policy, config.clip_param,
                                config.vf_loss_coeff,
                                config.entropy_coeff)

        def update(params, opt_state, mb):
            grads, metrics = loss_grads(loss_fn, params, mb)
            opt_state = apply_grads(optimizer, params, opt_state, grads)
            return params, opt_state, metrics

        return update, opt_state

    def setup(self, config: PPOConfig) -> None:
        self._learner_shards = None
        if self.is_multi_agent:
            self._updates = {}
            self._opt_states = {}
            for pid, policy in self.local_policies.items():
                self._updates[pid], self._opt_states[pid] = \
                    self._build_update(policy, config)
            return
        n = int(getattr(config, "num_learners", 0) or 0)
        if n > 0:
            # Group mode: the shards own the optimizer states; building
            # the solo update too would allocate a dead moment tree and
            # leave self._opt_state silently diverging from the truth.
            self._update_jit = self._opt_state = None
            import ray_tpu_torch
            shard_cls = ray_tpu_torch.remote(_PPOGradShard).options(
                **learner_options(config.device, n))
            self._learner_shards = [
                shard_cls.remote(self.local_policy, config.clip_param,
                                 config.vf_loss_coeff,
                                 config.entropy_coeff, config.lr,
                                 config.device)
                for _ in range(n)]
            return
        self._update_jit, self._opt_state = self._build_update(
            self.local_policy, config)

    def _sgd(self, policy, update_jit, opt_state, batch: SampleBatch,
             config: PPOConfig) -> tuple:
        """Minibatch-SGD a policy on its (GAE-complete) batch; returns
        (opt_state, metrics). With learner_backend set, the fused
        schedule; otherwise one update per minibatch. Both run on the
        policy's device."""
        columns = _sgd_batch(batch, _normalized_advantages(batch))
        backend = getattr(config, "learner_backend", None)
        if not backend:
            sb = SampleBatch(columns)
            params = policy.params
            last_metrics: Dict[str, Any] = {}
            mb_size = min(config.sgd_minibatch_size, len(sb))
            for epoch in range(config.num_sgd_iter):
                for mb in sb.minibatches(mb_size, seed=epoch):
                    device_mb = {k: as_tensor(v, policy.device)
                                 for k, v in mb.items()}
                    params, opt_state, metrics = update_jit(
                        params, opt_state, device_mb)
                    last_metrics = metrics
            policy.params = params
            return opt_state, {k: float(v)
                               for k, v in last_metrics.items()}

        # Fused schedule: each epoch permutes rows and covers floor(n/mb)
        # minibatches (the remainder rotates between epochs through the
        # permutation, matching the reference's drop-to-multiple).
        n = len(batch)
        mb_size = min(config.sgd_minibatch_size, n)
        n_mb = max(n // mb_size, 1)
        rng = np.random.default_rng(self.iteration)
        perm = np.stack([
            rng.permutation(n)[:n_mb * mb_size].reshape(n_mb, mb_size)
            for _ in range(config.num_sgd_iter)]).reshape(-1, mb_size)
        # The batch and the schedule go to the policy's device once; the
        # minibatches are indexed there.
        device_batch = {k: as_tensor(v, policy.device)
                        for k, v in columns.items()}
        rows = torch.from_numpy(perm).to(policy.device)
        params = policy.params
        metrics: Dict[str, Any] = {}
        for idx in rows:
            mb = {k: v[idx] for k, v in device_batch.items()}
            params, opt_state, metrics = update_jit(params, opt_state, mb)
        return opt_state, {k: float(v) for k, v in metrics.items()}

    def _sgd_group(self, batch: SampleBatch, config: PPOConfig) -> dict:
        """Minibatch SGD over the learner group (num_learners > 0):
        every minibatch splits row-wise across the shard actors, their
        gradients average row-weighted (exactly the full-minibatch
        gradient — the PPO loss is mean-based), and every shard applies
        the same averaged update. Reference:
        rllib/core/rl_trainer/trainer_runner.py +
        rllib/execution/multi_gpu_learner_thread.py."""
        import ray_tpu_torch
        sb = SampleBatch(_sgd_batch(batch, _normalized_advantages(batch)))
        shards = self._learner_shards
        mb_size = min(config.sgd_minibatch_size, len(sb))
        last_metrics: Dict[str, Any] = {}
        for epoch in range(config.num_sgd_iter):
            for mb in sb.minibatches(mb_size, seed=epoch):
                size = len(next(iter(mb.values())))
                n = min(len(shards), size)
                bounds = np.array_split(np.arange(size), n)
                slices = [
                    {k: np.asarray(v)[idx[0]:idx[-1] + 1]
                     for k, v in mb.items()} for idx in bounds]
                results = ray_tpu_torch.get([
                    s.compute_gradients.remote(sl)
                    for s, sl in zip(shards, slices)])
                w = np.asarray([len(idx) / size for idx in bounds],
                               np.float64)
                avg = tree_map(
                    lambda *g: np.tensordot(
                        w, np.stack(g), axes=1).astype(
                            np.asarray(g[0]).dtype),
                    *[g for g, _m in results])
                ray_tpu_torch.get([s.apply_gradients.remote(avg)
                                   for s in shards])
                metrics_list = [m for _g, m in results]
                last_metrics = {
                    k: float(np.dot(w, [m[k] for m in metrics_list]))
                    for k in metrics_list[0]}
        # Shard params stay synchronized (identical updates); pull once
        # for the driver's rollout policy.
        self.local_policy.set_weights(
            ray_tpu_torch.get(shards[0].get_params.remote()))
        return last_metrics

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        config: PPOConfig = self.config
        if self.external_input is None:
            weights_ref = ray_tpu_torch.put(self.get_weights())
            self.workers.sync_weights(weights_ref)
            per_worker = max(
                config.train_batch_size // self.workers.num_workers(), 1)
        else:
            per_worker = config.train_batch_size
        batch = self._sample_batch(per_worker)
        self._timesteps_total += len(batch)

        if self.is_multi_agent:
            out: Dict[str, Any] = {}
            for pid, sub in batch.policy_batches.items():
                self._opt_states[pid], metrics = self._sgd(
                    self.local_policies[pid], self._updates[pid],
                    self._opt_states[pid], sub, config)
                for k, v in metrics.items():
                    out[f"{pid}/{k}"] = v
            out["agent_steps_this_iter"] = batch.agent_steps()
            return out
        if self._learner_shards is not None:
            return self._sgd_group(batch, config)
        self._opt_state, metrics = self._sgd(
            self.local_policy, self._update_jit, self._opt_state, batch,
            config)
        return metrics
