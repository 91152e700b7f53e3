"""DDPPO: decentralized distributed PPO.

The port of ``ray_tpu/rllib/algorithms/ddppo.py`` (the reference's
rllib/algorithms/ddppo; Wijmans et al. 2019): sample batches NEVER travel
to the driver. Every rollout worker runs the full PPO minibatch-SGD loop
on its OWN samples, all-reducing gradients with its peers once per
minibatch: the workers form a ``ray_tpu_torch.util.collective`` group and
ring-allreduce the flattened gradient vector as a host numpy array. All
workers start from identical weights and apply identical averaged
gradients with identical optimizer states, so their parameters stay
bit-synchronized without a central learner; the driver only triggers
iterations, aggregates metrics, and mirrors worker 0's weights for
checkpointing and evaluation.

Each worker samples on the CPU (``rollout_backend``) and learns on
``config.device`` (the CUDA card unless the config asks for the CPU): its
learner copy of the parameters and its Adam state live there, and the
workers lease an equal share of the cluster's cards
(``learner_group.learner_options``). The flat vector lays the gradient's
leaves out in ``jax.tree.flatten``'s order (dict keys sorted), so the
vector means the same thing in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.learner_state import flat_leaves
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig, make_ppo_loss
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.core.learner_group import learner_options
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.evaluation.worker_set import WorkerSet
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import (as_tensor,
                                                     from_jax_params,
                                                     named_leaves, to_numpy,
                                                     unflatten)


class DDPPOConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DDPPO)
        self.num_rollout_workers = 2
        #: steps EACH worker samples and learns on per iteration (there is
        #: no central batch: train_batch_size is ignored by design).
        self.steps_per_worker = 256

    def training(self, *, steps_per_worker=None,
                 **kwargs) -> "DDPPOConfig":
        super().training(**kwargs)
        if steps_per_worker is not None:
            self.steps_per_worker = steps_per_worker
        return self


def _flat(grads):
    """A tree of tensors as one vector, its leaves in ``jax.tree.flatten``'s
    order; returns (vector, the leaves' shapes, the tree as a template)."""
    leaves = flat_leaves(grads)
    return (torch.cat([torch.ravel(g) for g in leaves]),
            [tuple(g.shape) for g in leaves], grads)


def _rebuild(template, leaves):
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _unflat(vec, shapes, template):
    """:func:`_flat`'s inverse: the vector's pieces as a tree laid out as
    ``template``."""
    out, off = [], 0
    for shp in shapes:
        n = int(np.prod(shp)) if shp else 1
        out.append(torch.reshape(vec[off:off + n], shp))
        off += n
    return _rebuild(template, iter(out))


def _worker_learn(worker, cfg: Dict[str, Any], iteration: int,
                  batch: Optional[SampleBatch] = None):
    """Runs ON each rollout worker (via worker.apply): sample locally (or
    learn on ``batch``), PPO-SGD on ``cfg["device"]``, ring-allreduce the
    gradients per minibatch on the host. Every worker must call this the
    same number of times with the same cfg: the allreduces are
    collective."""
    from ray_tpu_torch.util import collective

    policy = worker.policy
    state = getattr(worker, "_ddppo", None)
    if state is None or state.get("reset_epoch") != cfg["reset_epoch"]:
        # reset_epoch bumps when the driver re-broadcast weights
        # (restore/set_weights): fresh params need a fresh optimizer
        # state on every worker, identically.
        device = resolve_device(cfg["device"])
        params = from_jax_params(policy.get_weights(), device)
        optimizer = optim.adam(cfg["lr"])
        state = {
            "device": device, "params": params, "optimizer": optimizer,
            "opt_state": init_optimizer(optimizer, params),
            "loss_fn": make_ppo_loss(policy, cfg["clip_param"],
                                     cfg["vf_loss_coeff"],
                                     cfg["entropy_coeff"]),
            "reset_epoch": cfg["reset_epoch"],
        }
        worker._ddppo = state

    if batch is None:
        batch = worker.sample(cfg["steps_per_worker"])
    adv = np.asarray(batch[SampleBatch.ADVANTAGES], np.float32)
    adv = (adv - adv.mean()) / max(adv.std(), 1e-6)
    sb = SampleBatch({
        "obs": np.asarray(batch[SampleBatch.OBS], np.float32),
        "actions": np.asarray(batch[SampleBatch.ACTIONS]),
        "old_logp": np.asarray(batch[SampleBatch.ACTION_LOGP],
                               np.float32),
        "advantages": adv,
        "value_targets": np.asarray(batch[SampleBatch.VALUE_TARGETS],
                                    np.float32),
    })
    device, params = state["device"], state["params"]
    mb_size = min(cfg["sgd_minibatch_size"], len(sb))
    last_loss = 0.0
    for epoch in range(cfg["num_sgd_iter"]):
        # Same seed on every worker -> same MINIBATCH COUNT and order
        # of collective calls (contents differ: local data).
        for mb in sb.minibatches(mb_size, seed=1000 * iteration + epoch):
            device_mb = {k: as_tensor(v, device) for k, v in mb.items()}
            grads, metrics = loss_grads(state["loss_fn"], params,
                                        device_mb)
            vec, shapes, template = _flat(unflatten(params, grads))
            # DDPPO's core move: gradients average ACROSS workers here;
            # no sample or gradient ever reaches the driver.
            total = collective.allreduce(vec.cpu().numpy(), op="sum",
                                         group_name=cfg["group_name"])
            avg = total / cfg["world_size"]
            state["opt_state"] = apply_grads(
                state["optimizer"], params, state["opt_state"],
                named_leaves(_unflat(torch.from_numpy(avg).to(device),
                                     shapes, template)))
            last_loss = float(metrics["total_loss"])
    # The sampler's copy (on the rollout device) takes the new weights.
    policy.set_weights(to_numpy(params))
    # Episode stats flow through WorkerSet.episode_stats (Algorithm
    # .train): only scalars travel back here.
    return {"steps": len(sb), "loss": last_loss}


class _LeasedWorkerSet(WorkerSet):
    """The rollout workers, each with ``options`` (a share of a card when
    the workers learn there)."""

    def __init__(self, env_creator, policy_config, num_workers: int,
                 seed: int, num_cpus_per_worker: float,
                 options: Dict[str, Any]):
        self.is_multi_agent = False
        policy_config = dict(policy_config, num_workers=num_workers)
        cls = ray_tpu_torch.remote(RolloutWorker)
        self._workers = [
            cls.options(num_cpus=num_cpus_per_worker, **options).remote(
                env_creator, policy_config, worker_index=i + 1, seed=seed)
            for i in range(num_workers)]


class DDPPO(PPO):
    _default_config_class = DDPPOConfig
    _supports_multi_agent = False
    # The driver's WorkerSet stays empty; setup starts the leased one.
    _own_rollout_actors = True
    # The learner state is the weights the workers start from (each
    # worker's Adam state is rebuilt on every broadcast, as in the JAX
    # package); loading marks them for the next broadcast.
    _learner_trees = ()
    _learner_opts: Dict[str, Any] = {}
    _learner_values = ()

    def setup(self, config: DDPPOConfig) -> None:
        if config.num_rollout_workers < 2:
            raise ValueError(
                "DDPPO is decentralized across workers: set "
                ".rollouts(num_rollout_workers=2) or more")
        from ray_tpu_torch.util import collective
        n = config.num_rollout_workers
        self.workers = _LeasedWorkerSet(
            self._env_creator, config.policy_config(), n, config.seed,
            config.num_cpus_per_worker, learner_options(config.device, n))
        # No central learner state (PPO.setup would build one); workers
        # bit-synchronize by averaging gradients, starting from the
        # driver's initial weights.
        self._group_name = f"ddppo-{id(self):x}"
        workers = self.workers.remote_workers
        collective.create_collective_group(
            workers, len(workers), list(range(len(workers))),
            group_name=self._group_name)
        #: bumps whenever driver weights must overwrite the workers'
        #: (initial broadcast, restore(), set_weights()) — workers
        #: rebuild their optimizer state when they see a new epoch.
        self._reset_epoch = 0
        self._weights_dirty = True

    def set_weights(self, weights) -> None:
        """Driver-side weight injection (restore(), manual set) must
        reach the decentralized learners — mark for re-broadcast; the
        next training_step ships them before learning."""
        super().set_weights(weights)
        self._weights_dirty = True

    def _after_load(self) -> None:
        self._weights_dirty = True

    def learn_on_batches(self, batches: Optional[List[SampleBatch]] = None
                         ) -> Dict[str, Any]:
        """One iteration of the decentralized learners: each worker
        learns on its own samples, or on its batch of ``batches`` (one
        GAE-complete batch per worker); then the driver mirrors worker
        0's weights."""
        config: DDPPOConfig = self.config
        if self._weights_dirty:
            self._reset_epoch += 1
            self._weights_dirty = False
            weights_ref = ray_tpu_torch.put(self.get_weights())
            self.workers.sync_weights(weights_ref)
        cfg = {
            "lr": config.lr,
            "clip_param": config.clip_param,
            "vf_loss_coeff": config.vf_loss_coeff,
            "entropy_coeff": config.entropy_coeff,
            "num_sgd_iter": config.num_sgd_iter,
            "sgd_minibatch_size": config.sgd_minibatch_size,
            "steps_per_worker": config.steps_per_worker,
            "group_name": self._group_name,
            "world_size": self.workers.num_workers(),
            "reset_epoch": self._reset_epoch,
            "device": config.device,
        }
        workers = self.workers.remote_workers
        results = ray_tpu_torch.get(
            [w.apply.remote(_worker_learn, cfg, self.iteration,
                            None if batches is None else batches[i])
             for i, w in enumerate(workers)])
        self._timesteps_total += sum(r["steps"] for r in results)
        # Workers stay bit-identical; mirror worker 0 for save/evaluate.
        self.local_policy.set_weights(
            ray_tpu_torch.get(workers[0].get_weights.remote()))
        return {"loss": float(np.mean([r["loss"] for r in results])),
                "steps_this_iter": sum(r["steps"] for r in results)}

    def training_step(self) -> Dict[str, Any]:
        return self.learn_on_batches()
