"""Learner: one gradient engine over an RLModule.

The port of ``ray_tpu/rllib/core/learner.py``: owns the module's
parameters and optimizer state and exposes ``update(batch)``. Subclasses
implement ``compute_loss(params, batch) -> (loss, metrics)``; the base
class takes its gradients with ``torch.autograd.grad`` and steps optax's
``chain(clip_by_global_norm, adam)`` (``parallel/optim.py``).

The learner runs on ``config.device``: the CUDA card unless the config
asks for the CPU. On a mesh (a ``DeviceMesh`` with a ``dp`` axis, the
counterpart of the JAX learner's batch sharded over ``dp``) each rank
holds a replica of the parameters, takes its block of rows of the batch,
and averages its gradients with the other ``dp`` ranks before the
identical update; a batch whose size is not a multiple of ``dp`` drops its
last ``size % dp`` rows, as the JAX learner does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.policy.torch_policy import (as_tensor,
                                                     from_jax_params,
                                                     named_leaves, to_numpy,
                                                     unflatten)


@dataclass
class LearnerConfig:
    lr: float = 5e-4
    grad_clip: float = 40.0
    seed: int = 0
    # PPO-family hyperparameters (used by PPOLearner).
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)
    # Where the learner's tensors live: None is the CUDA card (and raises
    # without one), "cpu" must be asked for by name.
    device: Any = None


def init_optimizer(optimizer: optim.GradientTransformation, params) -> Any:
    """``optimizer.init`` over a parameter tree, each parameter its own
    leaf."""
    named = named_leaves(params)
    return optimizer.init(named, {n: [n] for n in named})


def loss_grads(loss_fn, params, batch) -> Tuple[Dict[str, torch.Tensor],
                                                Dict[str, torch.Tensor]]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: the gradients by
    parameter name (zeros for a parameter the loss does not reach, such
    as the value head under PG's or BC's loss), and the metrics with
    ``total_loss``."""
    named = named_leaves(params)
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["total_loss"] = loss.detach()
    return dict(zip(named, grads)), metrics


def apply_grads(optimizer: optim.GradientTransformation, params, opt_state,
                grads: Dict[str, torch.Tensor]) -> Any:
    """optax's update and ``apply_updates``, in place on ``params``;
    returns the new optimizer state."""
    named = named_leaves(params)
    updates, opt_state = optimizer.update(grads, opt_state, named)
    optim.apply_updates(named, updates)
    return opt_state


class Learner:
    def __init__(self, module_spec: RLModuleSpec,
                 config: Optional[LearnerConfig] = None, mesh=None):
        self.module_spec = module_spec
        self.config = config or LearnerConfig()
        self.module = module_spec.build()
        self._mesh = mesh
        self._built = False

    # -- to be implemented by algorithm learners ------------------------

    def compute_loss(self, params, batch) -> Tuple[Any, Dict[str, Any]]:
        raise NotImplementedError

    # -- engine ----------------------------------------------------------

    def build(self) -> "Learner":
        if self._built:
            return self
        config = self.config
        self.device = resolve_device(config.device)
        self.params = self.module.init(
            torch.Generator().manual_seed(config.seed), self.device)
        self._optimizer = optim.chain(
            optim.clip_by_global_norm(config.grad_clip),
            optim.adam(config.lr))
        self.opt_state = init_optimizer(self._optimizer, self.params)
        self._dp_group = (self._mesh.get_group("dp")
                          if self._mesh is not None else None)
        self._built = True
        return self

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on the learner's device; on a mesh, this ``dp`` rank's
        block of its rows, after dropping a ragged tail."""
        if self._mesh is not None:
            ndp = self._mesh["dp"].size()
            size = len(next(iter(batch.values())))
            if size < ndp:
                raise ValueError(
                    f"Batch of {size} rows cannot be sharded over dp={ndp} "
                    "devices; grow the batch or shrink the mesh")
            # Equal blocks: drop the remainder (< ndp rows) rather than
            # crash on ragged batches.
            self.last_dropped_rows = size % ndp
            per = size // ndp
            lo = self._mesh["dp"].get_local_rank() * per
            batch = {k: v[lo:lo + per] for k, v in batch.items()}
        return {k: as_tensor(v, self.device) for k, v in batch.items()}

    def _grads(self, batch) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
        """The gradients of the loss by parameter name, and the metrics
        with ``total_loss``; on a mesh both averaged over ``dp``."""
        grads, metrics = loss_grads(self.compute_loss, self.params, batch)
        if self._dp_group is not None:
            ndp = dist.get_world_size(self._dp_group)
            for g in grads.values():
                dist.all_reduce(g, group=self._dp_group)
                g.div_(ndp)
            stacked = torch.stack(list(metrics.values()))
            dist.all_reduce(stacked, group=self._dp_group)
            metrics = dict(zip(metrics, stacked / ndp))
        return grads, metrics

    def _apply(self, grads: Dict[str, torch.Tensor]) -> None:
        self.opt_state = apply_grads(self._optimizer, self.params,
                                     self.opt_state, grads)

    def update(self, batch) -> Dict[str, float]:
        """One synchronous gradient step on ``batch`` (split over the
        mesh's dp axis on a mesh)."""
        grads, metrics = self._grads(self._device_batch(batch))
        self._apply(grads)
        return {k: float(v) for k, v in metrics.items()}

    def compute_gradients(self, batch) -> Tuple[Any, Dict[str, float]]:
        """Gradients only, as a numpy tree (remote-learner mode: the group
        averages)."""
        grads, metrics = self._grads(self._device_batch(batch))
        return (to_numpy(unflatten(self.params, grads)),
                {k: float(v) for k, v in metrics.items()})

    def apply_gradients(self, grads) -> None:
        named = named_leaves(from_jax_params(grads, self.device))
        self._apply({n: g.detach() for n, g in named.items()})

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights, self.device)


class PPOLearner(Learner):
    """PPO's clipped-surrogate loss on any RLModule exposing logp /
    values / entropy through forward_train (the new-stack twin of
    algorithms/ppo.py)."""

    def compute_loss(self, params, batch):
        config = self.config
        out = self.module.forward_train(params, batch)
        ratio = torch.exp(out["logp"] - batch["logp_old"])
        adv = batch["advantages"]
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - config.clip_param,
                        1 + config.clip_param) * adv)
        pi_loss = -surrogate.mean()
        vf_loss = ((out["values"] - batch["value_targets"]) ** 2).mean()
        entropy = out["entropy"].mean()
        total = (pi_loss + config.vf_loss_coeff * vf_loss
                 - config.entropy_coeff * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}
