"""Training step: init and step builders, on one device or over a mesh.

The counterpart of ``ray_tpu/parallel/train_step.py``. Where the JAX
package jits one functional step over a device mesh, the port runs the
step eagerly: the loss and its gradients through autograd
(``models/gpt.py`` ``loss_fn``, whose attention runs K1 forward and K2/K3
backward on the card), then the optimizer's update (``parallel/optim.py``,
optax's arithmetic, which turns the gradients into the updates in place
and groups the layers' tensors into the JAX package's stacked leaves by
``models.gpt.leaf_groups``). The parameters are updated in place, so the
model in ``state["params"]`` is the one the step returns; the JAX step
returns new arrays. Metrics stay 0-d tensors on the device: the step
never waits for the card.

With ``mesh`` and ``rules`` the parameters are placed by
``gpt.param_specs`` (``sharding.shard_model``: DTensor over ``tp``, then
FSDP2 over ``(dp, fsdp)``) and the step always runs that machinery, on a
1-rank mesh too. Every rank passes the same global batch; each keeps its
block of ``B`` by ``gpt.batch_spec``. The loss divides each rank's sum by
the global mask count and is scaled by the count of batch blocks, so the
data ranks' average of gradients (FSDP2's reduction) is the global
batch's gradient; the metrics are the global ones.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.parallel.mesh import (BATCH_AXES, mesh_sizes,
                                         set_current_mesh)
from ray_tpu_torch.parallel.sharding import (ShardingRules, _spec_dim_axes,
                                             average_replicated_grads,
                                             check_mesh, local, shard_slices)

METRICS = ("loss", "accuracy", "perplexity")


def default_optimizer(learning_rate=3e-4, weight_decay=0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10_000
                      ) -> optim.GradientTransformation:
    """Global-norm clip 1.0, then AdamW (b1 0.9, b2 0.95, eps 1e-8) on a
    warm-up-cosine schedule from 0."""
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(schedule, b1=0.9, b2=0.95, eps=1e-8,
                    weight_decay=weight_decay),
    )


def memory_efficient_optimizer(learning_rate=1e-4,
                               warmup_steps: int = 100,
                               total_steps: int = 10_000
                               ) -> optim.GradientTransformation:
    """Global-norm clip 1.0, then Adafactor (factored second moments, no
    first moment) on a warm-up-cosine schedule from 0: the JAX package's
    single-chip recipe for models whose Adam state would not fit."""
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps,
        max(total_steps, warmup_steps + 1))
    return optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adafactor(learning_rate=schedule),
    )


class _Batching:
    """How the step's batch lies on the mesh (``gpt.batch_spec``): its
    rows split into ``blocks`` over the batch axes, and the process groups
    of those axes. No mesh: one block, no groups."""

    def __init__(self, mesh, rules: ShardingRules):
        self.mesh, self.axes, self.groups, self.blocks = mesh, (), (), 1
        if mesh is None:
            return
        check_mesh(mesh)
        self.spec = gpt.batch_spec(rules)
        self.axes = _spec_dim_axes(self.spec[0])
        if any(a not in BATCH_AXES for a in self.axes):
            raise NotImplementedError(
                f"batch rule {rules.batch!r}: the port splits the batch "
                f"over {BATCH_AXES} only")
        self.sizes = mesh_sizes(mesh)
        self.groups = tuple(mesh.get_group(a) for a in self.axes)
        for a in self.axes:
            self.blocks *= self.sizes[a]

    def local(self, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch."""
        if self.mesh is None:
            return batch
        coords = dict(zip(self.mesh.mesh_dim_names,
                          self.mesh.get_coordinate()))
        out = {}
        for k, v in batch.items():
            if v.shape[0] % self.blocks:
                raise ValueError(
                    f"batch[{k!r}] has {v.shape[0]} rows, which do not "
                    f"split evenly over {self.axes} ({self.blocks} blocks)")
            rows = shard_slices(v.shape[:1], self.spec[:1], self.sizes,
                                coords)[0]
            out[k] = v[rows]
        return out


def _rules(mesh, rules) -> Optional[ShardingRules]:
    if mesh is None:
        if rules is not None:
            raise ValueError("sharding rules need a mesh")
        return None
    return rules or ShardingRules()


def _params(model: gpt.GPT) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def init_train_state(cfg: gpt.GPTConfig, mesh=None, rules=None,
                     optimizer: Optional[optim.GradientTransformation] = None,
                     seed: int = 0, device: DeviceLike = None
                     ) -> Dict[str, Any]:
    """{"params": the model, "opt_state": the optimizer's state, "step": a
    0-d int32 tensor}, on ``device`` (the card unless ``"cpu"`` is asked
    for). The weights are drawn from a generator on that device seeded
    with ``seed``; they differ from ``jax.random``'s for the same seed.
    With ``mesh`` the model is placed by ``gpt.param_specs`` of ``rules``
    (default ``ShardingRules()``), holding the same global weights as
    without a mesh, and the optimizer's state is each rank's part."""
    rules = _rules(mesh, rules)
    optimizer = optimizer or default_optimizer()
    dev = resolve_device(device)
    model = gpt.init(cfg, torch.Generator(dev).manual_seed(seed), dev,
                     mesh=mesh, rules=rules)
    return {"params": model,
            "opt_state": optimizer.init(_params(model),
                                        gpt.leaf_groups(model)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _check_model(model: gpt.GPT, cfg: gpt.GPTConfig) -> None:
    if model.cfg != cfg:
        raise ValueError("the step's config differs from the model's "
                         f"({cfg} vs {model.cfg})")


def make_train_step(cfg: gpt.GPTConfig, mesh=None, rules=None,
                    optimizer: Optional[optim.GradientTransformation] = None,
                    accum_steps: int = 1) -> Callable:
    """Returns step(state, batch) -> (state, metrics).

    batch = {"tokens": [B, S] int, "targets": [B, S] int, "mask": optional
    [B, S]}, the global batch on every rank of a mesh. With accum_steps >
    1 the batch is cut into that many microbatches along B; grads and
    metrics are averaged over them, the grads summed in fp32 as the JAX
    package's scan does."""
    rules = _rules(mesh, rules)
    optimizer = optimizer or default_optimizer()
    batching = _Batching(mesh, rules)
    if mesh is not None and cfg.remat and cfg.remat_policy == "selective":
        raise NotImplementedError(
            "remat_policy='selective' hands its block's parameters to "
            "autograd, past FSDP2's gradient reduction; use 'full' on a "
            "mesh")

    def grads_and_metrics(model, params, micro):
        loss, metrics = gpt.loss_fn(model, micro["tokens"], micro["targets"],
                                    micro.get("mask"))
        return torch.autograd.grad(loss, list(params.values())), metrics

    def mesh_grads_and_metrics(model, params, micros):
        # FSDP2 reduces each backward's gradients into the sharded
        # parameters' .grad, summing over microbatches.
        metrics = {k: torch.zeros((), dtype=torch.float32,
                                  device=micros[0]["tokens"].device)
                   for k in METRICS}
        for micro in micros:
            loss, m = gpt.loss_fn(model, micro["tokens"], micro["targets"],
                                  micro.get("mask"),
                                  batch_groups=batching.groups)
            # The data ranks average their gradients, and each block of the
            # batch lies on as many of them: times the count of blocks, the
            # average is the global batch's gradient.
            (loss * batching.blocks).backward()
            metrics = {k: metrics[k] + m[k] for k in METRICS}
        average_replicated_grads(params.values())
        grads = [p.grad for p in params.values()]
        for p in params.values():
            p.grad = None
        return grads, metrics

    def split(batch):
        return [{k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))[i]
                 for k, v in batch.items()} for i in range(accum_steps)]

    def step(state, batch):
        set_current_mesh(mesh)
        model = state["params"]
        _check_model(model, cfg)
        params = _params(model)
        if mesh is not None:
            # Microbatches of the global batch, as the JAX package's scan
            # takes them, each then split over the data ranks.
            grads, metrics = mesh_grads_and_metrics(
                model, params, [batching.local(m) for m in split(batch)])
        elif accum_steps == 1:
            grads, metrics = grads_and_metrics(model, params, batch)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in params.values()]
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=batch["tokens"].device)
                       for k in METRICS}
            for micro in split(batch):
                g, m = grads_and_metrics(model, params, micro)
                for acc, x in zip(grads, g):
                    acc += x
                metrics = {k: metrics[k] + m[k] for k in METRICS}
        if accum_steps > 1:
            for g in grads:
                local(g).div_(accum_steps)
            metrics = {k: v / accum_steps for k, v in metrics.items()}
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                dict(zip(params, grads)), state["opt_state"], params)
            optim.apply_updates(params, updates)
        return ({"params": model, "opt_state": opt_state,
                 "step": state["step"] + 1}, metrics)

    return step


def make_eval_step(cfg: gpt.GPTConfig, mesh=None, rules=None) -> Callable:
    """Returns step(model, batch) -> metrics (the global ones on a mesh),
    with no gradients."""
    batching = _Batching(mesh, _rules(mesh, rules))

    def step(model, batch):
        set_current_mesh(mesh)
        _check_model(model, cfg)
        batch = batching.local(batch)
        with torch.no_grad():
            _, metrics = gpt.loss_fn(model, batch["tokens"],
                                     batch["targets"], batch.get("mask"),
                                     batch_groups=batching.groups)
        if mesh is not None:
            # With no backward to follow, FSDP2 keeps the root gathered.
            model.reshard()
        return metrics

    return step


__all__ = ["default_optimizer", "init_train_state", "make_eval_step",
           "make_train_step", "memory_efficient_optimizer"]
