"""Training step: init and step builders for one device.

The counterpart of ``ray_tpu/parallel/train_step.py``. Where the JAX
package jits one functional step over a device mesh, the port runs the
step eagerly on one device: the loss and its gradients through autograd
(``models/gpt.py`` ``loss_fn``, whose attention runs K1 forward and K2/K3
backward on the card), then the optimizer's update (``parallel/optim.py``,
optax's arithmetic, which turns the gradients into the updates in place
and groups the layers' tensors into the JAX package's stacked leaves by
``models.gpt.leaf_groups``). The parameters are updated in place, so the
model in ``state["params"]`` is the one the step returns; the JAX step
returns new arrays. Metrics stay 0-d tensors on the device: the step
never waits for the card.

A mesh or sharding rules belong to the port's FSDP2/DTensor slice
(``ROADMAP.md``, slice 4); until then both must be ``None``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel import optim

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


def _no_mesh(mesh, rules) -> None:
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "a device mesh and sharding rules come with the port's "
            "FSDP2/DTensor slice (ROADMAP.md, slice 4); pass mesh=None and "
            "rules=None for one device")


def _params(model: gpt.GPT) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def init_train_state(cfg: gpt.GPTConfig, mesh=None, rules=None,
                     optimizer: Optional[optim.GradientTransformation] = None,
                     seed: int = 0, device: DeviceLike = None
                     ) -> Dict[str, Any]:
    """{"params": the model, "opt_state": the optimizer's state, "step": a
    0-d int32 tensor}, on ``device`` (the card unless ``"cpu"`` is asked
    for). The weights are drawn from a generator on that device seeded
    with ``seed``; they differ from ``jax.random``'s for the same seed."""
    _no_mesh(mesh, rules)
    optimizer = optimizer or default_optimizer()
    dev = resolve_device(device)
    model = gpt.init(cfg, torch.Generator(dev).manual_seed(seed), dev)
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
    [B, S]}. With accum_steps > 1 the batch is cut into that many
    microbatches along B; grads and metrics are averaged over them, the
    grads summed in fp32 as the JAX package's scan does."""
    _no_mesh(mesh, rules)
    optimizer = optimizer or default_optimizer()

    def grads_and_metrics(model, params, micro):
        loss, metrics = gpt.loss_fn(model, micro["tokens"], micro["targets"],
                                    micro.get("mask"))
        return torch.autograd.grad(loss, list(params.values())), metrics

    def step(state, batch):
        model = state["params"]
        _check_model(model, cfg)
        params = _params(model)
        if accum_steps == 1:
            grads, metrics = grads_and_metrics(model, params, batch)
        else:
            micros = {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))
                      for k, v in batch.items()}
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in params.values()]
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=batch["tokens"].device)
                       for k in METRICS}
            for i in range(accum_steps):
                g, m = grads_and_metrics(
                    model, params, {k: v[i] for k, v in micros.items()})
                for acc, x in zip(grads, g):
                    acc += x
                metrics = {k: metrics[k] + m[k] for k in METRICS}
            for g in grads:
                g /= accum_steps
            metrics = {k: v / accum_steps for k, v in metrics.items()}
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                dict(zip(params, grads)), state["opt_state"], params)
            optim.apply_updates(params, updates)
        return ({"params": model, "opt_state": opt_state,
                 "step": state["step"] + 1}, metrics)

    return step


def make_eval_step(cfg: gpt.GPTConfig, mesh=None, rules=None) -> Callable:
    """Returns step(model, batch) -> metrics, with no gradients."""
    _no_mesh(mesh, rules)

    def step(model, batch):
        _check_model(model, cfg)
        with torch.no_grad():
            _, metrics = gpt.loss_fn(model, batch["tokens"],
                                     batch["targets"], batch.get("mask"))
        return metrics

    return step


__all__ = ["default_optimizer", "init_train_state", "make_eval_step",
           "make_train_step", "memory_efficient_optimizer"]
