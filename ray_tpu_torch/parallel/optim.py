"""optax's rules, as plain functions on tensors.

The counterpart of the optax 0.2.6 transformations that
``ray_tpu/parallel/train_step.py`` builds its optimizers from, with the
same arithmetic: ``chain`` of ``clip_by_global_norm``, ``adamw`` (via
``scale_by_adam``, ``add_decayed_weights``, ``scale_by_learning_rate``)
and ``adafactor`` (``scale_by_factored_rms``, ``clip_by_block_rms``,
``scale_by_param_block_rms``), on ``warmup_cosine_decay_schedule``.

Parameters, gradients and updates are dicts from a parameter's name to
its tensor (``dict(model.named_parameters())``); a state is a dict of
tensors, and a chain's state the tuple of its members' states. Every
step count is a 0-d int32 tensor and every schedule value a 0-d tensor,
so an update never syncs the host.

``update`` works in place: it turns the gradients it is given into the
updates and returns the same dict, and it changes its moments in place.
Each transformation walks the tensors one at a time, so what it
allocates besides the state is one tensor's temporaries, not a second
set of updates.

Block-RMS steps act on whole JAX leaves. The JAX package stacks each
layer's parameter on a leading ``[L, ...]`` axis, so optax takes one RMS
over all layers' ``wq`` together. Here the layers are separate tensors;
``init(params, groups)`` takes the leaves as ``{leaf: [names]}`` (for a
GPT, ``models.gpt.leaf_groups``), and a group of more than one name is
one leaf stacked over layers.

On a mesh the parameters and gradients are DTensors (FSDP2 and tensor
parallelism, ``parallel/sharding.py``). Every transformation then works on
each rank's local blocks, and a quantity of a whole tensor is reduced over
the mesh: the global norm and each leaf's block RMS from the ranks' sums
of squares, each replicated block counted once (:func:`_global_sums`),
and Adafactor's row and column means over the ranks that split the
reduced dim (:func:`_mean`). The factored moments are those of the whole
tensor; each rank keeps its slice of them. On one rank every value is the
one-device value exactly.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.sharding import local

Params = Dict[str, torch.Tensor]
Groups = Dict[str, List[str]]
State = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


class GradientTransformation(NamedTuple):
    """``optax.GradientTransformation``: ``init(params, groups) -> state``
    and ``update(updates, state, params) -> (updates, state)``."""
    init: Callable[[Params, Groups], State]
    update: Callable[[Params, State, Optional[Params]], Tuple[Params, State]]


def _count(params: Params) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """``numerics.safe_increment``: +1, saturating at the int32 maximum."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


def _global_sums(values: List[torch.Tensor],
                 tensors: List[torch.Tensor]) -> torch.Tensor:
    """Stack ``values``, each a rank's sum over its local block of the
    matching tensor, into the sums over the whole tensors: for DTensors
    summed over the mesh, each block counted on the first of the ranks
    that replicate it."""
    sums = torch.stack(values)
    placed = [t for t in tensors if isinstance(t, DTensor)]
    if not placed:
        return sums
    mesh = placed[0].device_mesh
    coord = mesh.get_coordinate()
    first = [all(coord[m] == 0 for m, pl in enumerate(t.placements)
                 if isinstance(pl, Replicate)) for t in tensors]
    sums = sums * torch.tensor(first, dtype=sums.dtype, device=sums.device)
    for dim in range(mesh.ndim):  # over every rank, one axis at a time
        dist.all_reduce(sums, group=mesh.get_group(dim))
    return sums


def _mean(x: torch.Tensor, dim: int, param, param_dim: int,
          keepdim: bool = False) -> torch.Tensor:
    """The mean over ``dim`` of ``x``, a local block whose ``dim`` is
    ``param``'s ``param_dim``: the sum over the ranks that split that dim,
    over its whole size."""
    total = x.sum(dim, keepdim=keepdim)
    if isinstance(param, DTensor):
        mesh = param.device_mesh
        for m, pl in enumerate(param.placements):
            if isinstance(pl, Shard) and pl.dim == param_dim:
                dist.all_reduce(total, group=mesh.get_group(m))
    return total / param.shape[param_dim]


def _groups(params: Params, groups: Groups) -> Groups:
    named = [n for names in groups.values() for n in names]
    if sorted(named) != sorted(params):
        raise ValueError("the leaf groups must name every parameter once")
    return groups


# -- schedules ----------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """Linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (counted from 0, as optax counts)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)
    if cos_steps <= 0:
        raise ValueError("warmup_cosine_decay_schedule needs decay_steps > "
                         f"warmup_steps, got {decay_steps}, {warmup_steps}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        step = count.float()
        if warmup_steps > 0:
            frac = 1 - torch.clamp(step, 0, warmup_steps) / warmup_steps
            warm = (init_value - peak_value) * frac + peak_value
        else:  # optax: a polynomial schedule of no steps is its init value
            warm = torch.full_like(step, init_value)
        t = torch.clamp(step - warmup_steps, max=cos_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / cos_steps))
        decayed = peak_value * ((1 - alpha) * cosine + alpha)
        return torch.where(step < warmup_steps, warm, decayed)

    return schedule


# -- transformations ----------------------------------------------------------

def _empty(params: Params, groups: Groups) -> State:
    return {}


def _leaves(params: Params, groups: Groups) -> State:
    return {"groups": _groups(params, groups)}


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params, groups):
        return tuple(t.init(params, groups) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:
    def update(updates, state, params=None):
        for u in updates.values():
            local(u).mul_(factor)
        return updates, state

    return GradientTransformation(_empty, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale all updates by ``max_norm / ‖u‖`` when their global L2 norm is
    ``max_norm`` or more."""
    def update(updates, state, params=None):
        tensors = list(updates.values())
        # Each tensor's norm as sqrt(Σ x²): in fp32 sqrt(fl(n²)) is n, so
        # off a mesh these are the tensors' norms exactly.
        norms = torch.sqrt(_global_sums(
            [torch.linalg.vector_norm(local(x).float()) ** 2
             for x in tensors], tensors))
        g_norm = torch.linalg.vector_norm(norms)
        keep = g_norm < max_norm
        # optax's where(keep, x, (x / ‖u‖) * max_norm): x / 1 * 1 is x.
        denom = torch.where(keep, torch.ones_like(g_norm), g_norm)
        mult = torch.where(keep, 1.0, max_norm)
        for x in tensors:
            local(x).div_(denom.to(x.dtype)).mul_(mult.to(x.dtype))
        return updates, state

    return GradientTransformation(_empty, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                  ) -> GradientTransformation:
    """Bias-corrected first and second moments; ``m̂ / (√v̂ + eps)``."""
    def init(params, groups):
        return {"count": _count(params),
                "mu": {n: torch.zeros_like(local(p))
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(local(p))
                       for n, p in params.items()}}

    def update(updates, state, params=None):
        count = _increment(state["count"])
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        for n, g in updates.items():
            g = local(g)
            mu, nu = state["mu"][n], state["nu"][n]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            denom = (nu / c2.to(g.dtype)).sqrt_().add_(eps)
            torch.div(mu, c1.to(g.dtype), out=g).div_(denom)
        return updates, {**state, "count": count}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params):
        for n, u in updates.items():
            local(u).add_(weight_decay * local(params[n]))
        return updates, state

    return GradientTransformation(_empty, update)


def scale_by_learning_rate(learning_rate: Schedule, flip_sign: bool = True
                           ) -> GradientTransformation:
    """Multiply by the schedule's value at this transformation's own step
    count, negated when ``flip_sign``."""
    sign = -1.0 if flip_sign else 1.0

    def update(updates, state, params=None):
        step_size = sign * learning_rate(state["count"])
        for u in updates.values():
            local(u).mul_(step_size.to(u.dtype))
        return updates, {"count": _increment(state["count"])}

    return GradientTransformation(lambda p, g: {"count": _count(p)}, update)


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """``optax.adamw``: Adam, then decoupled weight decay on every
    parameter, then the learning rate."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice: the two largest axes (second largest, largest), if
    the second largest has at least ``min_dim_size_to_factor`` entries."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _factor_plan(params: Params, groups: Groups,
                 min_dim_size_to_factor: int):
    """The axes each tensor's second moment is factored over, or None.
    They are chosen on the JAX leaf's shape (with its layer axis, for a
    group of several tensors) and act on each layer's tensor one axis
    lower."""
    plan = {}
    for leaf, names in groups.items():
        stacked = len(names) > 1
        for n in names:
            shape = (len(names),) * stacked + tuple(params[n].shape)
            dims = _factored_dims(shape, min_dim_size_to_factor)
            if dims is not None and stacked:
                if 0 in dims:
                    raise NotImplementedError(
                        f"{leaf}: optax would factor over the layer axis "
                        f"({len(names)} layers)")
                dims = (dims[0] - 1, dims[1] - 1)
            plan[n] = dims
    return plan


def scale_by_factored_rms(decay_rate: float = 0.8,
                          min_dim_size_to_factor: int = 128,
                          eps: float = 1e-30) -> GradientTransformation:
    """Adafactor's rescaling by a factored estimate of the gradient RMS:
    row and column means of g² for tensors with two axes of at least
    ``min_dim_size_to_factor``, else g² itself, decayed at
    ``1 - (count + 1)^-decay_rate``."""
    def init(params, groups):
        plan = _factor_plan(params, _groups(params, groups),
                            min_dim_size_to_factor)
        state = {"count": _count(params), "dims": plan, "v_row": {},
                 "v_col": {}, "v": {}}
        for n, dims in plan.items():
            p = local(params[n])
            if dims is None:
                state["v"][n] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"][n] = torch.zeros_like(p.select(d0, 0))
                state["v_col"][n] = torch.zeros_like(p.select(d1, 0))
        return state

    def update(updates, state, params=None):
        t = (state["count"] + 1).float()
        decay_t = 1.0 - t ** (-decay_rate)
        keep = 1.0 - decay_t
        for n, whole in updates.items():
            g = local(whole)
            grad_sqr = g * g + eps
            dims = state["dims"][n]
            if dims is None:
                v = state["v"][n]
                v.mul_(decay_t).add_(keep * grad_sqr)
                g.mul_(v ** -0.5)
                continue
            d1, d0 = dims
            v_row, v_col = state["v_row"][n], state["v_col"][n]
            v_row.mul_(decay_t).add_(keep * _mean(grad_sqr, d0, whole, d0))
            v_col.mul_(decay_t).add_(keep * _mean(grad_sqr, d1, whole, d1))
            del grad_sqr
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = _mean(v_row, reduced_d1, whole, d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            g.mul_(row_factor.unsqueeze(d0)).mul_(col_factor.unsqueeze(d1))
        return updates, {**state, "count": _increment(state["count"])}

    return GradientTransformation(init, update)


def _block_mean_squares(tensors: Dict[str, torch.Tensor], groups: Groups
                        ) -> Dict[str, torch.Tensor]:
    """Per JAX leaf, the mean of x² over all its tensors together."""
    names = [n for ns in groups.values() for n in ns]
    sq = _global_sums([torch.linalg.vector_norm(local(tensors[n]).float())
                       ** 2 for n in names], [tensors[n] for n in names])
    out, i = {}, 0
    for leaf, ns in groups.items():
        out[leaf] = (sq[i:i + len(ns)].sum()
                     / sum(tensors[n].numel() for n in ns))
        i += len(ns)
    return out


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    """Divide each JAX leaf's updates by ``max(1, rms / threshold)``."""
    def update(updates, state, params=None):
        mean_sq = _block_mean_squares(updates, state["groups"])
        for leaf, names in state["groups"].items():
            rms = torch.sqrt(mean_sq[leaf])
            denom = torch.clamp_min(rms / threshold, 1.0)
            for n in names:
                local(updates[n]).div_(denom.to(updates[n].dtype))
        return updates, state

    return GradientTransformation(_leaves, update)


def scale_by_param_block_rms(min_scale: float = 1e-3
                             ) -> GradientTransformation:
    """Multiply each JAX leaf's updates by its parameters' RMS, floored at
    ``min_scale``."""
    def update(updates, state, params):
        mean_sq = _block_mean_squares(params, state["groups"])
        for leaf, names in state["groups"].items():
            rms = torch.sqrt(mean_sq[leaf])
            factor = torch.where(rms <= min_scale,
                                 torch.full_like(rms, min_scale), rms)
            for n in names:
                local(updates[n]).mul_(factor.to(updates[n].dtype))
        return updates, state

    return GradientTransformation(_leaves, update)


def adafactor(learning_rate: Schedule) -> GradientTransformation:
    """``optax.adafactor`` at its defaults, with ``momentum=None`` (the JAX
    package's ``memory_efficient_optimizer``): factored RMS scaling
    (decay 0.8, eps 1e-30, factoring two axes of at least 128), block-RMS
    clipping at 1.0, the learning rate, scaling by the parameters' block
    RMS, and descent."""
    return chain(scale_by_factored_rms(),
                 clip_by_block_rms(1.0),
                 scale_by_learning_rate(learning_rate, flip_sign=False),
                 scale_by_param_block_rms(),
                 scale(-1))


def apply_updates(params: Params, updates: Params) -> None:
    """``optax.apply_updates``, in place: ``p += u`` (in p's dtype)."""
    with torch.no_grad():
        for n, p in params.items():
            local(p).add_(local(updates[n]).to(p.dtype))


__all__ = ["GradientTransformation", "adafactor", "adamw",
           "add_decayed_weights", "apply_updates", "chain",
           "clip_by_block_rms", "clip_by_global_norm", "scale",
           "scale_by_adam", "scale_by_factored_rms",
           "scale_by_learning_rate", "scale_by_param_block_rms",
           "warmup_cosine_decay_schedule"]
