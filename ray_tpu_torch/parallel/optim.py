"""optax's rules, as plain functions on tensors.

The counterpart of the optax 0.2.6 transformations that
``ray_tpu/parallel/train_step.py`` builds its optimizers from, with the
same arithmetic: ``chain`` of ``clip_by_global_norm``, ``adam`` and
``adamw`` (via ``scale_by_adam``, ``add_decayed_weights``,
``scale_by_learning_rate``; RLlib's learners take ``adam``) and
``adafactor`` (``scale_by_factored_rms``, ``clip_by_block_rms``,
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
``init(params, groups)`` takes the leaves as ``{leaf: [names]}`` (a
model's ``leaf_groups``, ``models/_params.py``), and a leaf whose group is
not its own name is stacked over layers.

On a mesh the parameters and gradients are DTensors (FSDP2 and tensor
parallelism, ``parallel/sharding.py``). Every transformation then works on
each rank's local blocks, and a quantity of a whole tensor is reduced over
the mesh: the global norm and each leaf's block RMS from the ranks' sums
of squares, each replicated block counted once (:func:`_global_sums`),
and Adafactor's row and column means over the ranks that split the
reduced dim (:func:`_mean`). The factored moments are those of the whole
tensor; each rank keeps its slice of them. On one rank every value is the
one-device value exactly.

:func:`to_optax_state` and :func:`from_optax_state` carry a state to and
from the layout of optax's own state for the same chain, as the JAX
package's checkpoints hold it: tuples for chains and transformations, each
moment a nested dict of the JAX leaves (``{"layers": {"wq": ...}, "wte":
...}``) with the layers stacked on a leading ``[L, ...]`` axis, and
optax's ``(1,)`` placeholders where Adafactor keeps no moment.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.models._params import nest, stacked
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
    summed over every rank (the mesh spans the process group), each block
    counted on the first of the ranks of its mesh that replicate it, and
    divided by the count of copies of that mesh over the axes it leaves
    out (``sp`` and ``pp``, or ``ep`` for a dense tensor), whose ranks
    hold the same values."""
    sums = torch.stack(values)
    if not any(isinstance(t, DTensor) for t in tensors):
        return sums
    world = dist.get_world_size()
    weights = []
    for t in tensors:
        mesh = t.device_mesh
        coord = mesh.get_coordinate()
        first = all(coord[m] == 0 for m, pl in enumerate(t.placements)
                    if isinstance(pl, Replicate))
        weights.append(first / (world // mesh.size()))
    sums = sums * torch.tensor(weights, dtype=sums.dtype, device=sums.device)
    dist.all_reduce(sums)
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


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam`` at a constant learning rate: Adam, then
    ``scale(-learning_rate)``, as optax builds it for a float."""
    return chain(scale_by_adam(b1, b2, eps), scale(-float(learning_rate)))


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
        layered = stacked(leaf, names)
        for n in names:
            shape = (len(names),) * layered + tuple(params[n].shape)
            dims = _factored_dims(shape, min_dim_size_to_factor)
            if dims is not None and layered:
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


# -- optax's layout ----------------------------------------------------------

@dataclass
class _Leaf:
    """One leaf of optax's state: the port's tensors that hold it (one, or
    one per layer when ``stacked``), or None for optax's ``(1,)``
    placeholder; ``key`` names its JAX leaf (None for a step count) and
    ``drop`` the parameter dim a factored moment reduces."""
    tensors: Optional[List[torch.Tensor]]
    stacked: bool = False
    key: Optional[str] = None
    drop: Optional[int] = None


def _moments(tensors: Params, groups: Groups, drop=None) -> Dict[str, Any]:
    def leaf(key, names):
        have = [tensors[n] for n in names if n in tensors]
        if have and len(have) != len(names):
            raise ValueError(f"{key}: a moment for some of its layers only")
        return _Leaf(have or None, stacked(key, names), key,
                     None if drop is None or not have else drop(names[0]))
    if list(groups) == [""]:
        # The parameters are one bare leaf (RLlib's SAC temperature, ES's
        # flat vector): optax's moment is the leaf itself, not a tree.
        return leaf("", groups[""])
    return nest(groups, leaf)


def _layout(state: State, groups: Groups) -> Any:
    """``state`` in optax's layout, with a :class:`_Leaf` per leaf."""
    if isinstance(state, tuple):
        return tuple(_layout(s, groups) for s in state)
    out = (_Leaf([state["count"]]),) if "count" in state else ()
    if "mu" in state:
        return out + (_moments(state["mu"], groups),
                      _moments(state["nu"], groups))
    if "v_row" in state:
        dims = state["dims"]
        return out + (_moments(state["v_row"], groups, lambda n: dims[n][1]),
                      _moments(state["v_col"], groups, lambda n: dims[n][0]),
                      _moments(state["v"], groups))
    return out


def _map(tree: Any, fn: Callable[[_Leaf], Any]) -> Any:
    if isinstance(tree, _Leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tuple(_map(v, fn) for v in tree)


def _gather(leaf: _Leaf, device) -> torch.Tensor:
    """The leaf's value on ``device`` (None: where its tensors are); a
    stacked leaf is copied into one ``[L, ...]`` tensor there."""
    if leaf.tensors is None:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    first = leaf.tensors[0]
    if not leaf.stacked:
        return first.detach().to(device or first.device)
    out = torch.empty((len(leaf.tensors),) + tuple(first.shape),
                      dtype=first.dtype, device=device or first.device)
    for i, t in enumerate(leaf.tensors):
        out[i].copy_(t.detach())
    return out


def to_jax_tree(tensors: Params, groups: Groups, device=None
                ) -> Dict[str, Any]:
    """``tensors`` (one per parameter name, such as each parameter's local
    block) as the JAX package's nested tree of ``groups``' leaves, layers
    stacked, on ``device`` (None: where the tensors are). An unstacked
    leaf on its own device is the tensor itself, not a copy."""
    return _map(_moments(tensors, groups), lambda leaf: _gather(leaf, device))


def to_optax_state(state: State, groups: Groups, device=None) -> Any:
    """``state`` (a chain's, from ``init(params, groups)``) in the layout
    of optax's state for the same chain, as :func:`to_jax_tree` lays out
    each moment; a count is a 0-d int32 tensor, a placeholder zeros of
    shape ``(1,)``. Holds each rank's own blocks; the plan's ``dims`` are
    not state and are left out, as optax keeps them out."""
    return _map(_layout(state, groups), lambda leaf: _gather(leaf, device))


def optax_state_specs(state: State, groups: Groups,
                      specs: Dict[str, Any]) -> Any:
    """The PartitionSpec of each leaf of :func:`to_optax_state`'s tree,
    given each JAX leaf's parameter spec (``specs[key]``, with the layer
    axis's entry for a stacked leaf): a moment's is its parameter's, a
    factored moment's that less the dim it reduces; counts and
    placeholders are replicated."""
    from ray_tpu_torch.parallel.sharding import PartitionSpec

    def spec(leaf: _Leaf):
        if leaf.key is None or leaf.tensors is None:
            return PartitionSpec()
        parts = list(specs[leaf.key])
        if leaf.drop is not None:  # a short spec leaves the rest None
            del parts[leaf.drop + leaf.stacked:leaf.drop + leaf.stacked + 1]
        return PartitionSpec(*parts)

    return _map(_layout(state, groups), spec)


def _copy_in(leaf: _Leaf, value, where: str) -> None:
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
        value = torch.from_numpy(value if value.flags.writeable
                                 else value.copy())
    if leaf.tensors is None:
        if tuple(value.shape) != (1,):
            raise ValueError(f"{where}: optax keeps a (1,) placeholder "
                             f"here, not {tuple(value.shape)}")
        return
    parts = value.unbind(0) if leaf.stacked else (value,)
    if len(parts) != len(leaf.tensors):
        raise ValueError(f"{where}: {len(parts)} layers for "
                         f"{len(leaf.tensors)}")
    for t, v in zip(leaf.tensors, parts):
        if v.dtype != t.dtype or v.shape != t.shape:
            raise ValueError(
                f"{where}: {v.dtype} {tuple(v.shape)} into {t.dtype} "
                f"{tuple(t.shape)}; nothing is cast or reshaped")
        t.copy_(v)


def _copy_tree(layout: Any, tree: Any, where: str) -> None:
    if isinstance(layout, _Leaf):
        _copy_in(layout, tree, where)
        return
    if isinstance(layout, dict):
        if not isinstance(tree, dict) or set(tree) != set(layout):
            raise ValueError(f"{where}: keys {sorted(tree)} for "
                             f"{sorted(layout)}")
        for k in layout:
            _copy_tree(layout[k], tree[k], f"{where}/{k}")
        return
    if not isinstance(tree, (tuple, list)) or len(tree) != len(layout):
        raise ValueError(f"{where}: {type(tree).__name__} of "
                         f"{len(tree)} for a tuple of {len(layout)}")
    for i, (lay, sub) in enumerate(zip(layout, tree)):
        _copy_tree(lay, sub, f"{where}/{i}")


def from_jax_tree(tree: Dict[str, Any], tensors: Params,
                  groups: Groups) -> None:
    """The inverse of :func:`to_jax_tree`, in place: each leaf of ``tree``
    (numpy arrays or tensors) copied into ``tensors``, layer by layer.
    Shapes and dtypes must match exactly."""
    with torch.no_grad():
        _copy_tree(_moments(tensors, groups), tree, "params")


def from_optax_state(tree: Any, state: State, groups: Groups) -> State:
    """The inverse of :func:`to_optax_state`, in place: ``tree`` (optax's
    layout, numpy arrays or tensors) copied into ``state``, a state of
    the same chain from ``init(params, groups)``, whose tensors keep
    their devices; returns ``state``. Shapes and dtypes must match
    exactly, and each placeholder must be optax's ``(1,)``."""
    with torch.no_grad():
        _copy_tree(_layout(state, groups), tree, "opt_state")
    return state


def apply_updates(params: Params, updates: Params) -> None:
    """``optax.apply_updates``, in place: ``p += u`` (in p's dtype)."""
    with torch.no_grad():
        for n, p in params.items():
            local(p).add_(local(updates[n]).to(p.dtype))


__all__ = ["GradientTransformation", "adafactor", "adam", "adamw",
           "add_decayed_weights", "apply_updates", "chain",
           "clip_by_block_rms", "clip_by_global_norm", "from_jax_tree",
           "from_optax_state", "optax_state_specs", "scale",
           "scale_by_adam", "scale_by_factored_rms",
           "scale_by_learning_rate", "scale_by_param_block_rms",
           "to_jax_tree", "to_optax_state", "warmup_cosine_decay_schedule"]
