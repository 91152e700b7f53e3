"""Logical-axis sharding rules → placements: the counterpart of
``ray_tpu/parallel/sharding.py``.

Models annotate each parameter dimension with a *logical* axis name; a
:class:`ShardingRules` table maps logical names to mesh axes, and
``param_specs`` (``models/gpt.py``, ``models/llama.py``) turns the rules
into one :class:`PartitionSpec` per parameter, as in the JAX package. The
port then places a model by those specs (:func:`shard_model`):

* each parameter first becomes a ``DTensor`` over the ``tp`` axis, sharded
  on the dimension its spec puts on ``tp`` (Megatron-style tensor
  parallelism on heads, MLP and vocab), or replicated;
* then FSDP2's ``fully_shard`` shards every block and the root over the
  ``(dp, fsdp)`` sub-mesh, on the dimension the spec puts on ``fsdp``
  (HSDP: replicated over ``dp``, sharded over ``fsdp``).

Each rank's local block of a parameter is then the block that the JAX
``PartitionSpec`` assigns to its mesh position (:func:`shard_slices`).
Inside a module's forward FSDP2 has gathered the ``fsdp`` dimension, and
the model computes on the local ``tp`` blocks (:func:`tp_local`) with the
collectives of :func:`to_tp`, :func:`from_tp` and :func:`gather_tp`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from ray_tpu_torch.parallel.mesh import mesh_sizes

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One mesh-axis entry (``None``, an axis name, or a tuple of names)
    per tensor dimension, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts: MeshAxes):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    """Maps logical dimension names to mesh axes (None = replicated)."""

    batch: MeshAxes = ("dp", "fsdp")
    sequence: MeshAxes = None  # set to "sp" for context parallelism
    embed: MeshAxes = "fsdp"  # weight-sharding axis (ZeRO-3 analog)
    heads: MeshAxes = "tp"
    kv_heads: MeshAxes = "tp"
    head_dim: MeshAxes = None
    mlp: MeshAxes = "tp"
    vocab: MeshAxes = "tp"
    expert: MeshAxes = "ep"
    layers: MeshAxes = None  # leading axis of scan-stacked params

    def spec(self, *logical_axes: Optional[str]) -> PartitionSpec:
        parts = []
        for name in logical_axes:
            if name is None:
                parts.append(None)
            else:
                parts.append(getattr(self, name))
        return PartitionSpec(*parts)


# Rules presets ---------------------------------------------------------

def dp_rules() -> ShardingRules:
    """Pure data parallelism: replicate weights, shard batch."""
    return ShardingRules(embed=None, heads=None, kv_heads=None, mlp=None,
                         vocab=None)


def fsdp_rules() -> ShardingRules:
    """Fully-sharded DP (ZeRO-3): weights sharded over fsdp, no TP."""
    return ShardingRules(heads=None, kv_heads=None, mlp=None, vocab=None)


def tp_fsdp_rules() -> ShardingRules:
    """2D: Megatron TP on heads/mlp/vocab + FSDP on the embed dim."""
    return ShardingRules()


def context_parallel_rules() -> ShardingRules:
    """TP+FSDP+sequence sharding (ring attention over sp)."""
    return ShardingRules(sequence="sp")


# Shard-slice math (checkpoint resharding) ------------------------------
# Pure-index GSPMD block partitioning: given a parameter's global shape,
# a PartitionSpec-like spec, and a mesh described as ordered
# (axis, size) pairs, compute which index block one mesh coordinate
# owns. Balanced ``array_split`` boundaries (first ``S % N`` shards get
# one extra row) so a checkpoint saved on 8 ranks can be resharded onto
# 6 — elastic shrink/grow never requires divisibility.


def axis_split_bounds(dim_size: int, num_shards: int):
    """[(start, stop)] per shard along one dimension, balanced."""
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    base, extra = divmod(dim_size, num_shards)
    bounds = []
    start = 0
    for i in range(num_shards):
        stop = start + base + (1 if i < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def _spec_dim_axes(dim_spec) -> Tuple[str, ...]:
    """Normalize one dimension's spec entry to a tuple of mesh axes."""
    if dim_spec is None:
        return ()
    if isinstance(dim_spec, str):
        return (dim_spec,)
    return tuple(dim_spec)


def shard_slices(global_shape, spec, axes, coords) -> Tuple[slice, ...]:
    """The index block one mesh position owns under ``spec``.

    ``axes`` maps mesh axis name -> size; ``coords`` maps axis name ->
    this position's index on that axis. A dimension sharded over a
    tuple of axes composes them row-major (same ordering GSPMD uses).
    Dimensions with no spec entry (or None) are fully replicated.
    """
    out = []
    for d, size in enumerate(global_shape):
        dim_axes = _spec_dim_axes(spec[d]) if d < len(spec) else ()
        n = 1
        idx = 0
        for name in dim_axes:
            n *= int(axes[name])
            idx = idx * int(axes[name]) + int(coords[name])
        if n <= 1:
            out.append(slice(0, size))
        else:
            start, stop = axis_split_bounds(size, n)[idx]
            out.append(slice(start, stop))
    return tuple(out)


def slices_overlap(a, b):
    """Intersection of two same-rank slice tuples, or None if empty."""
    out = []
    for sa, sb in zip(a, b):
        start = max(sa.start, sb.start)
        stop = min(sa.stop, sb.stop)
        if start >= stop:
            return None
        out.append(slice(start, stop))
    return tuple(out)


# Placement on a mesh ---------------------------------------------------

_WAITS = "ROADMAP.md queue 1, item 8"


def check_mesh(mesh) -> None:
    """The axes the port can run: ``sp``, ``ep`` and ``pp`` of size 1."""
    for axis in ("sp", "ep", "pp"):
        if mesh[axis].size() > 1:
            raise NotImplementedError(
                f"a mesh with {axis}={mesh[axis].size()} (sequence, expert "
                f"and pipeline parallelism) waits for {_WAITS}")


def placements(mesh, spec) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh axis,
    ``Shard(d)`` for the tensor dim ``d`` that it shards, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if axis in _spec_dim_axes(entry)]
        if len(dims) > 1:
            raise ValueError(f"{spec}: mesh axis {axis!r} shards dims "
                             f"{dims}; it may shard one")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def shard_tree(tree, mesh, spec_tree):
    """``distribute_tensor`` every tensor of a (nested) dict by its spec."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: shard_tree(v, mesh, spec_tree[k]) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements(mesh, spec_tree))


def _spec_by_name(model: nn.Module, specs: Dict[str, Any]):
    """(name, spec) of each parameter: a root tensor's spec is
    ``specs[name]``; ``blocks.{i}.{leaf}`` takes ``specs["layers"][leaf]``
    (the JAX leaf's spec without its leading layers entry)."""
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            yield name, specs["layers"][parts[-1]]
        else:
            yield name, specs[name]


def _check_param_spec(name: str, shape, spec, sizes: Dict[str, int]):
    """Which dim goes on ``tp`` and which on ``fsdp`` (or None)."""
    on = {"tp": None, "fsdp": None}
    if len(spec) != len(shape):
        raise ValueError(f"{name}: spec {spec} for a tensor of shape "
                         f"{tuple(shape)}")
    for d, entry in enumerate(spec):
        axes = _spec_dim_axes(entry)
        if len(axes) > 1 or (axes and axes[0] not in on):
            raise NotImplementedError(
                f"{name}: spec {spec}; the port shards a parameter dim over "
                f"one axis, 'fsdp' or 'tp'")
        if axes:
            axis = axes[0]
            if on[axis] is not None:
                raise ValueError(f"{name}: spec {spec} puts two dims on "
                                 f"{axis!r}")
            on[axis] = d
            if shape[d] % sizes[axis]:
                raise ValueError(
                    f"{name}: dim {d} of size {shape[d]} does not divide "
                    f"over {axis}={sizes[axis]}; the port shards evenly "
                    f"(over tp the KV heads too, so that each rank keeps "
                    f"the model's grouping of query heads over KV heads)")
    return on["tp"], on["fsdp"]


def shard_model(model: nn.Module, mesh, specs: Dict[str, Any]) -> nn.Module:
    """Place ``model`` (whose layers are its ``blocks``) on ``mesh`` by
    ``specs`` (its module's ``param_specs``), in place: DTensor over
    ``tp``, then ``fully_shard`` over ``(dp, fsdp)`` per block and on the
    root, which averages the gradients over the data ranks. A parameter
    with no dim on ``fsdp`` while ``fsdp > 1`` (a bias under
    ``fsdp_rules``) stays out of FSDP2, replicated over the data axes, and
    :func:`average_replicated_grads` averages its gradient alike. On a
    model on the meta device nothing is allocated; fill it after
    ``to_empty``. Returns ``model``."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    check_mesh(mesh)
    sizes = mesh_sizes(mesh)
    fsdp_dim, ignored = {}, set()
    for name, spec in list(_spec_by_name(model, specs)):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = getattr(owner, leaf)
        tp_dim, fsdp_d = _check_param_spec(name, p.shape, spec, sizes)
        on_tp = Replicate() if tp_dim is None else Shard(tp_dim)
        if fsdp_d is None and sizes["fsdp"] > 1:
            value = distribute_tensor(p.detach(), mesh["dp", "fsdp", "tp"],
                                      [Replicate(), Replicate(), on_tp])
        else:
            value = distribute_tensor(p.detach(), mesh["tp"], [on_tp])
        placed = nn.Parameter(value, requires_grad=p.requires_grad)
        setattr(owner, leaf, placed)
        if fsdp_d is None and sizes["fsdp"] > 1:
            ignored.add(placed)
        else:
            fsdp_dim[id(placed)] = 0 if fsdp_d is None else fsdp_d

    def placement(param):
        return Shard(fsdp_dim[id(param)])

    data_mesh = mesh["dp", "fsdp"]
    for module in (*model.blocks, model):
        fully_shard(module, mesh=data_mesh, shard_placement_fn=placement,
                    ignored_params=ignored)
    if hasattr(model, "hidden_states"):
        # loss_fn enters the model here, not through forward.
        register_fsdp_forward_method(model, "hidden_states")
    return model


def average_replicated_grads(params) -> None:
    """Average over the data axes the gradients of the parameters that
    :func:`shard_model` left out of FSDP2 (replicated over ``fsdp``), as
    FSDP2 averages the others in the backward."""
    from torch.distributed.tensor import DTensor, Replicate

    for p in params:
        if not isinstance(p, DTensor) or p.grad is None:
            continue
        mesh = p.device_mesh
        names = mesh.mesh_dim_names
        if "fsdp" in names and isinstance(
                p.placements[names.index("fsdp")], Replicate):
            grad = p.grad.to_local()
            for axis in ("dp", "fsdp"):
                dist.all_reduce(grad, group=mesh.get_group(axis))
            grad.div_(mesh["dp"].size() * mesh["fsdp"].size())


def local_block(full: torch.Tensor, param) -> torch.Tensor:
    """The block of ``full`` (the whole value of ``param``) that this rank
    holds of ``param``: ``full`` itself for a plain tensor, else the block
    its placements give (each dim sharded by at most one mesh axis, in
    equal blocks, as :func:`shard_model` places them)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(param, DTensor):
        return full
    mesh = param.device_mesh
    coord = mesh.get_coordinate()
    index = [slice(None)] * full.dim()
    for m, pl in enumerate(param.placements):
        if isinstance(pl, Shard):
            n = full.shape[pl.dim] // mesh.size(m)
            index[pl.dim] = slice(coord[m] * n, (coord[m] + 1) * n)
    return full[tuple(index)]


# Tensor parallelism inside a module ------------------------------------

class TPShard(NamedTuple):
    """How a tensor's dim is split over the ``tp`` axis: the process
    group, this rank's index in it and the number of blocks."""
    group: Any
    index: int
    size: int


def local(param) -> torch.Tensor:
    """``param``'s local block (``param`` itself when it is no DTensor)."""
    from torch.distributed.tensor import DTensor
    return param.to_local() if isinstance(param, DTensor) else param


def tp_local(param) -> Tuple[torch.Tensor, Optional[TPShard]]:
    """(``param``'s block on this rank, how it is split over ``tp`` or
    None when it is not). Inside a forward FSDP2 has gathered the
    parameter, so it is a plain tensor (no mesh) or a DTensor sharded over
    ``tp`` alone; one still sharded over the data axes raises."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(param, DTensor):
        return param, None
    mesh = param.device_mesh
    names = mesh.mesh_dim_names
    if any(isinstance(pl, Shard) for axis, pl in zip(names, param.placements)
           if axis != "tp"):
        raise RuntimeError(
            f"a parameter is still sharded over the data axes ({names}, "
            f"{param.placements}): call the model (or its hidden_states) so "
            f"that FSDP gathers it first")
    pl = param.placements[names.index("tp")]
    if not isinstance(pl, Shard):
        return param.to_local(), None
    return param.to_local(), TPShard(mesh.get_group("tp"),
                                     mesh.get_local_rank("tp"),
                                     mesh.size(names.index("tp")))


class _CopyToTP(torch.autograd.Function):
    """Enter a tensor-parallel region: identity forward, the gradient
    summed over the group backward (each rank saw a part of the uses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """Leave a tensor-parallel region: the partial results summed over
    the group forward, the gradient passed through backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    """The blocks of the last dim gathered in group order forward; this
    rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, shard: TPShard):
        ctx.shard, ctx.width = shard, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        dist.all_gather(parts, x, group=shard.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.shard.index * ctx.width
        return grad[..., start:start + ctx.width], None


def to_tp(x: torch.Tensor, shard: Optional[TPShard]) -> torch.Tensor:
    """``x`` (the same on every rank of the group) entering products
    with blocks split as ``shard``; ``x`` when ``shard`` is None."""
    return x if shard is None else _CopyToTP.apply(x, shard.group)


def from_tp(x: torch.Tensor, shard: Optional[TPShard]) -> torch.Tensor:
    """The sum over the group of the partial results ``x``."""
    return x if shard is None else _ReduceFromTP.apply(x, shard.group)


def gather_tp(x: torch.Tensor, shard: Optional[TPShard]) -> torch.Tensor:
    """The whole last dim of ``x``, whose blocks the group holds."""
    return x if shard is None else _GatherFromTP.apply(x, shard)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (outside autograd)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


__all__ = ["MeshAxes", "PartitionSpec", "ShardingRules", "TPShard",
           "all_reduce", "average_replicated_grads", "axis_split_bounds", "check_mesh",
           "context_parallel_rules", "dp_rules", "from_tp", "fsdp_rules",
           "gather_tp", "local", "local_block", "placements",
           "shard_model", "shard_slices", "shard_tree", "slices_overlap",
           "to_tp", "tp_fsdp_rules", "tp_local"]
