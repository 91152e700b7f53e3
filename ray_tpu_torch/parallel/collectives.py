"""Differentiable collectives over one mesh axis: what ``jax.lax`` gives
the JAX package's ``shard_map`` code, as ``torch.autograd.Function``\\ s
over the axis's process group.

* :func:`ppermute` — ``lax.ppermute`` by a fixed shift around the axis
  (rank i sends to i + shift); its backward is the inverse permutation,
  JAX's transpose of ``ppermute``.
* :func:`all_to_all` — ``lax.all_to_all(x, axis, split_axis, concat_axis,
  tiled=True)``: chunk j of ``split_axis`` goes to rank j, and the chunks
  received are concatenated along ``concat_axis`` in source-rank order;
  its backward swaps the two axes.
* :func:`gather_sum` — all-gather along a dim whose backward is the
  reduce-scatter: each rank's result feeds its own part of a loss summed
  over the ranks (attention over a sequence split over ``sp``).
* :func:`split_replicated`/:func:`gather_replicated` — ``shard_map``'s
  edges for whole tensors that every rank holds alike: take this rank's
  block (backward: all-gather the gradient's blocks), and all-gather the
  blocks (backward: this rank's block of the gradient, since every rank
  computes the same loss from the gathered value and it counts once).

The edges of a region whose ranks each compute a part of a sum (the
experts of an ``ep`` group, the pipeline's masked sum over ``pp``) are
``sharding.to_tp`` (identity forward, all-reduce backward) and
``sharding.from_tp`` (all-reduce forward, identity backward).

An axis is a ``sharding.AxisShard`` (its group, this rank's index, its
size) or None. On None, or on a group of one, every function here is the
identity and sends nothing (``lax.ppermute`` over one device is the
identity; an NCCL send to oneself would hang).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import current_mesh, current_rules
from ray_tpu_torch.parallel.sharding import AxisShard, _alone


def axis_shard(mesh, axis: str) -> Optional[AxisShard]:
    """The mesh axis ``axis`` at this rank, or None when the mesh has no
    such axis or it has one rank."""
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    if axis not in names:
        return None
    # The size from the mesh's shape: slicing the mesh runs tensor ops.
    size = mesh.size(names.index(axis))
    if size == 1:
        return None
    return AxisShard(mesh.get_group(axis), mesh.get_local_rank(axis), size)


def batch_layout(batch_spec
                 ) -> Tuple[Tuple[AxisShard, ...], Optional[AxisShard]]:
    """How the current step's batch lies on the current mesh (both
    registered by ``parallel.mesh.registered_mesh``): (the axes of more
    than one rank its rows and columns are split over, the axis its
    columns — the sequence — are split over or None). ``batch_spec`` is
    the model module's (``rules -> PartitionSpec``): GPT's, Llama's,
    BERT's and T5's put dim 1 on ``rules.sequence``; ViT's and the
    UNet's leave it whole, so they split no sequence and their rows are
    replicated over ``sp``, as GSPMD replicates them. Nothing is split
    when no mesh or no rules are registered."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return (), None
    spec = batch_spec(rules)
    rows = [axis_shard(mesh, a) for a in _spec_axes(spec[0])]
    seq = [axis_shard(mesh, a)
           for a in _spec_axes(spec[1] if len(spec) > 1 else None)]
    if len(seq) > 1:
        raise NotImplementedError(f"sequence rule {rules.sequence!r}: the "
                                  f"port splits the sequence over one axis")
    seq = seq[0] if seq else None
    return tuple(s for s in rows + [seq] if s is not None), seq


def _permute(x: torch.Tensor, shard: AxisShard, shift: int) -> torch.Tensor:
    """Send ``x`` to index + shift, receive from index - shift."""
    x = x.contiguous()
    out = torch.empty_like(x)
    n = shard.size
    peer = lambda i: dist.get_global_rank(shard.group, i % n)
    ops = [dist.P2POp(dist.isend, x, peer(shard.index + shift), shard.group),
           dist.P2POp(dist.irecv, out, peer(shard.index - shift),
                      shard.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, shift):
        ctx.shard, ctx.shift = shard, shift
        return _permute(x, shard, shift)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, ctx.shard, -ctx.shift), None, None


def ppermute(x: torch.Tensor, shard: Optional[AxisShard],
             shift: int) -> torch.Tensor:
    """Each rank sends ``x`` ``shift`` places along the axis and returns
    what the rank ``shift`` places before it sent (``lax.ppermute`` with
    ``perm = [(j, (j + shift) % n)]``)."""
    if _alone(shard) or shift % shard.size == 0:
        return x
    return _PPermute.apply(x, shard, shift)


def _all_to_all(x, shard: AxisShard, split_axis: int, concat_axis: int):
    chunks = [c.contiguous() for c in x.chunk(shard.size, dim=split_axis)]
    out = [torch.empty_like(c) for c in chunks]
    dist.all_to_all(out, chunks, group=shard.group)
    return torch.cat(out, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, split_axis, concat_axis):
        ctx.args = (shard, concat_axis, split_axis)
        return _all_to_all(x, shard, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, shard: Optional[AxisShard], split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``;
    ``x.shape[split_axis]`` must divide over the axis."""
    if _alone(shard):
        return x
    if x.shape[split_axis] % shard.size:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {shard.size} ranks")
    return _AllToAll.apply(x, shard, split_axis, concat_axis)


def _gather(x, shard: AxisShard, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x, group=shard.group)
    return torch.cat(parts, dim=dim)


def _block(x, shard: AxisShard, dim: int) -> torch.Tensor:
    n = x.shape[dim] // shard.size
    return x.narrow(dim, shard.index * n, n)


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return _gather(x, shard, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.shard.group)
        return _block(grad, ctx.shard, ctx.dim).contiguous(), None, None


def gather_sum(x: torch.Tensor, shard: Optional[AxisShard],
               dim: int) -> torch.Tensor:
    """The blocks of dim ``dim`` gathered in rank order; backward, this
    rank's block of the gradient summed over the ranks."""
    return x if _alone(shard) else _GatherSum.apply(x, shard, dim)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return _gather(x, shard, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.shard, ctx.dim), None, None


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return _block(x, shard, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.shard, ctx.dim), None, None


def gather_replicated(x: torch.Tensor, shard: Optional[AxisShard],
                      dim: int) -> torch.Tensor:
    """The blocks of dim ``dim`` gathered in rank order into a value every
    rank holds alike; backward, this rank's block of the gradient."""
    return x if _alone(shard) else _GatherReplicated.apply(x, shard, dim)


def split_replicated(x: torch.Tensor, shard: Optional[AxisShard],
                     dim: int) -> torch.Tensor:
    """This rank's block of dim ``dim`` of a value every rank holds alike
    (the size must divide); backward, the gradient's blocks gathered."""
    if _alone(shard):
        return x
    if x.shape[dim] % shard.size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"evenly over {shard.size} ranks")
    return _SplitReplicated.apply(x, shard, dim)


def _spec_axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_by_spec(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``x`` (held alike by every rank) under a
    PartitionSpec, as ``shard_map``'s ``in_specs`` give it: a dim split
    over a tuple of axes is split row-major, the first axis outermost."""
    for dim, entry in enumerate(spec):
        for axis in _spec_axes(entry):
            x = split_replicated(x, axis_shard(mesh, axis), dim)
    return x


def gather_by_spec(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The inverse of :func:`split_by_spec` (``shard_map``'s
    ``out_specs``): the whole value on every rank."""
    for dim, entry in reversed(list(enumerate(spec))):
        for axis in reversed(_spec_axes(entry)):
            x = gather_replicated(x, axis_shard(mesh, axis), dim)
    return x


__all__ = ["all_to_all", "axis_shard", "batch_layout", "gather_by_spec",
           "gather_replicated", "gather_sum", "ppermute", "split_by_spec",
           "split_replicated"]
