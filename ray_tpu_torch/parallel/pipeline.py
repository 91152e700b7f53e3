"""Pipeline parallelism over the ``pp`` mesh axis (GPipe schedule): the
port of ``ray_tpu/parallel/pipeline.py``.

Stage parameters are stacked on a leading axis split over ``pp``; every
rank runs the same tick body, and activations flow from stage to stage
with ``collectives.ppermute``. A microbatch enters stage 0 each tick;
after ``n_micro + n_stages - 1`` ticks every microbatch has left the last
stage. Gradients flow back through ppermute's inverse permutation, so the
backward of a pipelined forward is itself pipelined. Every rank builds the
same graph (the stage's choices are ``torch.where`` on its index, as the
reference's ``jnp.where``), so that each runs the same collectives in the
backward.
"""

from __future__ import annotations

from typing import Callable

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.sharding import PartitionSpec, from_tp


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_param_specs(param_tree, axis: str = "pp"):
    """PartitionSpecs splitting the leading (stage) axis of every leaf."""
    return _tree_map(lambda _: PartitionSpec(axis), param_tree)


def make_pipeline_fn(stage_fn: Callable, n_stages: int, mesh,
                     axis: str = "pp") -> Callable:
    """Build pipelined_apply(stage_params, micro_inputs) -> outputs.

    * ``stage_fn(params_one_stage, x) -> y`` — one stage's computation;
      x and y have the same shape and dtype.
    * ``stage_params`` — a (nested) dict whose leaves have leading dim
      ``n_stages``: DTensors split over ``axis`` (``sharding.shard_tree``
      by :func:`stage_param_specs`), of which each rank takes its own
      block, or whole tensors every rank holds alike (then each rank's
      gradient is the whole one, as ``shard_map``'s).
    * ``micro_inputs`` — ``[n_micro, micro_batch, ...]``, alike on every
      rank.

    Returns ``[n_micro, micro_batch, ...]`` outputs, alike on every rank.
    Differentiable."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.mesh_dim_names}")
    axis_size = mesh[axis].size()
    if axis_size != n_stages:
        raise ValueError(
            f"n_stages={n_stages} must equal the {axis!r} mesh axis size "
            f"({axis_size}); one stage per mesh slice.")

    shard = collectives.axis_shard(mesh, axis)
    stage = 0 if shard is None else shard.index

    def own_block(p):
        from torch.distributed.tensor import DTensor
        block = (p.to_local() if isinstance(p, DTensor) else
                 collectives.split_replicated(p, shard, 0))
        return block[0]

    def pipelined(stage_params, micro_inputs):
        params = _tree_map(own_block, stage_params)
        xs = micro_inputs
        n_micro = xs.shape[0]
        n_ticks = n_micro + n_stages - 1
        first = torch.tensor(stage == 0, device=xs.device)
        last = torch.tensor(stage == n_stages - 1, device=xs.device)
        received = torch.zeros_like(xs[0])
        outputs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
        for t in range(n_ticks):
            # Stage 0 takes microbatch t (a clipped index past the end: its
            # output never reaches the window below); the others what the
            # previous stage sent last tick.
            inp = torch.where(first, xs[min(t, n_micro - 1)], received)
            y = stage_fn(params, inp)
            # The last stage emits microbatch t - (n_stages - 1).
            if t >= n_stages - 1:
                i = t - (n_stages - 1)
                outputs[i] = torch.where(last, y, outputs[i])
            if t + 1 < n_ticks:  # the last tick's send is never read
                received = collectives.ppermute(y, shard, 1)
        # Only the last stage holds the outputs: the masked sum over the
        # axis gives them to every rank.
        return from_tp(torch.stack(outputs), shard)

    return pipelined


def sequential_apply(stage_fn: Callable, stage_params, micro_inputs):
    """The semantics of :func:`make_pipeline_fn` without pipelining: every
    microbatch through the stages in order, each alone (the reference's
    ``vmap``). Tests hold the pipelined schedule to it."""
    leaves = []
    _tree_map(leaves.append, stage_params)
    n_stages = leaves[0].shape[0]

    def apply_all(x):
        for s in range(n_stages):
            x = stage_fn(_tree_map(lambda p: p[s], stage_params), x)
        return x

    return torch.stack([apply_all(x) for x in micro_inputs])


__all__ = ["make_pipeline_fn", "sequential_apply", "stage_param_specs"]
