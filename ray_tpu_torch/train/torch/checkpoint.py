"""Sharded checkpoints of the port's train state, in the JAX package's format.

The rank-level half of ``ray_tpu/air/session.py``'s ``report_sharded``,
and the restore that places the blocks again. The port's state is
``{"params": model, "opt_state": state, "step": tensor}`` (``parallel.
train_step.init_train_state``'s, or one built alike for any model of
``ray_tpu_torch.models``: Llama, the UNet, ViT, BERT, T5); on disk it is
the JAX package's ``{"params", "opt_state", "step"}`` tree: parameters
nested as ``to_jax_params`` nests them, layers stacked on a leading
``[L, ...]`` axis (each of T5's two stacks), the optimizer's state in
optax's layout
(``parallel.optim.to_optax_state``), and the step an int32 scalar. So a
run either package saved, the other resumes.

**Save**: each rank lays out its own blocks (``to_local()``, never the
whole tensor) with their JAX specs and the mesh's axes in ``AXIS_ORDER``
(:func:`_layout`), by one of two routes:

- inside a trainer's loop, ``session.report_sharded(metrics, state)``
  (:func:`rank_blocks`, which this module sets as the session's layout
  of a state of tensors), as in the JAX package: every rank writes its
  shard, the record rides the result channel, and the trainer's executor
  commits the manifest once every rank acked;
- outside a trainer, :func:`save_train_state` on every rank: a replica
  over ``dp``, ``sp`` or ``pp`` leaves its shard to its twin at index 0,
  which holds the same blocks, the records go to rank 0 over the process
  group, and rank 0 commits the manifest, which lists a shard for every
  rank, through its ``CheckpointManager``.

Either commits only when every write succeeded.

**Restore** (:func:`restore_train_state`): where the saved specs and axis
names are the state's own, each rank reads only the byte ranges of its
blocks (``ShardedCheckpoint.load_for_rank``, which also reshards onto
other axis sizes); otherwise every rank reads the whole tree and takes
its blocks under the new specs (``ShardedCheckpoint.restore_on_mesh``).
Values are copied into the existing parameters in place, so FSDP2's
references to them stay valid.

Every saved leaf is float32 or int32, as the JAX package's state is;
numpy has no bfloat16, and nothing is cast.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._private import builtin_metrics, spill
from ray_tpu_torch.air import session
from ray_tpu_torch.models._params import (jax_specs, leaf_groups,
                                          specs_by_leaf, stacked)
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, current_mesh,
                                         current_rules, mesh_sizes)
from ray_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                             local, shard_slices)
from ray_tpu_torch.train._internal import sharded_checkpoint as sc
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager

logger = logging.getLogger("ray_tpu_torch.train")

SAVED_DTYPES = (torch.float32, torch.int32)
# Rules that shard nothing: the specs of a state on no mesh.
_UNSHARDED = ShardingRules(batch=None, embed=None, heads=None, kv_heads=None,
                           mlp=None, vocab=None, expert=None)


def _model_module(model):
    """The module of ``ray_tpu_torch.models`` that defines ``model``'s
    class (``gpt`` for a GPT, ``t5`` for a T5, ...)."""
    from ray_tpu_torch.models import bert, diffusion, gpt, llama, t5, vit
    for module, cls in ((gpt, gpt.GPT), (llama, llama.Llama),
                        (diffusion, diffusion.UNet), (vit, vit.ViT),
                        (bert, bert.Bert), (t5, t5.T5)):
        if isinstance(model, cls):
            return module
    raise TypeError(f"a train state of {type(model).__name__}: the port "
                    f"saves GPT, Llama, UNet, ViT, Bert and T5 models")


def _rank_world() -> Tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _axes(mesh) -> List[Tuple[str, int]]:
    """The mesh's axes in ``AXIS_ORDER`` with their sizes (all 1 without
    a mesh), checked against the rank's own coordinates."""
    if mesh is None:
        if _rank_world()[1] > 1:
            raise ValueError("a state of several ranks needs its mesh")
        return [(a, 1) for a in AXIS_ORDER]
    axes = list(mesh_sizes(mesh).items())
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    if sc.rank_coords(_rank_world()[0], axes) != coords:
        raise ValueError(f"rank {_rank_world()[0]} is at {coords} of the "
                         f"mesh, not row-major over {axes}")
    return axes


def _specs(model, mesh, rules):
    """(the JAX package's nested spec tree of the model's parameters, each
    ``leaf_groups`` key's spec): a stacked leaf's spec has the layer
    axis's None first; without a mesh nothing is sharded."""
    rules = (rules or ShardingRules()) if mesh is not None else _UNSHARDED
    specs = _model_module(model).param_specs(model.cfg, rules)
    return jax_specs(model, specs), specs_by_leaf(model, specs)


def _trees(state, mesh, rules, device):
    """(the state's blocks in the JAX layout on ``device``, their specs in
    the same structure)."""
    model = state["params"]
    groups = leaf_groups(model)
    param_specs, specs = _specs(model, mesh, rules)
    blocks = {"params": optim.to_jax_tree(
                  {n: local(p) for n, p in model.named_parameters()},
                  groups, device),
              "opt_state": optim.to_optax_state(state["opt_state"], groups,
                                                device),
              "step": state["step"].detach().to(device)}
    spec_tree = {"params": param_specs,
                 "opt_state": optim.optax_state_specs(state["opt_state"],
                                                      groups, specs),
                 "step": PartitionSpec()}
    return blocks, spec_tree


def _check_blocks(flat, specs, axes, rank, model) -> Dict[str, Tuple]:
    """Each leaf's whole shape; raises on a dtype other than float32 or
    int32, or a block that is not ``shard_slices``' block of it (a padded
    shard must never reach the file)."""
    sizes, coords = dict(axes), sc.rank_coords(rank, axes)
    named = dict(model.named_parameters())
    params = {}  # each JAX leaf's whole shape, by its path in the tree
    for key, names in leaf_groups(model).items():
        shape = tuple(named[names[0]].shape)
        params[key.replace(".", "/")] = ((len(names),) + shape
                                         if stacked(key, names) else shape)
    shapes = {}
    for path, block in flat.items():
        if block.dtype not in SAVED_DTYPES:
            raise TypeError(f"{path} is {block.dtype}; a checkpoint holds "
                            f"float32 and int32 leaves only")
        spec = specs[path]
        shape = tuple(int(n) * int(np.prod([sizes[a] for a in axes_d]))
                      for n, axes_d in zip(block.shape, spec))
        leaf = path.partition("/")[2]
        if path.startswith("params/") and leaf in params:
            shape = params[leaf]
        want = tuple(s.stop - s.start
                     for s in shard_slices(shape, spec, sizes, coords))
        if tuple(block.shape) != want:
            raise ValueError(f"{path}: this rank holds {tuple(block.shape)}, "
                             f"not the block {want} of {shape} under {spec}")
        shapes[path] = shape
    return shapes


def _layout(state, mesh, rules, rank: int):
    """``rank``'s blocks of ``state`` in the JAX package's tree, on the
    host: (its blocks by path as numpy arrays, their specs in
    ``normalize_spec``'s form, the tree's structure, each leaf's whole
    shape, the mesh's axes). The one layout of both saves,
    :func:`save_train_state` and ``session.report_sharded``."""
    axes = _axes(mesh)
    blocks, spec_tree = _trees(state, mesh, rules, "cpu")
    flat, structure = sc.flatten_tree(blocks)
    specs = {p: sc.normalize_spec(s, flat[p].dim())
             for p, s in sc.flatten_like(structure, spec_tree).items()}
    shapes = _check_blocks(flat, specs, axes, rank, state["params"])
    return ({p: t.numpy() for p, t in flat.items()}, specs, structure,
            shapes, axes)


def _stand_ins(shapes, dtypes) -> Dict[str, np.ndarray]:
    """Zero-stride stand-ins of the whole leaves: ``build_tree_meta`` reads
    each leaf's shape and dtype only."""
    return {p: np.broadcast_to(np.zeros((), dtypes[p]), shapes[p])
            for p in shapes}


def rank_blocks(state: Any, rank: int, world: int):
    """What ``session.report_sharded`` writes of the port's train state
    on rank ``rank`` of a gang of ``world`` (None for a state that is not
    one): (the rank's blocks by path, stand-ins of the whole leaves for
    ``build_tree_meta``, the tree's structure, the specs, the mesh's
    axes). The mesh and rules are the current ones
    (``parallel.mesh.registered_mesh``); with none the state lies whole
    on one process. The gang's ranks are those of the process group."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(state, dict)
            and isinstance(state.get("params"), torch.nn.Module)):
        return None
    mesh, rules = current_mesh(), current_rules()
    if mesh is None and any(isinstance(p, DTensor)
                            for p in state["params"].parameters()):
        raise ValueError(
            "this state is placed on a mesh: report it inside "
            "parallel.mesh.registered_mesh(mesh, rules)")
    if _rank_world() != (rank, world):
        raise ValueError(
            f"rank {rank} of a gang of {world} is rank "
            f"{_rank_world()[0]} of {_rank_world()[1]} of its process "
            f"group; a train state is reported by a gang whose ranks are "
            f"the group's")
    local, specs, structure, shapes, axes = _layout(state, mesh, rules, rank)
    whole = _stand_ins(shapes, {p: a.dtype for p, a in local.items()})
    return local, whole, structure, specs, axes


session.set_state_layout(rank_blocks)


def _writer(rank: int, axes, specs) -> int:
    """The rank that writes ``rank``'s shard: the one at index 0 of every
    axis that no leaf's spec in ``specs`` (``normalize_spec``'s) names, a
    replica axis (``dp``, ``sp`` and ``pp`` as the port places parameters
    and so their optimizer state), and at ``rank``'s index of the others.
    Its blocks are ``rank``'s, so each is written once, not once per
    replica."""
    named = {a for spec in specs.values() for dim in spec for a in dim}
    coords = sc.rank_coords(rank, axes)
    writer = 0
    for axis, size in axes:
        writer = writer * size + (coords[axis] if axis in named else 0)
    return writer


def save_train_state(state: Dict[str, Any],
                     manager: Optional[CheckpointManager] = None,
                     mesh=None, rules: Optional[ShardingRules] = None,
                     extra: Optional[Dict[str, Any]] = None,
                     metrics: Optional[Dict[str, Any]] = None):
    """Save ``state`` as a sharded checkpoint of ``manager``'s run; every
    rank of the mesh calls this. ``manager`` is rank 0's (the other ranks
    may pass None): it picks the seq and commits. ``mesh`` and ``rules``
    are those the state was built with (None: one process, nothing
    sharded). Returns the committed ``ShardedCheckpoint`` on every rank,
    or None on every rank when a shard write failed (nothing is
    committed, and the previous checkpoint stands)."""
    rank, world = _rank_world()
    if rank == 0 and manager is None:
        raise ValueError("rank 0 commits the save: pass its CheckpointManager")
    t0 = time.perf_counter()
    flat, specs, structure, shapes, axes = _layout(state, mesh, rules, rank)
    ctx = [None if manager is None else
           {"run": manager.run_name, "uri": manager.base_uri,
            "seq": manager.next_seq_base()}]
    if world > 1:
        dist.broadcast_object_list(ctx, src=0)
    run, seq = ctx[0]["run"], ctx[0]["seq"]
    backend = (manager._backend if rank == 0
               else spill.backend_for_uri(ctx[0]["uri"]))
    writer = _writer(rank, axes, specs)
    try:
        if writer != rank:
            record = {"seq": seq, "rank": rank, "written_by": writer}
        else:
            record = sc.write_shard(backend, run, seq, rank, flat)
            # The rank's whole share: the layout on the host and the write.
            record["write_s"] = time.perf_counter() - t0
    except spill.SpillFailure as exc:
        record = {"seq": seq, "rank": rank, "error": str(exc)}
    del flat
    records = [record]
    if world > 1:
        records = [None] * world if rank == 0 else None
        dist.gather_object(record, records, dst=0)
    result = [None]
    if rank == 0:
        result[0] = _commit(manager, seq, records, shapes, specs, structure,
                            axes, extra, metrics)
    if world > 1:
        dist.broadcast_object_list(result, src=0)
    if result[0] is None:
        return None
    return sc.ShardedCheckpoint.from_manifest_uri(result[0])


def _commit(manager, seq, records, shapes, specs, structure, axes, extra,
            metrics) -> Optional[str]:
    """Phase two on rank 0: the manifest iff every rank's shard was
    written; returns its URI or None. A rank whose shard another wrote
    (:func:`_writer`) is listed with that shard's file and blocks, so the
    manifest names a shard for every rank, as the JAX package's does."""
    errors = {r["rank"]: r["error"] for r in records if "error" in r}
    if errors:
        logger.warning("sharded save seq=%d not committed: shard write "
                       "failed on rank(s) %s: %s", seq, sorted(errors),
                       next(iter(errors.values())))
        builtin_metrics.train_checkpoint_persist_failures().inc()
        return None
    records = [dict(records[r["written_by"]], rank=r["rank"])
               if "written_by" in r else r for r in records]
    dtypes = {p: np.dtype(b["dtype"])
              for p, b in records[0]["blocks"].items()}
    meta = sc.build_tree_meta(_stand_ins(shapes, dtypes), structure, specs,
                              axes, extra)
    t0 = time.perf_counter()
    handle = manager.register_sharded(seq, meta, records, metrics)
    if handle is None:
        return None
    builtin_metrics.train_ckpt_save_seconds().observe(
        max(r["write_s"] for r in records) + time.perf_counter() - t0)
    return handle.uri


def latest_checkpoint(manager: Optional[CheckpointManager] = None):
    """Rank 0's ``manager.latest()``, on every rank (the others may pass
    None): the newest committed ``ShardedCheckpoint``, or None."""
    rank, world = _rank_world()
    found = [None]
    if rank == 0:
        handle = manager.latest()
        found[0] = None if handle is None else (
            handle.uri, isinstance(handle, sc.ShardedCheckpoint))
    if world > 1:
        dist.broadcast_object_list(found, src=0)
    if found[0] is None:
        return None
    uri, sharded = found[0]
    if not sharded:
        raise ValueError(f"the latest checkpoint, {uri}, is not sharded")
    return sc.ShardedCheckpoint.from_manifest_uri(uri)


def restore_route(checkpoint, state, mesh=None,
                  rules: Optional[ShardingRules] = None) -> str:
    """How :func:`restore_train_state` reads ``checkpoint`` into
    ``state``: ``"load_full"`` without a mesh, ``"load_for_rank"`` where
    the saved specs and axis names are the state's, else
    ``"restore_on_mesh"``."""
    if mesh is None:
        return "load_full"
    manifest = checkpoint.manifest
    meta, spec_tree = _trees(state, mesh, rules, "meta")
    flat, structure = sc.flatten_tree(meta)
    if structure != manifest["structure"]:
        raise ValueError("the checkpoint's tree is not this state's (another "
                         "model or optimizer)")
    specs = sc.flatten_like(structure, spec_tree)
    same = ([n for n, _ in checkpoint.mesh_axes] == list(mesh.mesh_dim_names)
            and all(sc.normalize_spec(specs[p], flat[p].dim())
                    == manifest["specs"][p] for p in flat))
    return "load_for_rank" if same else "restore_on_mesh"


def _params_into(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy ``params`` (the JAX package's tree of the model's parameters,
    each rank's own blocks) into ``model``'s parameters in place."""
    optim.from_jax_tree(params,
                        {n: local(p) for n, p in model.named_parameters()},
                        leaf_groups(model))
    return model


def restore_params(model: torch.nn.Module, checkpoint,
                   verify: Optional[bool] = None) -> torch.nn.Module:
    """Copy the parameters of ``checkpoint``'s train state (a
    ``ShardedCheckpoint``) into ``model``, a model on no mesh of the saved
    config, in place, and return it. Only the parameters are placed: the
    optimizer's state and the step are read and dropped, so a state of any
    optimizer serves."""
    return _params_into(model, checkpoint.load_full(verify)["params"])


def restore_train_state(state: Dict[str, Any], checkpoint, mesh=None,
                        rules: Optional[ShardingRules] = None,
                        verify: Optional[bool] = None) -> Dict[str, Any]:
    """Copy ``checkpoint`` (a ``ShardedCheckpoint``, on every rank) into
    ``state`` in place: its parameters, the optimizer's state and the
    step. ``state`` is built with ``mesh`` and ``rules`` (of any size: a
    checkpoint of 8 ranks restores onto 4) for the same model and
    optimizer; its values are overwritten. Returns the state with the
    saved step."""
    route = restore_route(checkpoint, state, mesh, rules)
    if route == "load_full":
        tree = checkpoint.load_full(verify)
    elif route == "load_for_rank":
        tree = checkpoint.load_for_rank(_rank_world()[0],
                                        axes_items=_axes(mesh),
                                        verify=verify)
    else:
        _, spec_tree = _trees(state, mesh, rules, "meta")
        placed = checkpoint.restore_on_mesh(mesh, spec_tree=spec_tree)
        flat, structure = sc.flatten_tree(placed)
        tree = sc.unflatten_tree(structure, {p: t.to_local()
                                             for p, t in flat.items()})
    model = _params_into(state["params"], tree["params"])
    optim.from_optax_state(tree["opt_state"], state["opt_state"],
                           leaf_groups(model))
    step = tree["step"]
    if not isinstance(step, torch.Tensor):
        step = torch.from_numpy(np.array(step))
    if step.dtype != torch.int32 or step.dim() != 0:
        raise ValueError(f"step is {step.dtype} of shape {tuple(step.shape)}, "
                         f"not an int32 scalar")
    return {"params": model, "opt_state": state["opt_state"],
            "step": step.to(state["step"].device)}


__all__ = ["latest_checkpoint", "rank_blocks", "restore_params",
           "restore_route", "restore_train_state", "save_train_state"]
