"""Rank-side code of the port's multi-rank CPU tests.

A :class:`RankPool` spawns ``world`` processes once; each joins a gloo
process group through the port's own ``distributed_init_if_needed``, as a
gang's ranks do: rank 0 binds the group's store first (``bind_store``)
and hands its port to the other ranks. Each rank runs on one thread at
a lower priority (``nice`` 10, so that the timing tests of other pytest
workers keep their share of the cores), and then runs every case the
test process sends it, in order, returning picklable results (numpy
arrays, floats). The ranks import ``torch`` and the port only: inputs come as numpy arrays.

The pool first waits for every rank to start and join its group (up to
``START_TIMEOUT_S``: spawning and importing torch under the load of other
test processes is the slow part), then for each case's results, up to
``CASE_TIMEOUT_S`` without a result from any rank. A case that fails or times out fails
alone: its processes are stopped, cases sent with it fail at once, and the
next case starts a fresh pool on a fresh port.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback
from typing import Any, Dict, List, Set

import numpy as np

CASE_TIMEOUT_S = 120.0
START_TIMEOUT_S = 300.0


class RankPool:
    def __init__(self, world: int, timeout: float = CASE_TIMEOUT_S):
        self.world, self.timeout = world, timeout
        self.broken = None
        self._next = 0
        self._done: Dict[int, Dict[int, Any]] = {}
        self._lost: Dict[int, str] = {}
        self._procs: List[Any] = []
        self._spawn()

    def _spawn(self) -> None:
        ctx = mp.get_context("spawn")
        self.broken = None
        self._ready = 0
        self._pending: Set[int] = set()
        self._inqs = [ctx.Queue() for _ in range(self.world)]
        self._outq = ctx.Queue()
        # Rank 0 hands its store's port to the others (kept here until
        # they have read it).
        self._portq = ctx.Queue()
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(rank, self.world, self._portq,
                                         self._inqs[rank], self._outq))
                       for rank in range(self.world)]
        for p in self._procs:
            p.start()

    def submit(self, case: str, *args) -> int:
        """Send a case to every rank; returns its id for :meth:`result`.
        After a failed case the pool is respawned first."""
        if self.broken:
            self._spawn()
        cid, self._next = self._next, self._next + 1
        self._pending.add(cid)
        for q in self._inqs:
            q.put((cid, case, args))
        return cid

    def result(self, cid: int) -> List[Any]:
        """Every rank's result of case ``cid``, in rank order."""
        while len(self._done.get(cid, {})) < self.world:
            if cid in self._lost:
                raise RuntimeError(self._lost.pop(cid))
            if self._ready < self.world:
                wait, what = START_TIMEOUT_S, "to start"
            else:
                wait, what = self.timeout, "a result"
            try:
                got, rank, ok, value = self._outq.get(timeout=wait)
            except queue.Empty:
                self._break(f"no rank sent {what} within {wait} s")
                continue
            if not ok:
                what = "to start" if got is None else f"case {got}"
                self._break(f"rank {rank} failed {what}:\n{value}")
            elif got is None:
                self._ready += 1
            else:
                self._done.setdefault(got, {})[rank] = value
        self._pending.discard(cid)
        done = self._done.pop(cid)
        return [done[r] for r in range(self.world)]

    def run(self, case: str, *args) -> List[Any]:
        return self.result(self.submit(case, *args))

    def _break(self, reason: str) -> None:
        """Stop the processes; every case sent to them fails with
        ``reason``, and the next submit respawns the pool."""
        self.broken = reason
        for cid in self._pending:
            self._done.pop(cid, None)
            self._lost[cid] = f"the rank pool broke: {reason}"
        self._pending = set()
        self.close()

    def close(self) -> None:
        for q in self._inqs:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def _serve(rank, world, portq, inq, outq) -> None:
    os.nice(10)
    try:
        import torch
        torch.set_num_threads(1)
        from ray_tpu_torch.train.torch import (bind_store,
                                               distributed_init_if_needed)
        if rank == 0:
            port = bind_store(world)
            for _ in range(world - 1):
                portq.put(port)
        else:
            port = portq.get(timeout=START_TIMEOUT_S)
        os.environ.update({"MASTER_ADDR": "127.0.0.1",
                           "MASTER_PORT": str(port),
                           "RAY_TPU_WORLD_SIZE": str(world),
                           "RAY_TPU_RANK": str(rank)})
        distributed_init_if_needed("cpu")
    except Exception:  # noqa: BLE001 - reported to the test process
        outq.put((None, rank, False, traceback.format_exc()))
        return
    outq.put((None, rank, True, None))
    try:
        while True:
            msg = inq.get()
            if msg is None:
                return
            cid, case, args = msg
            try:
                outq.put((cid, rank, True, CASES[case](*args)))
            except Exception:  # noqa: BLE001 - reported to the test process
                outq.put((cid, rank, False, traceback.format_exc()))
    finally:
        torch.distributed.destroy_process_group()


# -- cases -------------------------------------------------------------

def _mesh(mesh_cfg: Dict[str, int]):
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    return build_mesh(MeshConfig(**mesh_cfg), "cpu")


def _rules(name: str):
    from ray_tpu_torch.parallel import sharding
    return getattr(sharding, name)()


def _coords(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _locals(model) -> Dict[str, np.ndarray]:
    from ray_tpu_torch.parallel.sharding import local
    return {n: local(p).detach().numpy().copy()
            for n, p in model.named_parameters()}


def mesh_layout(mesh_cfg):
    """The rank grid of ``build_mesh`` and this rank's coordinates."""
    import torch
    mesh = _mesh(mesh_cfg)
    return {"grid": mesh.mesh.tolist(), "coords": _coords(mesh),
            "rank": torch.distributed.get_rank()}


def gpt_train_step(preset, overrides, mesh_cfg, rules_name, opt_name,
                   params0, batches, accum):
    """Steps of the port's train step from the JAX parameters: this
    rank's blocks before and after, the metrics of each step, and the
    forward of an unplaced copy of the model (the logits and aux term of
    the first batch's tokens) before the steps, after them on every rank,
    and after them on rank 0 alone: a forward outside the steps must not
    inherit their layout, nor wait for collectives of the other ranks."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel import train_step as ts

    mesh, rules = _mesh(mesh_cfg), _rules(rules_name)
    cfg = gpt.config(preset, **overrides)
    opt = {"adamw": lambda: ts.default_optimizer(1e-3, warmup_steps=1),
           "adafactor": lambda: ts.memory_efficient_optimizer(
               1e-2, warmup_steps=1)}[opt_name]()
    model = sharding.shard_model(gpt.from_jax_params(params0, cfg, "cpu"),
                                 mesh, gpt.param_specs(cfg, rules))
    before = _locals(model)
    plain = gpt.from_jax_params(params0, dataclasses.replace(
        cfg, attn_impl="dot" if cfg.attn_impl in ("ring", "ulysses")
        else cfg.attn_impl), "cpu")

    def plain_forward():
        with torch.no_grad():
            logits, aux = plain.forward_with_aux(
                torch.from_numpy(batches[0]["tokens"]))
        return logits.numpy(), float(aux)

    plain_before = plain_forward()
    state = {"params": model,
             "opt_state": opt.init(dict(model.named_parameters()),
                                   gpt.leaf_groups(model)),
             "step": torch.zeros((), dtype=torch.int32)}
    step = ts.make_train_step(cfg, mesh, rules, opt, accum_steps=accum)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    evals = ts.make_eval_step(cfg, mesh, rules)(
        model, {k: torch.from_numpy(v) for k, v in batches[0].items()})
    plain_after = plain_forward()
    alone = plain_forward() if torch.distributed.get_rank() == 0 else None
    return {"coords": _coords(mesh), "before": before,
            "plain": (plain_before, plain_after, alone),
            "after": _locals(model), "metrics": metrics,
            "eval": {k: float(v) for k, v in evals.items()},
            "step": int(state["step"])}


def gpt_forward(preset, overrides, mesh_cfg, rules_name, params0, tokens):
    """The port's GPT logits on the mesh from the JAX parameters (the
    whole batch on every rank)."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import sharding

    mesh, rules = _mesh(mesh_cfg), _rules(rules_name)
    cfg = gpt.config(preset, **overrides)
    model = sharding.shard_model(gpt.from_jax_params(params0, cfg, "cpu"),
                                 mesh, gpt.param_specs(cfg, rules))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    model.reshard()
    return {"coords": _coords(mesh), "logits": logits.numpy()}


def vocab_stats(logits, targets):
    """``_common.vocab_parallel_stats`` on this rank's block of the last
    dim of ``logits`` (the vocab split over every rank, as ``tp``): the
    logsumexp, target logit and hits over the whole vocab."""
    import torch

    from ray_tpu_torch.models import _common
    from ray_tpu_torch.parallel.sharding import AxisShard

    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    n = logits.shape[-1] // world
    block = torch.from_numpy(logits[..., rank * n:(rank + 1) * n].copy())
    logz, tgt, hits = _common.vocab_parallel_stats(
        block, torch.from_numpy(targets),
        AxisShard(torch.distributed.group.WORLD, rank, world))
    return logz.numpy(), tgt.numpy(), hits.numpy()


def remat_grads(preset, overrides, mesh_cfg, rules_name, params0, batch):
    """This rank's gradient blocks of one backward on the mesh under each
    remat policy, from the JAX parameters: the train step's loss and
    reductions (``parallel.train_step``), without the optimizer; and the
    runs of K1's plain version (its stand-in on the CPU) under each."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel import train_step as ts

    mesh, rules = _mesh(mesh_cfg), _rules(rules_name)
    out = {"coords": _coords(mesh), "k1_runs": {}}
    plain = fa._flash_forward_reference
    for policy in ("full", "selective"):
        runs = []

        def counted(*args):
            runs.append(1)
            return plain(*args)
        cfg = gpt.config(preset, remat=True, remat_policy=policy,
                         **overrides)
        model = sharding.shard_model(gpt.from_jax_params(params0, cfg,
                                                         "cpu"),
                                     mesh, gpt.param_specs(cfg, rules))
        batching = ts._Batching(mesh, rules)
        fa._flash_forward_reference = counted
        try:
            with batching.registered():
                b = batching.local({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
                loss, _ = gpt.loss_fn(model, b["tokens"], b["targets"],
                                      b.get("mask"),
                                      batch_groups=batching.groups)
                (loss * batching.blocks).backward()
        finally:
            fa._flash_forward_reference = plain
        out["k1_runs"][policy] = len(runs)
        params = dict(model.named_parameters())
        with batching.registered():
            sharding.average_replicated_grads(params.values(),
                                              gpt.batch_spec)
        grads = [p.grad for p in params.values()]
        out[policy] = {n: sharding.local(g).numpy().copy()
                       for n, g in zip(params, grads)}
    return out


def seeded_init(preset, mesh_cfg, rules_name, seed, opt_name):
    """init_train_state on the mesh against the same seed without one:
    every rank's block of every tensor must be that block of the
    one-device weights; returns the names checked."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.sharding import local, local_block

    mesh, rules = _mesh(mesh_cfg), _rules(rules_name)
    cfg = gpt.config(preset)
    opt = getattr(ts, opt_name)()
    sharded = ts.init_train_state(cfg, mesh, rules, opt, seed=seed,
                                  device="cpu")
    whole = ts.init_train_state(cfg, optimizer=opt, seed=seed, device="cpu")
    ref = dict(whole["params"].named_parameters())
    names = []
    for n, p in sharded["params"].named_parameters():
        if not torch.equal(local(p), local_block(ref[n].detach(), p)):
            raise AssertionError(f"{n}: this rank's block differs")
        names.append(n)
    return names


def llama_forward(preset, overrides, mesh_cfg, rules_name, params0, tokens):
    """The port's Llama forward on the mesh from the JAX parameters."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import sharding

    mesh, rules = _mesh(mesh_cfg), _rules(rules_name)
    cfg = llama.config(preset, **overrides)
    model = sharding.shard_model(llama.from_jax_params(params0, cfg, "cpu"),
                                 mesh, llama.param_specs(cfg, rules))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    model.reshard()
    return {"coords": _coords(mesh), "logits": logits.numpy(),
            "params": _locals(model)}


def tree_blocks(mesh_cfg, tree, specs):
    """``shard_tree`` of a (nested) dict of numpy arrays by its specs:
    this rank's block of each leaf."""
    import torch

    from ray_tpu_torch.parallel import sharding

    def to_torch(t):
        if isinstance(t, dict):
            return {k: to_torch(v) for k, v in t.items()}
        return torch.from_numpy(t)

    def to_numpy(t):
        if isinstance(t, dict):
            return {k: to_numpy(v) for k, v in t.items()}
        return t.to_local().numpy()

    mesh = _mesh(mesh_cfg)
    placed = sharding.shard_tree(to_torch(tree), mesh, specs)
    return {"coords": _coords(mesh), "blocks": to_numpy(placed)}


def _optimizer(name):
    from ray_tpu_torch.parallel import train_step as ts
    return {"adamw": lambda: ts.default_optimizer(1e-3, warmup_steps=1),
            "adafactor": lambda: ts.memory_efficient_optimizer(
                1e-2, warmup_steps=1)}[name]()


def _local_tree(state):
    """This rank's blocks of the state in the JAX layout, by path."""
    from ray_tpu_torch.models._params import leaf_groups
    from ray_tpu_torch.parallel import optim
    from ray_tpu_torch.parallel.sharding import local
    from ray_tpu_torch.train._internal import sharded_checkpoint as sc

    model = state["params"]
    groups = leaf_groups(model)
    tree = {"params": optim.to_jax_tree(
                {n: local(p) for n, p in model.named_parameters()}, groups,
                "cpu"),
            "opt_state": optim.to_optax_state(state["opt_state"], groups,
                                              "cpu"),
            "step": state["step"]}
    flat, _ = sc.flatten_tree(tree)
    return {p: v.detach().numpy().copy() for p, v in flat.items()}


def ckpt_save(preset, mesh_cfg, rules_name, opt_name, storage, batches):
    """init_train_state on the mesh, the steps, then save_train_state into
    ``storage`` (rank 0 holds the CheckpointManager): the manifest's URI
    and this rank's blocks as saved."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.train import CheckpointManager, save_train_state

    mesh, rules = _mesh(mesh_cfg), _rules(rules_name)
    cfg, opt = gpt.config(preset), _optimizer(opt_name)
    state = ts.init_train_state(cfg, mesh, rules, opt, seed=0, device="cpu")
    step = ts.make_train_step(cfg, mesh, rules, opt)
    for b in batches:
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    manager = (CheckpointManager(storage, "ranks")
               if torch.distributed.get_rank() == 0 else None)
    handle = save_train_state(state, manager, mesh, rules)
    return {"coords": _coords(mesh), "uri": handle.uri,
            "blocks": _local_tree(state)}


def ckpt_restore(preset, mesh_cfg, rules_name, opt_name, uri, batch):
    """A fresh state (another seed) on the mesh, restore_train_state from
    ``uri``, then one step: the route taken, this rank's blocks after the
    restore, the step's metrics and the parameters' blocks after it."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.train import ShardedCheckpoint, restore_train_state
    from ray_tpu_torch.train.torch.checkpoint import restore_route

    mesh, rules = _mesh(mesh_cfg), _rules(rules_name)
    cfg, opt = gpt.config(preset), _optimizer(opt_name)
    state = ts.init_train_state(cfg, mesh, rules, opt, seed=1, device="cpu")
    ckpt = ShardedCheckpoint.from_manifest_uri(uri)
    route = restore_route(ckpt, state, mesh, rules)
    state = restore_train_state(state, ckpt, mesh, rules)
    blocks = _local_tree(state)
    state, m = ts.make_train_step(cfg, mesh, rules, opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"coords": _coords(mesh), "route": route, "blocks": blocks,
            "loss": float(m["loss"]), "after": _locals(state["params"]),
            "step": int(state["step"])}


def dcp_round_trip(preset, save_mesh, save_rules, load_mesh, load_rules,
                   directory):
    """Checkpoint.from_sharded_state of a model placed on one mesh, then
    restore_sharded_state into a model of another seed on another mesh:
    this rank's blocks after the restore."""
    import torch

    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import gpt

    cfg = gpt.config(preset)
    model = gpt.init(cfg, torch.Generator().manual_seed(0), "cpu",
                     mesh=_mesh(save_mesh), rules=_rules(save_rules))
    ckpt = Checkpoint.from_sharded_state(
        {"model": model.state_dict(), "step": torch.tensor(7)}, directory,
        extra={"step": 7})
    mesh = _mesh(load_mesh)
    other = gpt.init(cfg, torch.Generator().manual_seed(1), "cpu", mesh=mesh,
                     rules=_rules(load_rules))
    target = {"model": other.state_dict(), "step": torch.tensor(0)}
    ckpt.restore_sharded_state(target)
    return {"coords": _coords(mesh), "params": _locals(other),
            "step": int(target["step"]), "extra": ckpt.extra_metadata}


def _grad_of_sum_sq(fn, *inputs):
    """(fn(*inputs), the gradients of (fn(*inputs) ** 2).sum()), as numpy;
    inputs are numpy arrays, or tensors that already require grad."""
    import torch
    xs = [torch.from_numpy(x).requires_grad_() if isinstance(x, np.ndarray)
          else x for x in inputs]
    out = fn(*xs)
    grads = torch.autograd.grad((out ** 2).sum(), xs)
    return out.detach().numpy(), [g.detach().numpy() for g in grads]


def ring_whole(mesh_cfg, q, k, v):
    """make_ring_attention over the mesh's sp axis on whole q, k, v: the
    output and the gradients of its sum of squares."""
    from ray_tpu_torch.ops.ring_attention import make_ring_attention
    fn = make_ring_attention(_mesh(mesh_cfg), "sp")
    out, grads = _grad_of_sum_sq(fn, q, k, v)
    return {"out": out, "grads": grads}


def ulysses_whole(mesh_cfg, q, k, v, odd_heads):
    """make_ulysses_attention on whole q, k, v (split over (dp, fsdp) and
    sp): the output, and the error it raises on ``odd_heads``."""
    import torch

    from ray_tpu_torch.ops.ulysses import make_ulysses_attention
    attn = make_ulysses_attention(_mesh(mesh_cfg))
    with torch.no_grad():
        out = attn(*(torch.from_numpy(x) for x in (q, k, v)))
        try:
            attn(*(torch.from_numpy(odd_heads),) * 3)
            error = None
        except ValueError as exc:
            error = str(exc)
    return {"out": out.numpy(), "error": error}


def pipeline_run(mesh_cfg, params, xs, placed):
    """make_pipeline_fn over the mesh's pp axis with the tanh stage of
    tests/test_parallel_extra.py; the stage parameters placed by
    stage_param_specs (``placed``: each rank's grad is its own block), or
    whole: the outputs and the gradients of their sum of squares."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import (make_pipeline_fn, shard_tree,
                                        stage_param_specs)
    mesh = _mesh(mesh_cfg)
    tree = {k: torch.from_numpy(v) for k, v in params.items()}
    if placed:
        tree = shard_tree(tree, mesh, stage_param_specs(tree))
    tree = {k: v.requires_grad_() for k, v in tree.items()}

    def stage_fn(p, x):
        y = x @ p["w"]
        return torch.tanh(y + p["b"] if "b" in p else y)

    pipelined = make_pipeline_fn(stage_fn, mesh_cfg["pp"], mesh)
    out = pipelined(tree, torch.from_numpy(xs))
    names = sorted(tree)
    grads = torch.autograd.grad((out ** 2).sum(), [tree[n] for n in names])
    grads = {n: (g.to_local() if isinstance(g, DTensor) else g).numpy()
             for n, g in zip(names, grads)}
    return {"coords": _coords(mesh), "out": out.detach().numpy(),
            "grads": grads}


def pipeline_errors(mesh_cfg):
    """make_pipeline_fn's ValueErrors: on a stage count that is not the
    pp axis's size, and on a mesh with no pp axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tpu_torch.parallel import make_pipeline_fn
    errors = []
    for mesh, n_stages in (
            (_mesh(mesh_cfg), 2 * mesh_cfg["pp"]),
            (init_device_mesh("cpu", (dist.get_world_size(),),
                              mesh_dim_names=("sp",)), 2)):
        try:
            make_pipeline_fn(lambda p, x: x, n_stages, mesh)
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    return errors


def moe_layer(mesh_cfg, rules_name, overrides, params0, h):
    """The first block's MoE FFN of gpt-moe-tiny on the mesh, its batch
    laid out by the rules (made the current ones): this rank's rows and
    columns of ``h`` in, its output block and share of the aux term
    out."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import registered_mesh

    mesh, rules = _mesh(mesh_cfg), _rules(rules_name)
    cfg = gpt.config("gpt-moe-tiny", **overrides)
    model = sharding.shard_model(gpt.from_jax_params(params0, cfg, "cpu"),
                                 mesh, gpt.param_specs(cfg, rules))
    coords = _coords(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    rows, cols = sharding.shard_slices(h.shape[:2], gpt.batch_spec(rules),
                                       sizes, coords)
    block = model.blocks[0]
    block.unshard()
    with registered_mesh(mesh, rules), torch.no_grad():
        out, aux = gpt._moe_ffn(cfg, torch.from_numpy(h[rows, cols]), block)
    block.reshard()
    return {"coords": coords, "rows": (rows.start, rows.stop),
            "cols": (cols.start, cols.stop), "out": out.numpy(),
            "aux": float(aux)}


# -- the model zoo ------------------------------------------------------
# A zoo model's case names its module ("vit", "bert", "t5", "diffusion")
# and its rules (a preset's name, or ShardingRules' fields as a dict); the
# batch is a tuple of numpy arrays, the global batch, of which each rank
# takes its block by the model's batch_spec: its rows over the rules'
# batch axes and, for BERT and T5 under rules.sequence, its columns over
# sp.

def _zoo(name):
    """The module of a zoo case: "bert-pooled" is BERT with a classifier's
    loss on its pooler (``_zoo_loss``)."""
    from ray_tpu_torch.models import bert, diffusion, t5, vit
    return {"vit": vit, "bert": bert, "bert-pooled": bert, "t5": t5,
            "diffusion": diffusion}[name]


def _zoo_rules(rules):
    from ray_tpu_torch.parallel.sharding import ShardingRules
    return _rules(rules) if isinstance(rules, str) else ShardingRules(**rules)


def _zoo_rows(name, mesh, rules, arrays):
    """This rank's block of each array (of the global batch) by the
    model's batch_spec, its first ``ndim`` entries, as ``jax.device_put``
    places it (``collectives.split_by_spec``, which raises
    ValueError where a dim does not divide), as tensors, and (start,
    stop) of its rows."""
    import torch

    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.mesh import mesh_sizes
    from ray_tpu_torch.parallel.sharding import PartitionSpec, shard_slices
    spec = _zoo(name).batch_spec(rules)
    rows = shard_slices((arrays[0].shape[0],), PartitionSpec(spec[0]),
                        mesh_sizes(mesh), _coords(mesh))[0]
    return ([collectives.split_by_spec(
        torch.from_numpy(np.ascontiguousarray(a)), mesh,
        spec[:a.ndim]).contiguous()
        for a in arrays], (rows.start, rows.stop))


def _zoo_forward_fn(name):
    """The model's forward on the inputs of its test: logits (the UNet's
    predicted noise)."""
    m = _zoo(name)
    return {"vit": lambda model, images: m.forward(model, images),
            "bert": lambda model, tokens, attn: m.mlm_logits(
                model, tokens, attention_mask=attn),
            "t5": lambda model, enc, dec: m.forward(model, enc, dec),
            "diffusion": lambda model, x, t: m.forward(model, x, t)}[name]


def _zoo_loss(name, model, batch, seed):
    """This rank's share of the loss of its rows of the batch; the UNet
    draws t and eps from a generator seeded with ``seed``."""
    import torch

    from ray_tpu_torch.models import _common
    m = _zoo(name)
    if name == "bert":
        return m.mlm_loss(model, *batch)
    if name == "bert-pooled":
        # The pooler's d_model outputs as the logits of as many classes.
        tokens, labels, attn = batch
        return _common.masked_ce(m.pooled(model, tokens,
                                          attention_mask=attn),
                                 labels, None, batch_spec=m.batch_spec)[0]
    if name == "diffusion":
        return m.loss_fn(model, batch[0],
                         torch.Generator().manual_seed(seed))[0]
    return m.loss_fn(model, *batch)[0]


def _zoo_step(name, mesh, rules, model, opt, opt_state, batch, seed):
    """One step on the mesh, as a user composes it: in registered_mesh
    the loss, backward (FSDP2 averages over the data ranks, so the share
    is scaled by the count of batch blocks), the replicated parameters'
    gradients averaged and, where the model splits its sequence, every
    gradient summed over sp (``average_replicated_grads`` with the
    model's batch_spec); AdamW's update → (opt_state, the global loss,
    this rank's gradient blocks, the gradients' global norm)."""
    import torch

    from ray_tpu_torch.models import _common
    from ray_tpu_torch.parallel import optim
    from ray_tpu_torch.parallel.mesh import registered_mesh
    from ray_tpu_torch.parallel.sharding import (average_replicated_grads,
                                                 local)
    params = dict(model.named_parameters())
    spec = _zoo(name).batch_spec
    with registered_mesh(mesh, rules):
        share = _zoo_loss(name, model, batch, seed)
        (share * _common.batch_blocks(spec)).backward()
        loss = _common.batch_sum(share.detach(), [
            g.group for g in _common.batch_groups(spec)])
        average_replicated_grads(params.values(), spec)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in params.items()}
    blocks = {n: local(g).detach().numpy().copy() for n, g in grads.items()}
    # The global norm as optim's clip takes it: each rank's sums of
    # squares, each block counted once over the copies of its mesh.
    norm = float(optim._global_sums(
        [local(g).float().pow(2).sum() for g in grads.values()],
        list(grads.values())).sum().sqrt())
    for p in params.values():
        p.grad = None
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
    return opt_state, float(loss), blocks, norm


def _zoo_adamw(lr):
    import torch

    from ray_tpu_torch.parallel import optim
    return optim.adamw(lambda count: torch.tensor(lr, dtype=torch.float32),
                       weight_decay=0.0)


def zoo_forward(name, preset, mesh_cfg, rules, params0, inputs):
    """The zoo model placed by from_jax_params on the mesh: the forward
    of this rank's block of ``inputs`` (BERT's pooler too), and this
    rank's parameter blocks."""
    import torch

    from ray_tpu_torch.parallel.mesh import registered_mesh
    mesh, rules = _mesh(mesh_cfg), _zoo_rules(rules)
    m = _zoo(name)
    model = m.from_jax_params(params0, m.config(preset), "cpu", mesh=mesh,
                              rules=rules)
    xs, rows = _zoo_rows(name, mesh, rules, inputs)
    out = {"coords": _coords(mesh), "rows": rows}
    # In registered_mesh: the models read how the batch lies (BERT and T5
    # their sequence over sp).
    with torch.no_grad(), registered_mesh(mesh, rules):
        out["out"] = _zoo_forward_fn(name)(model, *xs).numpy()
        if name == "bert":
            out["pooled"] = m.pooled(model, xs[0],
                                     attention_mask=xs[1]).numpy()
    model.reshard()  # with no backward to follow, the root stays gathered
    return {**out, "params": _locals(model)}


def zoo_train(name, preset, mesh_cfg, rules, params0, batches, lr, seed):
    """AdamW (weight decay 0) steps of the zoo model on the mesh, one per
    batch: the first step's gradient blocks, each step's global loss and
    gradient norm, and this rank's parameter blocks after the steps."""
    mesh, rules = _mesh(mesh_cfg), _zoo_rules(rules)
    m = _zoo(name)
    model = m.from_jax_params(params0, m.config(preset), "cpu", mesh=mesh,
                              rules=rules)
    opt = _zoo_adamw(lr)
    opt_state = opt.init(dict(model.named_parameters()), m.leaf_groups(model))
    losses, grads, norms = [], None, []
    for i, batch in enumerate(batches):
        xs, rows = _zoo_rows(name, mesh, rules, batch)
        opt_state, loss, g, norm = _zoo_step(name, mesh, rules, model, opt,
                                             opt_state, xs, seed + i)
        losses.append(loss)
        norms.append(norm)
        grads = grads or g
    return {"coords": _coords(mesh), "rows": rows, "losses": losses,
            "grads": grads, "norms": norms, "after": _locals(model)}


def zoo_seeded_init(name, preset, mesh_cfg, rules, seed):
    """init on the mesh from a seed against init on no mesh from the same
    seed: every rank's block of every tensor must be that block of the
    one-device weights; returns the names checked."""
    import torch

    from ray_tpu_torch.parallel.sharding import local, local_block
    mesh, rules = _mesh(mesh_cfg), _zoo_rules(rules)
    m = _zoo(name)
    cfg = m.config(preset)
    placed = m.init(cfg, torch.Generator().manual_seed(seed), "cpu",
                    mesh=mesh, rules=rules)
    whole = dict(m.init(cfg, torch.Generator().manual_seed(seed),
                        "cpu").named_parameters())
    names = []
    for n, p in placed.named_parameters():
        if not torch.equal(local(p), local_block(whole[n].detach(), p)):
            raise AssertionError(f"{n}: this rank's block differs")
        names.append(n)
    return names


def _zoo_state(name, preset, mesh, rules, lr, params0=None, seed=0):
    import torch
    m = _zoo(name)
    cfg = m.config(preset)
    model = (m.init(cfg, torch.Generator().manual_seed(seed), "cpu",
                    mesh=mesh, rules=rules) if params0 is None
             else m.from_jax_params(params0, cfg, "cpu", mesh=mesh,
                                    rules=rules))
    opt = _zoo_adamw(lr)
    return {"params": model,
            "opt_state": opt.init(dict(model.named_parameters()),
                                  m.leaf_groups(model)),
            "step": torch.zeros((), dtype=torch.int32)}, opt


def zoo_ckpt_save(name, preset, mesh_cfg, rules, params0, batches, lr,
                  storage):
    """The zoo model from ``params0`` on the mesh, AdamW steps over
    ``batches``, then save_train_state into ``storage``: the manifest's
    URI and this rank's blocks as saved."""
    import torch

    from ray_tpu_torch.train import CheckpointManager, save_train_state
    mesh, rules = _mesh(mesh_cfg), _zoo_rules(rules)
    state, opt = _zoo_state(name, preset, mesh, rules, lr, params0)
    for i, batch in enumerate(batches):
        xs, _ = _zoo_rows(name, mesh, rules, batch)
        state["opt_state"], _, _, _ = _zoo_step(
            name, mesh, rules, state["params"], opt, state["opt_state"], xs,
            i)
        state["step"] = state["step"] + 1
    manager = (CheckpointManager(storage, "zoo")
               if torch.distributed.get_rank() == 0 else None)
    handle = save_train_state(state, manager, mesh, rules)
    return {"coords": _coords(mesh), "uri": handle.uri,
            "blocks": _local_tree(state)}


def zoo_ckpt_restore(name, preset, mesh_cfg, rules, lr, uri, batch, seed):
    """A state of another seed on the mesh, restore_train_state from
    ``uri``, then one step: the route, this rank's blocks after the
    restore, the step's loss and the parameters' blocks after it."""
    from ray_tpu_torch.train import ShardedCheckpoint, restore_train_state
    from ray_tpu_torch.train.torch.checkpoint import restore_route
    mesh, rules = _mesh(mesh_cfg), _zoo_rules(rules)
    state, opt = _zoo_state(name, preset, mesh, rules, lr, seed=7)
    ckpt = ShardedCheckpoint.from_manifest_uri(uri)
    route = restore_route(ckpt, state, mesh, rules)
    state = restore_train_state(state, ckpt, mesh, rules)
    blocks = _local_tree(state)
    xs, _ = _zoo_rows(name, mesh, rules, batch)
    _, loss, _, _ = _zoo_step(name, mesh, rules, state["params"], opt,
                              state["opt_state"], xs, seed)
    return {"coords": _coords(mesh), "route": route, "blocks": blocks,
            "loss": loss, "after": _locals(state["params"]),
            "step": int(state["step"])}


def zoo_errors(mesh_cfg):
    """The messages of the zoo's limits on the mesh: vit-tiny with its 10
    classes over tp, ViT with the layer axis over pp."""
    import torch

    from ray_tpu_torch.models import vit
    from ray_tpu_torch.parallel.sharding import ShardingRules
    mesh = _mesh(mesh_cfg)
    out = {}
    for key, fn, exc in (
            ("classes", lambda: vit.init(vit.config("vit-tiny"),
                                         torch.Generator(), "cpu", mesh=mesh,
                                         rules=ShardingRules(embed=None)),
             ValueError),
            ("layers", lambda: vit.init(vit.config("vit-tiny"),
                                        torch.Generator(), "cpu", mesh=mesh,
                                        rules=ShardingRules(layers="pp")),
             NotImplementedError)):
        try:
            fn()
            out[key] = None
        except exc as e:
            out[key] = str(e)
    return out


def zoo_uneven_sequence(name, mesh_cfg, rules, arrays):
    """The ValueError of placing the batch ``arrays`` by the model's
    batch_spec on the mesh (None if it placed)."""
    mesh, rules = _mesh(mesh_cfg), _zoo_rules(rules)
    try:
        _zoo_rows(name, mesh, rules, arrays)
    except ValueError as e:
        return str(e)
    return None


def zoo_sum_outside_registered_mesh(mesh_cfg, rules):
    """``average_replicated_grads`` on bert-tiny's parameters placed on
    the mesh: (the RuntimeError it raises outside ``registered_mesh``, or
    None if it returned; whether it returned inside)."""
    import torch

    from ray_tpu_torch.models import bert
    from ray_tpu_torch.parallel.mesh import registered_mesh
    from ray_tpu_torch.parallel.sharding import average_replicated_grads
    mesh, rules = _mesh(mesh_cfg), _zoo_rules(rules)
    model = bert.init(bert.config("bert-tiny"), torch.Generator(), "cpu",
                      mesh=mesh, rules=rules)
    outside = None
    try:
        average_replicated_grads(model.parameters(), bert.batch_spec)
    except RuntimeError as e:
        outside = str(e)
    with registered_mesh(mesh, rules):
        average_replicated_grads(model.parameters(), bert.batch_spec)
    return outside, True


def zoo_dispatched(name, preset, mesh_cfg, rules_names, params0, batch):
    """For each of ``rules_names``: the model placed on the mesh by those
    rules, one step on ``batch`` (the first, uncounted), then the
    operators the next step dispatches, by name and argument shapes."""
    from collections import Counter

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            shapes = tuple(tuple(a.shape) for a in tree_leaves((args, kwargs))
                           if isinstance(a, torch.Tensor))
            self.ops[f"{func} {shapes}"] += 1
            return func(*args, **kwargs)
    mesh = _mesh(mesh_cfg)
    out = []
    for rules in rules_names:
        rules = _zoo_rules(rules)
        state, opt = _zoo_state(name, preset, mesh, rules, 1e-3, params0)
        xs, _ = _zoo_rows(name, mesh, rules, batch)
        state["opt_state"] = _zoo_step(name, mesh, rules, state["params"],
                                       opt, state["opt_state"], xs, 0)[0]
        with Count() as mode:
            _zoo_step(name, mesh, rules, state["params"], opt,
                      state["opt_state"], xs, 1)
        out.append(dict(mode.ops))
    return out


def zoo_uneven_vocab(mesh_cfg, rules_name):
    """The ValueError of bert-tiny with a vocab of 30 placed on the mesh
    (None if it placed)."""
    import torch

    from ray_tpu_torch.models import bert
    try:
        bert.init(bert.config("bert-tiny", vocab_size=30), torch.Generator(),
                  "cpu", mesh=_mesh(mesh_cfg), rules=_rules(rules_name))
    except ValueError as e:
        return str(e)
    return None


def rllib_learner(params0, batches, lr, small):
    """``LearnerGroup(PPOLearner)`` in this process group (its mesh: dp over
    the world) from the JAX learner's parameters: this rank's rows of the
    first batch, each update's metrics and dropped rows, the weights after
    them, and the error of a batch of ``small`` rows."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.core import (LearnerConfig, LearnerGroup,
                                          MLPActorCriticModule, PPOLearner,
                                          RLModuleSpec)
    spec = RLModuleSpec(MLPActorCriticModule,
                        gym.spaces.Box(-1, 1, (4,), np.float32),
                        gym.spaces.Discrete(2), {"fcnet_hiddens": (16,)})
    group = LearnerGroup(PPOLearner, spec,
                         LearnerConfig(lr=lr, device="cpu"))
    group.set_weights(params0)
    learner = group._learner
    rows = learner._device_batch(batches[0])["obs"].numpy()
    metrics, dropped = [], []
    for batch in batches:
        metrics.append(group.update(batch))
        dropped.append(learner.last_dropped_rows)
    error = None
    try:
        group.update({k: v[:small] for k, v in batches[0].items()})
    except ValueError as e:
        error = str(e)
    return {"dp": group.mesh["dp"].size(), "rows": rows,
            "metrics": metrics, "dropped": dropped,
            "weights": group.get_weights(), "error": error}


CASES = {f.__name__: f for f in (mesh_layout, gpt_train_step, seeded_init,
                                  gpt_forward, remat_grads, vocab_stats,
                                  llama_forward,
                                  tree_blocks, ckpt_save, ckpt_restore,
                                  dcp_round_trip, ring_whole, ulysses_whole,
                                  pipeline_run, pipeline_errors, moe_layer,
                                  zoo_forward, zoo_train, zoo_seeded_init,
                                  zoo_ckpt_save, zoo_ckpt_restore,
                                  zoo_errors, zoo_dispatched,
                                  zoo_sum_outside_registered_mesh,
                                  zoo_uneven_sequence, zoo_uneven_vocab,
                                  rllib_learner)}
