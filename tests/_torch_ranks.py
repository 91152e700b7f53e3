"""Rank-side code of the port's multi-rank CPU tests.

A :class:`RankPool` spawns ``world`` processes once; each joins a gloo
process group through the port's own ``distributed_init_if_needed`` (from
``MASTER_ADDR``/``MASTER_PORT``/``RAY_TPU_WORLD_SIZE``/``RAY_TPU_RANK``),
runs on one thread at a lower priority (``nice`` 10, so that the timing
tests of other pytest workers keep their share of the cores), and then
runs every case the test process sends it,
in order, returning picklable results (numpy arrays, floats). The ranks
import ``torch`` and the port only: inputs come as numpy arrays.

Every wait has its own timeout. A case that fails or times out breaks the
pool: its processes are stopped and later cases fail at once, so a hang
costs one timeout, not the suite's limit.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import traceback
from typing import Any, Dict, List

import numpy as np

CASE_TIMEOUT_S = 120.0


class RankPool:
    def __init__(self, world: int, timeout: float = CASE_TIMEOUT_S):
        ctx = mp.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.world, self.timeout = world, timeout
        self.broken = None
        self._next = 0
        self._done: Dict[int, Dict[int, Any]] = {}
        self._inqs = [ctx.Queue() for _ in range(world)]
        self._outq = ctx.Queue()
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(rank, world, port, self._inqs[rank],
                                         self._outq))
                       for rank in range(world)]
        for p in self._procs:
            p.start()

    def submit(self, case: str, *args) -> int:
        """Send a case to every rank; returns its id for :meth:`result`."""
        if self.broken:
            raise RuntimeError(f"the rank pool is broken: {self.broken}")
        cid, self._next = self._next, self._next + 1
        for q in self._inqs:
            q.put((cid, case, args))
        return cid

    def result(self, cid: int) -> List[Any]:
        """Every rank's result of case ``cid``, in rank order."""
        while len(self._done.get(cid, {})) < self.world:
            if self.broken:
                raise RuntimeError(f"the rank pool is broken: {self.broken}")
            try:
                got, rank, ok, value = self._outq.get(timeout=self.timeout)
            except queue.Empty:
                self._break(f"no result within {self.timeout} s")
                continue
            if not ok:
                self._break(f"rank {rank} failed:\n{value}")
                continue
            self._done.setdefault(got, {})[rank] = value
        done = self._done.pop(cid)
        return [done[r] for r in range(self.world)]

    def run(self, case: str, *args) -> List[Any]:
        return self.result(self.submit(case, *args))

    def _break(self, reason: str) -> None:
        self.broken = reason
        self.close()

    def close(self) -> None:
        for q in self._inqs:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def _serve(rank, world, port, inq, outq) -> None:
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RAY_TPU_WORLD_SIZE": str(world),
                       "RAY_TPU_RANK": str(rank)})
    os.nice(10)
    import torch
    torch.set_num_threads(1)
    from ray_tpu_torch.train.torch import distributed_init_if_needed
    distributed_init_if_needed("cpu")
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
    rank's blocks before and after, the metrics of each step."""
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
    return {"coords": _coords(mesh), "before": before,
            "after": _locals(model), "metrics": metrics,
            "eval": {k: float(v) for k, v in evals.items()},
            "step": int(state["step"])}


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


CASES = {f.__name__: f for f in (mesh_layout, gpt_train_step, seeded_init,
                                  llama_forward, tree_blocks)}
