"""TorchTrainer: the port's counterpart of ``ray_tpu/train/jax``.

``distributed_init_if_needed`` takes the place of
``jax.distributed.initialize``: it starts ``torch.distributed``'s process
group once, from an explicit ``tcp://`` address. A gang that spans
processes gets ``MASTER_ADDR``/``MASTER_PORT`` (the names Ray's torch
backend sets) and ``RAY_TPU_WORLD_SIZE``/``RAY_TPU_RANK`` from
``_TorchBackend``; with none of them set the process is a world of its
own, one rank on a loopback port, as one JAX process is on one host.
The backend follows the device the caller names: NCCL for the card, gloo
for ``device="cpu"``.

Rank 0 binds the group's store on a port the kernel picks
(:func:`bind_store`) before any other rank learns the port: a port found
free and released until rank 0 binds it can be taken in between by
another process of a busy host, and the ranks then wait on a stranger's
socket.

``TorchTrainer`` runs a train loop on every rank of the gang
(``DataParallelTrainer``): ``ScalingConfig(use_gpu=True)`` reserves a
card per worker, and ``runtime_env={"worker_process": True}`` puts each
rank in its own OS process, which sees only the card of its lease.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.base_trainer import DataParallelTrainer

ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RAY_TPU_WORLD_SIZE",
            "RAY_TPU_RANK")


# The rendezvous waits as long as init_process_group's tcp:// one does.
STORE_TIMEOUT = timedelta(minutes=30)
# Rank 0's store, bound by bind_store until distributed_init_if_needed
# takes it.
_bound: Optional[dist.TCPStore] = None


def bind_store(world_size: int) -> int:
    """Rank 0's half of a gang's rendezvous, before the other ranks are
    told where to meet: bind the process group's store on a port the kernel
    picks, keep it for :func:`distributed_init_if_needed`, and return the
    port."""
    global _bound
    _bound = dist.TCPStore("127.0.0.1", 0, world_size, is_master=True,
                           timeout=STORE_TIMEOUT, wait_for_workers=False)
    return _bound.port


def _store(addr: str, port: int, world: int, rank: int) -> dist.TCPStore:
    """The group's store: rank 0's own from :func:`bind_store` where it
    bound ``port``, else a server on ``port`` (rank 0) or a client of it."""
    global _bound
    if rank == 0 and _bound is not None and _bound.port == port:
        store, _bound = _bound, None
        return store
    return dist.TCPStore(addr, port, world, is_master=rank == 0,
                         timeout=STORE_TIMEOUT, wait_for_workers=False)


def distributed_init_if_needed(device: DeviceLike = None) -> None:
    """Start the process group once, over ``device``'s type (the card
    unless ``"cpu"`` is asked for); a no-op when one exists."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    given = {k: os.environ[k] for k in ENV_VARS if k in os.environ}
    if not given:
        addr, world, rank = "127.0.0.1", 1, 0
        port = bind_store(world)
    elif len(given) < len(ENV_VARS):
        missing = [k for k in ENV_VARS if k not in given]
        raise ValueError(f"{sorted(given)} are set but not {missing}; set "
                         f"all of {list(ENV_VARS)} or none")
    else:
        addr, port = given["MASTER_ADDR"], int(given["MASTER_PORT"])
        world = int(given["RAY_TPU_WORLD_SIZE"])
        rank = int(given["RAY_TPU_RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=_store(addr, port, world, rank),
                            world_size=world, rank=rank)


def prepare_mesh(mesh_config=None, device: DeviceLike = None):
    """The training mesh inside one worker: the process group (started if
    needed), then ``build_mesh(mesh_config or MeshConfig())``."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    distributed_init_if_needed(device)
    return build_mesh(mesh_config or MeshConfig(), device)


class TorchBackendConfig(BackendConfig):
    @property
    def backend_cls(self):
        return _TorchBackend


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchBackendConfig):
        """Distribute the rendezvous of the process group.

        reference parity: _TorchBackend.on_start sets MASTER_ADDR/PORT and
        calls dist.init_process_group on every rank, and so does this one
        when every rank has a process of its own (a host and pid no other
        rank has) outside this one: rank 0 binds the store's port first
        (``bind_store``), and every rank is then told it. A gang on
        threads of this process gets no process group from the backend, as
        in ``ray_tpu/train/jax``; its loop may start a group of its own
        (``prepare_mesh``). Ranks that share another process (a remote
        daemon's threads) cannot each hold a group: that raises."""
        import ray_tpu_torch
        metas = worker_group.execute("get_metadata")
        procs = {(m["hostname"], m["pid"]) for m in metas}
        if procs == {(socket.gethostname(), os.getpid())}:
            return
        if len(procs) < len(metas):
            raise RuntimeError(
                f"{len(metas)} ranks run in {len(procs)} processes "
                f"{sorted(procs)}; a process holds one torch.distributed "
                "group, so each rank needs a process of its own "
                '(ScalingConfig(runtime_env={"worker_process": True}))')
        hosts = {host for host, _ in procs}
        world = len(worker_group.workers)
        addr = "127.0.0.1" if len(hosts) == 1 else metas[0]["hostname"]
        port = str(ray_tpu_torch.get(
            worker_group.workers[0].torch_bind_store.remote(world)))
        env_refs = [
            worker.setup_env.remote({"MASTER_ADDR": addr, "MASTER_PORT": port,
                                     "RAY_TPU_WORLD_SIZE": str(world),
                                     "RAY_TPU_RANK": str(rank)})
            for rank, worker in enumerate(worker_group.workers)]
        # Real barrier: wait for every setup_env (and surface its errors) —
        # a follow-up call is not a barrier under max_concurrency > 1.
        ray_tpu_torch.get(env_refs)
        worker_group.execute("torch_distributed_init")


class TorchTrainer(DataParallelTrainer):
    """Train a PyTorch program on a gang of CUDA cards (one per worker
    unless ``gpus_per_worker`` says otherwise); on the CPU when the
    caller passes a ``ScalingConfig`` without ``use_gpu``."""

    _backend_config_cls = TorchBackendConfig

    def __init__(self, train_loop_per_worker, *,
                 train_loop_config: Optional[dict] = None,
                 backend_config: Optional[TorchBackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 **kwargs):
        super().__init__(train_loop_per_worker,
                         train_loop_config=train_loop_config,
                         backend_config=backend_config,
                         scaling_config=(scaling_config
                                         or ScalingConfig(use_gpu=True)),
                         **kwargs)


__all__ = ["TorchBackendConfig", "TorchTrainer", "bind_store",
           "distributed_init_if_needed", "prepare_mesh"]
