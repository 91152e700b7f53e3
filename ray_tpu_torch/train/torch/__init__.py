"""The rank-level part of ``ray_tpu/train/jax/__init__.py``: start the
process group and build the training mesh inside one worker.

``distributed_init_if_needed`` takes the place of
``jax.distributed.initialize``: it starts ``torch.distributed``'s process
group once, from an explicit ``tcp://`` address. A gang that spawns the
workers sets ``MASTER_ADDR``/``MASTER_PORT`` (the names Ray's torch
backend sets) and ``RAY_TPU_WORLD_SIZE``/``RAY_TPU_RANK``; with none of
them set the process is a world of its own, one rank on a free loopback
port, as one JAX process is on one host. The backend follows the device
the caller names: NCCL for the card, gloo for ``device="cpu"``. The gang
itself (``JaxBackendConfig``, ``_JaxBackend``) needs the task/actor
runtime and waits for it (``ROADMAP.md`` queue 1, item 7).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from ray_tpu_torch._private.device import DeviceLike, resolve_device

ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RAY_TPU_WORLD_SIZE",
            "RAY_TPU_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def distributed_init_if_needed(device: DeviceLike = None) -> None:
    """Start the process group once, over ``device``'s type (the card
    unless ``"cpu"`` is asked for); a no-op when one exists."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    given = {k: os.environ[k] for k in ENV_VARS if k in os.environ}
    if not given:
        addr, port, world, rank = "127.0.0.1", _free_port(), 1, 0
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
                            init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)


def prepare_mesh(mesh_config=None, device: DeviceLike = None):
    """The training mesh inside one worker: the process group (started if
    needed), then ``build_mesh(mesh_config or MeshConfig())``."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    distributed_init_if_needed(device)
    return build_mesh(mesh_config or MeshConfig(), device)


__all__ = ["distributed_init_if_needed", "prepare_mesh"]
