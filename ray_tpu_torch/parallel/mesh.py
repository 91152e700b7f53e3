"""Device mesh construction: the counterpart of ``ray_tpu/parallel/mesh.py``.

The JAX package expresses all intra-model parallelism as one
``jax.sharding.Mesh`` with named axes. The port builds the same mesh as a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the current
process group, one device per rank, with the same axis names in the same
order:

* ``dp``   — data parallelism (parameters replicated, gradients summed);
* ``fsdp`` — fully-sharded data parallelism (FSDP2 ``fully_shard``);
* ``tp``   — tensor parallelism on heads, MLP and vocab (DTensor);
* ``sp`` — sequence parallelism (ring or Ulysses attention, the batch's
  columns split when ``rules.sequence == "sp"``);
* ``ep`` — expert parallelism (each rank holds a block of the experts);
* ``pp`` — pipeline stages (``parallel/pipeline.py``); a model whose
  ``rules.layers`` is None is replicated over it.

Ranks are laid out row-major over ``AXIS_ORDER`` (``init_device_mesh``'s
layout), so ``dp`` is outermost: with ``slices > 1`` each slice is a
contiguous block of ranks, as the reference's fallback splits devices.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device

AXIS_ORDER = ("dp", "fsdp", "tp", "sp", "ep", "pp")
# Axes over which a batch is sharded.
BATCH_AXES = ("dp", "fsdp")


@dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis; -1 means "fill with remaining devices".

    Axis order follows ICI-locality best practice: the innermost axes (tp,
    sp) get the most tightly coupled devices, dp/fsdp span slices/hosts (the
    scaling-book recipe: model axes ride ICI, data axes can ride DCN).
    """

    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    #: Slices (groups of hosts) joined by the slower network. The dp axis
    #: is the one that crosses the slice boundary — gradient reductions
    #: cross it once per step while fsdp/tp/sp collectives stay inside a
    #: slice. dp must be a multiple of `slices`.
    slices: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        fills = [a for a, s in sizes.items() if s == -1]
        if len(fills) > 1:
            raise ValueError(f"Only one axis may be -1, got {fills}")
        known = math.prod(s for s in sizes.values() if s != -1)
        if fills:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known}")
            sizes[fills[0]] = n_devices // known
        total = math.prod(sizes.values())
        if total != n_devices:
            raise ValueError(
                f"Mesh axes {sizes} use {total} devices but {n_devices} "
                "are available")
        if self.slices > 1 and sizes["dp"] % self.slices != 0:
            raise ValueError(
                f"dp={sizes['dp']} must be a multiple of slices="
                f"{self.slices}: the dp axis is the one crossing the "
                "DCN slice boundary")
        return MeshConfig(**sizes, slices=self.slices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    def shape(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @property
    def batch_shards(self) -> int:
        return self.dp * self.fsdp


def build_mesh(config: Optional[MeshConfig] = None,
               device: DeviceLike = None):
    """A ``DeviceMesh`` of ``config`` (resolved over the world size) with
    the axis names of ``AXIS_ORDER``, one rank per device of
    ``device``'s type (the card unless ``"cpu"`` is asked for). The
    process group must already exist:
    ``ray_tpu_torch.train.torch.distributed_init_if_needed`` starts one."""
    from torch.distributed.device_mesh import init_device_mesh

    if not torch.distributed.is_initialized():
        raise RuntimeError(
            "build_mesh needs a torch.distributed process group; call "
            "ray_tpu_torch.train.torch.distributed_init_if_needed() (or "
            "prepare_mesh) first")
    dev = resolve_device(device)
    config = (config or MeshConfig()).resolve(
        torch.distributed.get_world_size())
    return init_device_mesh(dev.type, config.shape(),
                            mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device: DeviceLike = None):
    """A 1-rank mesh with all axes size 1 — lets the same sharded program
    run unmodified on one device."""
    return build_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1), device)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a mesh built by :func:`build_mesh`."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# -- current-mesh registry ----------------------------------------------
# Ops that need the ambient mesh (ring and Ulysses attention, the MoE
# layer's counts and aux term) read it here, with the rules that say how
# the step's batch lies on it. make_train_step / make_eval_step make both
# current for the length of each call (registered_mesh) and then restore
# what was current before, so a forward outside a step never inherits a
# step's layout.

_CURRENT_MESH = None
_CURRENT_RULES = None


def set_current_mesh(mesh, rules=None) -> None:
    global _CURRENT_MESH, _CURRENT_RULES
    _CURRENT_MESH, _CURRENT_RULES = mesh, rules


@contextlib.contextmanager
def registered_mesh(mesh, rules=None):
    """Make ``mesh`` and ``rules`` current for the body, then restore
    what was current before."""
    before = (_CURRENT_MESH, _CURRENT_RULES)
    set_current_mesh(mesh, rules)
    try:
        yield
    finally:
        set_current_mesh(*before)


def current_mesh():
    return _CURRENT_MESH


def current_rules():
    """The rules of the current mesh's batch, or None (the batch is
    whole on every rank)."""
    return _CURRENT_RULES


__all__ = ["AXIS_ORDER", "BATCH_AXES", "MeshConfig", "build_mesh",
           "current_mesh", "current_rules", "mesh_sizes", "registered_mesh",
           "set_current_mesh", "single_device_mesh"]
