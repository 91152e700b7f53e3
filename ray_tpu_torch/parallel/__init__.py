"""Training of the port: the mesh (``mesh``), the sharding rules and how
a model is placed by them (``sharding``: FSDP2 over ``dp``/``fsdp``,
DTensor tensor parallelism over ``tp``), ``train_step`` (the counterpart
of ``ray_tpu/parallel/train_step.py``) and ``optim`` (optax's rules as
plain functions on tensors). The pipeline (``make_pipeline_fn``,
``sequential_apply``, ``stage_param_specs``) waits for ``ROADMAP.md``
queue 1, item 8."""

from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, MeshConfig, build_mesh,
                                         single_device_mesh)
from ray_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                             context_parallel_rules,
                                             dp_rules, fsdp_rules,
                                             placements, shard_model,
                                             shard_tree, tp_fsdp_rules)
from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                               init_train_state,
                                               make_eval_step,
                                               make_train_step,
                                               memory_efficient_optimizer)

__all__ = [
    "AXIS_ORDER",
    "MeshConfig",
    "PartitionSpec",
    "ShardingRules",
    "build_mesh",
    "context_parallel_rules",
    "default_optimizer",
    "dp_rules",
    "fsdp_rules",
    "init_train_state",
    "make_eval_step",
    "make_train_step",
    "memory_efficient_optimizer",
    "placements",
    "shard_model",
    "shard_tree",
    "single_device_mesh",
    "tp_fsdp_rules",
]
