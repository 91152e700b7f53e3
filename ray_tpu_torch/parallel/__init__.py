"""Training of the port: the mesh (``mesh``), the sharding rules and how
a model is placed by them (``sharding``: FSDP2 over ``dp``/``fsdp``,
DTensor tensor parallelism over ``tp``), ``train_step`` (the counterpart
of ``ray_tpu/parallel/train_step.py``), ``optim`` (optax's rules as
plain functions on tensors), the differentiable collectives of sequence,
expert and pipeline parallelism (``collectives``) and the GPipe pipeline
(``pipeline``)."""

from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, MeshConfig, build_mesh,
                                         single_device_mesh)
from ray_tpu_torch.parallel.pipeline import (make_pipeline_fn,
                                             sequential_apply,
                                             stage_param_specs)
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
    "make_pipeline_fn",
    "make_train_step",
    "memory_efficient_optimizer",
    "placements",
    "sequential_apply",
    "shard_model",
    "shard_tree",
    "single_device_mesh",
    "stage_param_specs",
    "tp_fsdp_rules",
]
