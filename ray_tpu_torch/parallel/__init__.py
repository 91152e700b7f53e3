"""Training of the port on one device: ``train_step`` (the counterpart of
``ray_tpu/parallel/train_step.py``) and ``optim`` (optax's rules as plain
functions on tensors). Meshes and sharding rules are a later slice."""

from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                               init_train_state,
                                               make_eval_step,
                                               make_train_step,
                                               memory_efficient_optimizer)

__all__ = ["default_optimizer", "init_train_state", "make_eval_step",
           "make_train_step", "memory_efficient_optimizer"]
