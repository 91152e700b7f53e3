"""Training entry points of the port: ``train.torch``, the rank-level
counterpart of ``ray_tpu/train/jax``."""
