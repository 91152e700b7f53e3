"""Examples of the port, run as modules
(``python -m ray_tpu_torch.examples.<name>``): the counterparts of the
JAX package's ``examples/``."""
