"""ray_tpu_torch.serve: the port's serving engine.

Holds :class:`ContinuousBatcher`, the iteration-level decode engine of
``ray_tpu.serve``. The deployment/controller runtime of ``ray_tpu.serve``
is framework-neutral and is not part of this package.
"""

from ray_tpu_torch.serve.continuous_batching import ContinuousBatcher

__all__ = ["ContinuousBatcher"]
