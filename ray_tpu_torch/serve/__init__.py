"""ray_tpu_torch.serve: the port's serving engines.

Holds :class:`ContinuousBatcher`, the iteration-level decode engine of
``ray_tpu.serve``, and ``batch`` (``@serve.batch``), which coalesces
concurrent calls of an async function into one call on a list. The
deployment/controller runtime of ``ray_tpu.serve`` is framework-neutral
and is not part of this package.
"""

from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.continuous_batching import ContinuousBatcher

__all__ = ["ContinuousBatcher", "batch"]
