"""Where the port's tensors live.

Counterpart of the CPU pin in ``ray_tpu/_private/worker_process.py``
(which keeps JAX off the chip in worker processes): here the choice is
explicit at every entry point. ``None`` means the CUDA card, and asking
for the card on a host without one is an error rather than a silent move
to the CPU.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``. Raises ``RuntimeError`` for a CUDA device when
    CUDA is unavailable; ``"cpu"`` must be asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run on the CPU")
    return dev


# The 32-bit type JAX gives a numpy array of each 64-bit type while its
# 64-bit types are off, as they are by default.
_X32 = {np.dtype(np.float64): np.dtype(np.float32),
        np.dtype(np.int64): np.dtype(np.int32),
        np.dtype(np.uint64): np.dtype(np.uint32),
        np.dtype(np.complex128): np.dtype(np.complex64)}


def jax_dtype(dtype) -> np.dtype:
    """The dtype ``jnp.asarray`` or ``jax.device_put`` gives an array of
    ``dtype`` with JAX's default settings: a 64-bit type becomes its 32-bit
    one, any other stays."""
    dtype = np.dtype(dtype)
    return _X32.get(dtype, dtype)


def to_host(x: Any) -> np.ndarray:
    """``x`` as a numpy array on the host: a tensor, on the card too, is
    copied there as ``np.asarray`` copies a JAX device array. numpy has no
    bfloat16, so a bfloat16 tensor comes as its float32 values, exactly,
    where ``np.asarray`` of a JAX bfloat16 array gives ml_dtypes'
    bfloat16."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()
