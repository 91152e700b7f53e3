"""Where the port's tensors live.

Counterpart of the CPU pin in ``ray_tpu/_private/worker_process.py``
(which keeps JAX off the chip in worker processes): here the choice is
explicit at every entry point. ``None`` means the CUDA card, and asking
for the card on a host without one is an error rather than a silent move
to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

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
