"""Pieces the port's models share: the rounding of JAX's python scalars,
block rematerialisation, and the limits that raise until the ROADMAP's
items 12 and 13."""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint


def as_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the operand a python scalar becomes
    in a JAX op on an array of that dtype (torch would keep it in fp32)."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def checkpointed(fn, remat: bool):
    """``fn`` checkpointed while gradients are recorded and ``remat`` is
    set: only its inputs are saved and the backward recomputes it, as
    ``jax.checkpoint`` with ``nothing_saveable`` does."""
    if remat and torch.is_grad_enabled():
        return partial(checkpoint, fn, use_reentrant=False)
    return fn


def check_unplaced(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "placing the diffusion UNet, ViT, BERT or T5 on a mesh waits "
            "for ROADMAP.md queue 1, item 13")


def check_unstacked(rules) -> None:
    if rules.layers is not None:
        raise NotImplementedError(
            f"rules.layers={rules.layers!r} (the stacked layer axis over "
            f"pipeline stages) waits for ROADMAP.md queue 1, item 12")
