"""Ulysses sequence parallelism: all-to-all between a sequence split and a
head split — the port of ``ray_tpu/ops/ulysses.py``.

    [B, S/sp, H, D]  --all_to_all-->  [B, S, H/sp, D]
    (sequence split)                  (whole sequence, heads split)

so each rank runs exact whole-sequence attention for its group of heads,
and the inverse all-to-all restores the sequence split. Heads and KV
heads must divide over the axis.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import current_mesh


def _full_causal_attention(q, k, v):
    """Exact fp32-softmax causal attention on whole sequences.
    q, k, v: [B, S, H, D] (H = the local group of heads)."""
    B, S, H, D = q.shape
    kvh = k.shape[2]
    if kvh != H:
        rep = H // kvh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check_heads(q, k, seq_axis: str, sp: int) -> None:
    if q.shape[2] % sp or k.shape[2] % sp:
        raise ValueError(
            f"Ulysses needs n_heads divisible by {seq_axis} size {sp}; "
            f"got q heads {q.shape[2]}, kv heads {k.shape[2]}")


def ulysses_attention(q, k, v, seq_axis: str = "sp",
                      inner: Optional[Callable] = None, mesh=None):
    """One rank's part (the body of the reference's ``shard_map``): q, k,
    v are its blocks ``[B, S/sp, H|KVH, D]`` of a sequence split over
    ``mesh``'s ``seq_axis`` (default: the current mesh) → ``[B, S/sp, H,
    D]``."""
    inner = inner or _full_causal_attention
    mesh = current_mesh() if mesh is None else mesh
    shard = collectives.axis_shard(mesh, seq_axis)
    _check_heads(q, k, seq_axis, 1 if shard is None else shard.size)

    def scatter_heads(x):  # [B, S/sp, H, D] → [B, S, H/sp, D]
        return collectives.all_to_all(x, shard, 2, 1)

    o = inner(scatter_heads(q), scatter_heads(k), scatter_heads(v))
    return collectives.all_to_all(o, shard, 1, 2)


def make_ulysses_attention(mesh, seq_axis: str = "sp",
                           batch_spec=("dp", "fsdp"),
                           inner: Optional[Callable] = None) -> Callable:
    """Returns attention(q, k, v) over whole ``[B, S, H, D]`` inputs held
    alike by every rank, split as ``P(batch_spec, seq_axis)`` and
    gathered back (the reference's ``shard_map``). Requires n_heads (and
    kv heads) divisible by the ``seq_axis`` size; ``inner`` defaults to
    exact causal attention."""
    from ray_tpu_torch.parallel.sharding import PartitionSpec

    sp = mesh[seq_axis].size()
    spec = PartitionSpec(batch_spec, seq_axis, None, None)

    def attention(q, k, v):
        _check_heads(q, k, seq_axis, sp)
        out = ulysses_attention(
            *(collectives.split_by_spec(x, mesh, spec) for x in (q, k, v)),
            seq_axis, inner, mesh)
        return collectives.gather_by_spec(out, mesh, spec)

    return attention


__all__ = ["make_ulysses_attention", "ulysses_attention"]
