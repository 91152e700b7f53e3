"""Ring attention: exact causal attention over a sequence split over a
mesh axis — the port of ``ray_tpu/ops/ring_attention.py``.

Each rank holds a contiguous block of the sequence's q, k and v. The
(k, v) pair travels the ring (``parallel.collectives.ppermute``) while
every rank folds each arriving block into its fp32 online-softmax
accumulators (``blockwise_attention.attention_chunk``), so the score
matrix never exceeds ``[B, H, S/n, S/n]``. Causality uses global
positions: blocks wholly in a query's future contribute nothing and the
result is the unsplit causal attention. Gradients come from autograd,
through ppermute's inverse permutation.
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.ops.blockwise_attention import _repeat_kv, attention_chunk
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import current_mesh


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = True,
                   mesh=None) -> torch.Tensor:
    """q, k, v: this rank's blocks ``[B, S_local, H|KVH, D]`` of a sequence
    split over ``mesh``'s ``axis_name`` (default: the current mesh) →
    ``[B, S_local, H, D]``. Step i holds the block of rank (my + i) mod n,
    received from the right neighbour."""
    mesh = current_mesh() if mesh is None else mesh
    shard = collectives.axis_shard(mesh, axis_name)
    n, my = (1, 0) if shard is None else (shard.size, shard.index)
    B, Sl, H, D = q.shape
    k, v = _repeat_kv(k, v, H)
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    qt = q.transpose(1, 2).float()
    kv = torch.stack([k.transpose(1, 2), v.transpose(1, 2)]).float()
    q_pos = my * Sl + torch.arange(Sl, device=dev)
    m = torch.full((B, H, Sl), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sl), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, Sl, D), dtype=torch.float32, device=dev)
    for i in range(n):
        src = (my + i) % n
        k_pos = src * Sl + torch.arange(Sl, device=dev)
        m, l, o = attention_chunk(qt, kv[0], kv[1], m, l, o, q_pos, k_pos,
                                  causal, scale)
        if i + 1 < n:  # the reference's last rotation is never read
            kv = collectives.ppermute(kv, shard, -1)
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = True):
    """``shard_map``'s wrapper: whole q, k, v in (held alike by every
    rank), whole output out, the sequence dim split over ``axis_name``
    (the reference's default specs)."""
    shard = collectives.axis_shard(mesh, axis_name)

    def fn(q, k, v):
        out = ring_attention(
            *(collectives.split_replicated(x, shard, 1) for x in (q, k, v)),
            axis_name, causal, mesh)
        return collectives.gather_replicated(out, shard, 1)

    return fn


__all__ = ["make_ring_attention", "ring_attention"]
