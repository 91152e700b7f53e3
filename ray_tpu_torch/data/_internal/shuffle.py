"""Push-based two-stage shuffle.

Analog of the reference's data/_internal/push_based_shuffle.py (Exoshuffle)
and shuffle.py: a *map* stage partitions every input block into
``num_output`` sub-blocks (random, hash, or range partitioning), a *reduce*
stage concatenates sub-block j from every map task into output block j.
All movement is object-store refs; reduce tasks start as soon as their
inputs exist (task-level pipelining — the push-based property).
"""

from __future__ import annotations

import random
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata


def _partition_block(block: Block, num_out: int, mode: str,
                     key, seed, boundaries) -> List[Block]:
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    if n == 0:
        return [acc.slice(0, 0) for _ in range(num_out)]
    if mode == "random":
        rng = np.random.default_rng(seed)
        assignment = rng.integers(0, num_out, n)
    elif mode == "hash":
        vals = acc.column_values(key)
        assignment = np.array([hash(v) % num_out for v in vals])
    elif mode == "range":
        vals = acc.column_values(key)
        assignment = np.searchsorted(boundaries, vals, side="right")
    elif mode == "split":
        # Contiguous equal split (repartition without shuffling rows).
        assignment = (np.arange(n) * num_out) // n
    else:
        raise ValueError(mode)
    parts = []
    for j in range(num_out):
        idx = np.nonzero(assignment == j)[0]
        parts.append(acc.take(idx.tolist()))
    return parts


def _reduce_blocks(*parts: Block) -> Tuple[Block, BlockMetadata]:
    out = BlockAccessor.concat(list(parts))
    return out, BlockAccessor.for_block(out).get_metadata()


_part_task_cache = {}


def _partition_task(num_out: int):
    # SPREAD (reference: data map tasks use the SPREAD strategy): shuffle
    # stages must fan across nodes — default hybrid-pack would pile every
    # map on one daemon and no data would ever ride the inter-node plane.
    key_ = num_out
    if key_ not in _part_task_cache:
        _part_task_cache[key_] = ray_tpu_torch.remote(_partition_block).options(
            num_returns=num_out, scheduling_strategy="SPREAD")
    return _part_task_cache[key_]


_reduce_task = None


def _get_reduce_task():
    global _reduce_task
    if _reduce_task is None:
        _reduce_task = ray_tpu_torch.remote(_reduce_blocks).options(
            num_returns=2, scheduling_strategy="SPREAD")
    return _reduce_task


def shuffle_blocks(
    blocks: List[Any],
    num_output: Optional[int] = None,
    mode: str = "random",
    key=None,
    seed: Optional[int] = None,
    boundaries=None,
) -> Tuple[List[Any], List[BlockMetadata]]:
    """Run the 2-stage shuffle; returns (block_refs, metadata)."""
    if not blocks:
        return [], []
    num_output = num_output or len(blocks)
    part_task = _partition_task(num_output)
    base_seed = seed if seed is not None else random.randrange(2**31)
    # Map stage: each input block → num_output partition refs.
    partials: List[List[Any]] = []
    for i, b in enumerate(blocks):
        refs = part_task.remote(b, num_output, mode, key, base_seed + i,
                                boundaries)
        if num_output == 1:
            refs = [refs]
        partials.append(refs)
    # Reduce stage: column j across all map outputs → output block j.
    reduce_task = _get_reduce_task()
    out_blocks, meta_refs = [], []
    for j in range(num_output):
        b_ref, m_ref = reduce_task.remote(*[p[j] for p in partials])
        out_blocks.append(b_ref)
        meta_refs.append(m_ref)
    return out_blocks, ray_tpu_torch.get(meta_refs)


def sort_blocks(blocks: List[Any], key=None, descending: bool = False
                ) -> Tuple[List[Any], List[BlockMetadata]]:
    """Distributed sort: sample boundaries, range-partition, sort partitions.

    Reference: data/_internal/sort.py (sample → range partition → merge).
    """
    if not blocks:
        return [], []
    num_out = len(blocks)

    def _sample(block, key=key):
        acc = BlockAccessor.for_block(block)
        return acc.sample_keys(10, key)

    sample_task = ray_tpu_torch.remote(_sample)
    samples = [s for ref in [sample_task.remote(b) for b in blocks]
               for s in ray_tpu_torch.get(ref)]
    if not samples:
        return blocks, [BlockAccessor.for_block(ray_tpu_torch.get(b)).get_metadata()
                        for b in blocks]
    samples.sort(reverse=False)
    q = np.linspace(0, len(samples) - 1, num_out + 1)[1:-1].astype(int)
    boundaries = [samples[i] for i in q]

    shuffled, _ = shuffle_blocks(blocks, num_out, mode="range", key=key,
                                 boundaries=np.array(boundaries))

    def _sort_local(block, key=key, descending=descending):
        return BlockAccessor.for_block(block).sort_by(key, descending)

    sort_task = ray_tpu_torch.remote(_sort_local)
    sorted_refs = [sort_task.remote(b) for b in shuffled]
    if descending:
        sorted_refs = sorted_refs[::-1]
    metas = [BlockAccessor.for_block(b).get_metadata()
             for b in ray_tpu_torch.get(sorted_refs)]
    return sorted_refs, metas
