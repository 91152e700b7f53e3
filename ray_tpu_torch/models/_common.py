"""Pieces the port's models share: the rounding of JAX's python scalars,
block rematerialisation, the placing of a model on a mesh (:func:`build`,
:func:`draw`), the lookups as ``jnp.take`` and ``jnp.take_along_axis``
take them (the vocab-parallel embedding and cross-entropy), the losses'
global denominators over a batch split across ranks, and the limit that
raises (ROADMAP.md's item 12).

A model is placed by its module's ``param_specs`` (``parallel.sharding.
shard_model``). Inside a forward each rank then computes on its local
``tp`` blocks; a loss over a batch whose rows are split over the data
axes, and whose sequence is split over ``sp`` where the rules and the
model's ``batch_spec`` say so (``parallel.mesh.registered_mesh`` makes
the mesh and the rules current, ``parallel.collectives.batch_layout``
reads them), returns this rank's *share*: its own sum over the global
count. Summed over those ranks the shares are the global loss, as
GSPMD's mean over the global batch; FSDP2 averages the gradients over
the data ranks, so a caller steps on ``share * batch_blocks(batch_spec)``
and then sums the gradients over ``sp`` (``sharding.
average_replicated_grads`` with the model's ``batch_spec``), as
``parallel.train_step`` does.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import DeviceLike, resolve_device


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


def check_unstacked(rules) -> None:
    if rules.layers is not None:
        raise NotImplementedError(
            f"rules.layers={rules.layers!r} (the stacked layer axis over "
            f"pipeline stages) waits for ROADMAP.md queue 1, item 12")


# -- placing ------------------------------------------------------------

def build(model_cls, param_specs, cfg, device: DeviceLike = None, mesh=None,
          rules=None) -> nn.Module:
    """``model_cls(cfg)`` with uninitialised parameters: on ``device``,
    or, with a mesh, allocated as placed there by ``param_specs(cfg,
    rules)`` (default ``ShardingRules()``), each rank holding its blocks
    only. Every model's ``init`` and ``from_jax_params`` build here."""
    if mesh is None:
        return model_cls(cfg, device)
    from ray_tpu_torch.parallel.sharding import ShardingRules, shard_model
    specs = param_specs(cfg, rules or ShardingRules())
    model = shard_model(model_cls(cfg, "meta"), mesh, specs)
    return model.to_empty(device=resolve_device(device))


def draw(model: nn.Module, generator: torch.Generator,
         stds: Dict[str, float], fill) -> nn.Module:
    """Each parameter whose leaf name is in ``stds`` drawn from N(0, std²)
    by ``generator`` whole, in ``named_parameters`` order, of which this
    rank keeps its block (all of it off a mesh); every other set to
    ``fill(leaf)``. So a mesh gives the same global values as one device
    with the same seed, and holds one whole tensor at a time."""
    from ray_tpu_torch.parallel.sharding import local, local_block
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in stds:
                value = torch.randn(p.shape, generator=generator,
                                    dtype=torch.float32, device=p.device)
                local(p).copy_(local_block(value.mul_(stds[leaf]), p))
            else:
                local(p).fill_(fill(leaf))
    return model


# -- lookups, as jnp.take and jnp.take_along_axis ------------------------
#
# An id in [-n, 0) wraps to id + n; an id outside [-n, n) reads a NaN row
# (a NaN logit), and in the gradient adds to no row. On a vocab split over
# tp the same holds of the global vocab. The index that reaches a gather
# always lies in its table: on the card an index out of range trips a
# device-side assert, which ends the CUDA context.

def wrap_ids(ids, n: int):
    """(``ids`` taken into ``[0, n)``, as int64: those in ``[-n, 0)``
    wrapped to ``id + n``, those outside ``[-n, n)`` to some row whose
    value the caller replaces; which of them lay outside ``[-n, n)``)."""
    ids = ids.long()
    return ids.remainder(n), (ids < -n) | (ids >= n)


def _nan_where(x, outside):
    """``x`` with NaN where ``outside`` (broadcast from the left) holds;
    no gradient flows there."""
    outside = outside.reshape(outside.shape
                              + (1,) * (x.dim() - outside.dim()))
    return x.masked_fill(outside, float("nan"))


def embed(tokens, wte):
    """``jnp.take(wte, tokens, axis=0)``. On a vocab split over tp each
    rank takes its rows (zero for ids outside its block) and the group
    sums them; the NaN rows of ids outside the whole vocab come after the
    sum, so that no rank's partial sum, and no gradient the sum passes
    back, holds a NaN."""
    from ray_tpu_torch.parallel.sharding import from_tp, tp_local
    table, vocab = tp_local(wte)
    n = table.shape[0]
    if vocab is None:
        ids, outside = wrap_ids(tokens, n)
        return _nan_where(F.embedding(ids, table), outside)
    ids, outside = wrap_ids(tokens, n * vocab.size)
    ids = ids - vocab.index * n
    inside = (ids >= 0) & (ids < n)
    rows = F.embedding(ids.clamp(0, n - 1), table)
    return _nan_where(from_tp(rows.masked_fill(~inside[..., None], 0.0),
                              vocab), outside)


def ce_stats(logits, targets, mask, z_loss: float = 0.0, vocab=None,
             pick_log_probs: bool = False):
    """fp32 CE pieces for one [..., vocab] logits slab → (Σ nll·m, Σ hit·m);
    the target logit as ``jnp.take_along_axis`` takes it (so a target out
    of range gives a NaN nll), hits by first-max argmax against the target
    as given, as ``jnp.argmax(...) == targets``. With ``vocab`` (an
    ``AxisShard``) the slab is this rank's block of a vocab split over
    tp. ``pick_log_probs``: the nll is the target's entry of the
    log-softmax, as BERT's ``mlm_loss`` takes it, so a target out of range
    leaves its position no gradient at all (``logz - tgt`` keeps logz's)."""
    logits = logits.float()
    if vocab is None:
        logz = torch.logsumexp(logits, dim=-1)
        ids, outside = wrap_ids(targets, logits.shape[-1])
        tgt = _nan_where(torch.gather(logits, -1, ids[..., None])[..., 0],
                         outside)
        hits = logits.argmax(-1) == targets
    else:
        logz, tgt, hits = vocab_parallel_stats(logits, targets, vocab)
    nll = logz - tgt
    if pick_log_probs:
        n = logits.shape[-1] * (1 if vocab is None else vocab.size)
        nll = _nan_where(nll, wrap_ids(targets, n)[1])
    if z_loss:
        nll = nll + z_loss * logz ** 2
    return (nll * mask).sum(), (hits.float() * mask).sum()


def vocab_parallel_stats(logits, targets, vocab):
    """(logsumexp, target logit, first-max argmax == target) over the
    whole vocab from this rank's block ``[start, start + n)`` of the
    logits: explicit max and sum reductions over tp, no gathered logits.
    The target logit and the argmax follow ``jnp.take_along_axis`` and
    ``jnp.argmax`` (a NaN counts as the largest value). On one rank each
    is the plain formula's value exactly."""
    from ray_tpu_torch.parallel.sharding import all_reduce, from_tp
    max_op, min_op = torch.distributed.ReduceOp.MAX, \
        torch.distributed.ReduceOp.MIN
    n = logits.shape[-1]
    start = vocab.index * n
    lse = torch.logsumexp(logits, dim=-1)
    top = all_reduce(lse, vocab.group, max_op)
    logz = top + torch.log(from_tp(torch.exp(lse - top), vocab))
    ids, outside = wrap_ids(targets, n * vocab.size)
    ids = ids - start
    inside = (ids >= 0) & (ids < n)
    tgt = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    tgt = _nan_where(from_tp(tgt.masked_fill(~inside, 0.0), vocab), outside)
    arg = logits.detach().argmax(-1)  # this block's first NaN, if any
    best = torch.gather(logits.detach(), -1, arg[..., None])[..., 0]
    nan = best.isnan()
    # One max over the group of (any NaN here, the largest non-NaN).
    flag, top_best = all_reduce(torch.stack(
        [nan.float(), best.masked_fill(nan, -float("inf"))]), vocab.group,
        max_op)
    mine = torch.where(flag > 0, nan, best == top_best)
    first = torch.where(mine, arg + start, n * vocab.size)
    first = all_reduce(first, vocab.group, min_op)
    return logz, tgt, first == targets


# -- losses over a batch split across data ranks --------------------------

def batch_groups(batch_spec) -> Tuple:
    """The axes (``AxisShard``\\ s of more than one rank) the current
    step's batch is split over: its rows over the rules' batch axes and,
    where the model's ``batch_spec`` (``collectives.batch_layout``) puts
    its sequence on ``rules.sequence``, its columns over ``sp``; none
    outside a registered mesh (``parallel.mesh.registered_mesh``). A loss
    divides by its count over all of them."""
    from ray_tpu_torch.parallel import collectives
    return collectives.batch_layout(batch_spec)[0]


def batch_blocks(batch_spec) -> int:
    """How many blocks the rows of a batch laid out by the model's
    ``batch_spec`` are split into (1 off a mesh): the factor by which a
    step scales a loss share before FSDP2's average over the data ranks.
    The sequence's blocks are not among them: their gradients are summed
    over ``sp`` (``sharding.average_replicated_grads``)."""
    from ray_tpu_torch.parallel import collectives
    groups, seq = collectives.batch_layout(batch_spec)
    return _blocks(g for g in groups if g is not seq)


def _blocks(groups) -> int:
    n = 1
    for g in groups:
        n *= g.size
    return n


def batch_rows(n_local: int, groups) -> Tuple[int, slice]:
    """(the global batch's rows, this rank's rows of it), for a block of
    ``n_local`` rows split over ``groups`` (the row axes alone): the
    blocks lie row-major over the batch axes."""
    index = 0
    for g in groups:
        index = index * g.size + g.index
    return n_local * _blocks(groups), slice(index * n_local,
                                            (index + 1) * n_local)


def sequence_span(n_local: int, seq) -> Tuple[int, int]:
    """(the global position of this rank's first of its ``n_local``
    columns, the whole sequence's length): ``(0, n_local)`` unless the
    step splits the sequence over ``seq`` (``collectives.batch_layout``'s
    second value), whose ranks hold equal blocks in order."""
    if seq is None:
        return 0, n_local
    return seq.index * n_local, n_local * seq.size


def batch_sum(x, groups):
    """``x`` summed over the process groups the batch is split over."""
    from ray_tpu_torch.parallel.sharding import all_reduce
    for group in groups:
        x = all_reduce(x, group)
    return x


def loss_and_metrics(nll_sum, hit_sum, mask32, groups, aux=None,
                     aux_weight: float = 0.0):
    """(this rank's Σ nll over the global count of masked tokens, plus
    ``aux_weight`` times its share of the MoE aux term when there is one;
    the global {"loss", "accuracy", "perplexity"}). Summed over the ranks
    of ``groups``, the first is the global loss, so the gradients are
    summed over them, never averaged."""
    denom = torch.clamp_min(batch_sum(mask32.sum(), groups), 1.0)
    share = nll_sum / denom
    ce = batch_sum(nll_sum.detach(), groups) / denom
    acc = batch_sum(hit_sum.detach(), groups) / denom
    loss = ce
    if aux is not None:
        share = share + aux_weight * aux
        loss = ce + aux_weight * batch_sum(aux.detach(), groups)
    # Perplexity from the cross-entropy alone, as in the JAX package.
    return share, {"loss": loss, "accuracy": acc,
                   "perplexity": torch.exp(torch.clamp_max(ce, 20.0))}


def masked_ce(logits, targets, mask: Optional[torch.Tensor], vocab=None,
              pick_log_probs: bool = False, *, batch_spec
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The zoo's fp32 cross-entropy over ``mask`` (every item when None)
    of a batch that the current step may split over data ranks, and over
    ``sp`` where the model's ``batch_spec`` splits its sequence →
    (this rank's share, the global {"loss", "accuracy"});
    ``pick_log_probs`` as :func:`ce_stats`."""
    groups = batch_groups(batch_spec)
    mask32 = (torch.ones(targets.shape, dtype=torch.float32,
                         device=logits.device) if mask is None
              else mask.float())
    nll_sum, hit_sum = ce_stats(logits, targets, mask32, vocab=vocab,
                                pick_log_probs=pick_log_probs)
    share, m = loss_and_metrics(nll_sum, hit_sum, mask32,
                                [g.group for g in groups])
    return share, {"loss": m["loss"], "accuracy": m["accuracy"]}
