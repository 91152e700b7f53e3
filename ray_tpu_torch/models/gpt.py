"""GPT family — ``ray_tpu/models/gpt.py`` in PyTorch: forward, loss,
rematerialisation, the mixture-of-experts FFN and sequence-parallel
attention.

Same configuration fields and presets, same parameter shapes and names
(layers are a ``ModuleList`` here, where the JAX package stacks them on a
leading axis for ``lax.scan``), same numerics:

* rotary embeddings on a prefix of each head, rotating its two halves;
* the GPT-J parallel block (one LayerNorm feeding attention and MLP);
* LayerNorm in fp32, cast back to the activation dtype;
* parameters kept in ``param_dtype`` and cast to ``cfg.dtype`` at each
  use, as the JAX code's ``.astype(dt)`` does;
* the tanh form of GELU (``jax.nn.gelu``'s default);
* the -1e30 causal mask fill of the dot attention.

``attn_impl="flash"`` runs attention through the port's flash kernels
(``ops/flash_attention.py``: K1 forward, K2/K3 backward). :func:`loss_fn`
is the JAX package's next-token cross-entropy, chunked over the vocab
head when ``loss_chunk`` is set. With ``remat`` each block is
checkpointed (non-reentrant ``torch.utils.checkpoint``, with or without
a mesh) while gradients are recorded: ``"full"`` saves only the block's
input and recomputes the block in the backward; ``"selective"`` also
keeps, through the checkpoint's ``context_fn`` (:class:`_Kept`), the
outputs of the block's projections and of the flash forward, so the
backward recomputes only the cheap elementwise work.

With ``n_experts > 0`` every block's FFN is the reference's top-k routed
MoE (:func:`_moe_ffn`: capacity drop in (sequence, k) order, dense
one-hot dispatch and combine, the Switch load-balancing term, which
:func:`loss_fn` adds as ``router_aux_weight * aux``). On a mesh the
experts are split over ``ep``; where the step splits the sequence over
``sp`` (``rules.sequence == "sp"``), rotary positions are global,
``attn_impl="ring"`` and ``"ulysses"`` run ``ops/ring_attention.py`` and
``ops/ulysses.py`` on each rank's block, and dot or flash attention runs
over the gathered sequence.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import (build, ce_stats, check_unstacked,
                                          draw, embed, loss_and_metrics,
                                          sequence_span)
from ray_tpu_torch.models._params import (leaf_groups, load_jax_params,
                                          to_jax_params)
from ray_tpu_torch.ops import ring_attention as ring
from ray_tpu_torch.ops import ulysses
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import current_mesh
from ray_tpu_torch.parallel.sharding import (AxisShard, PartitionSpec,
                                             ShardingRules, all_reduce,
                                             ep_local, from_tp, gather_tp,
                                             local, to_tp, tp_local)


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50400
    n_layers: int = 28
    d_model: int = 4096
    n_heads: int = 16
    n_kv_heads: Optional[int] = None  # != n_heads → GQA/MQA
    d_ff: int = 16384
    max_seq_len: int = 2048
    rotary_dim: int = 64  # GPT-J applies rotary to a prefix of head_dim
    parallel_block: bool = True  # GPT-J parallel attn+MLP residual
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    # Training: block rematerialisation and the chunked loss head.
    remat: bool = True
    remat_policy: str = "full"  # "full" | "selective"
    loss_chunk: int = 0
    attn_impl: str = "dot"  # "dot" | "flash" | "ring" | "ulysses"
    # Flash tile sizes: _pick_block decides from them whether the kernel
    # or the ragged (blockwise) route runs.
    attn_blk_q: int = 512
    attn_blk_k: int = 512
    layernorm_eps: float = 1e-5
    # Mixture-of-experts: n_experts > 0 replaces every block's dense FFN
    # with a top-k routed MoE FFN (experts split over the "ep" mesh axis).
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def num_params(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        kvh = self.kv_heads * self.head_dim
        if self.n_experts:
            ffn = self.n_experts * (2 * d * f + f) + d * self.n_experts
        else:
            ffn = 2 * d * f + f
        per_layer = d * d + 2 * d * kvh + d * d + ffn + d + 2 * d
        head = 0 if self.tie_embeddings else v * d + v
        return v * d + L * per_layer + 2 * d + head


# -- presets ------------------------------------------------------------

PRESETS: Dict[str, GPTConfig] = {
    # EleutherAI/gpt-j-6b hyperparameters.
    "gptj-6b": GPTConfig(),
    "gpt-410m": GPTConfig(
        vocab_size=50304, n_layers=24, d_model=1024, n_heads=16,
        d_ff=4096, rotary_dim=32, max_seq_len=1024),
    "gpt2-124m": GPTConfig(
        vocab_size=50304, n_layers=12, d_model=768, n_heads=12, d_ff=3072,
        rotary_dim=32, max_seq_len=1024),
    # GPT-Neo-1.3B widths.
    "gpt-1.3b": GPTConfig(
        vocab_size=50304, n_layers=24, d_model=2048, n_heads=16,
        d_ff=8192, rotary_dim=64, max_seq_len=1024),
    # GPT-Neo-2.7B widths.
    "gpt-2.7b": GPTConfig(
        vocab_size=50304, n_layers=32, d_model=2560, n_heads=32,
        d_ff=10240, rotary_dim=64, max_seq_len=1024),
    # Test-size configs.
    "gpt-tiny": GPTConfig(
        vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
        rotary_dim=8, max_seq_len=128, dtype=torch.float32, remat=False),
    "gpt-micro": GPTConfig(
        vocab_size=512, n_layers=4, d_model=128, n_heads=8, d_ff=512,
        rotary_dim=16, max_seq_len=256, dtype=torch.float32, remat=False),
    # MoE variants (expert parallelism over the "ep" mesh axis).
    "gpt-moe-tiny": GPTConfig(
        vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
        rotary_dim=8, max_seq_len=128, dtype=torch.float32, remat=False,
        n_experts=4),
    "gpt-moe-8x410m": GPTConfig(
        vocab_size=50304, n_layers=24, d_model=1024, n_heads=16,
        d_ff=4096, rotary_dim=32, max_seq_len=1024, n_experts=8),
}


def config(name: str, **overrides) -> GPTConfig:
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg


def flops_per_token(cfg: GPTConfig) -> float:
    """Approximate training FLOPs/token (6N_active + attention quadratic
    term); for MoE only the top-k routed experts count."""
    n = cfg.num_params()
    if cfg.is_moe:
        d, f, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_experts
        K = min(cfg.expert_top_k, E)
        n -= L * (E - K) * (2 * d * f + f)
    attn = 12 * cfg.n_layers * cfg.d_model * cfg.max_seq_len
    return 6.0 * n + attn


# -- numerics -----------------------------------------------------------

def _layernorm(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _rotary_tables(positions, rotary_dim, dtype):
    """(cos, sin) of each position's rotary angles, ``[B, S, 1,
    rotary_dim / 2]`` in ``dtype`` (None without rotary): built once a
    forward from positions ``[B, S]``, read by every block's
    :func:`_rotary`."""
    if rotary_dim == 0:
        return None
    half = rotary_dim // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(
        half, dtype=torch.float32, device=positions.device) / half))
    angles = positions[..., None].float() * freqs  # [B, S, half]
    return (torch.cos(angles)[:, :, None, :].to(dtype),
            torch.sin(angles)[:, :, None, :].to(dtype))


def _rotary(x, tables, rotary_dim):
    """Rotary embedding on the first ``rotary_dim`` dims of each head,
    rotating the prefix's two halves against each other (as the JAX
    package's ``_rotary`` computes). x: [B, S, H, D], tables: from
    :func:`_rotary_tables` in x's dtype."""
    if rotary_dim == 0:
        return x
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    cos, sin = tables
    x1, x2 = rot[..., :half], rot[..., half:]
    rot_out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot_out, rest], dim=-1)


def _dot_attention(q, k, v):
    """Causal attention; fp32 softmax. q,k,v: [B, S, H, D]/[B, S, KVH, D]."""
    B, S, H, D = q.shape
    kvh = k.shape[2]
    if kvh != H:  # GQA: repeat KV heads
        rep = H // kvh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = logits.float()
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check_local_heads(q, k, cfg) -> None:
    """On a tp mesh q and k hold this rank's heads; the grouping of query
    heads over KV heads must stay the model's."""
    if q.shape[2] * cfg.kv_heads != k.shape[2] * cfg.n_heads:
        raise ValueError(
            f"{q.shape[2]} local query heads over {k.shape[2]} KV heads "
            f"break the model's grouping of {cfg.n_heads} over "
            f"{cfg.kv_heads}: shard heads and kv_heads over one axis that "
            f"divides {cfg.kv_heads}")


def _sequence_parallel_attention(q, k, v, impl: str):
    """``attn_impl`` "ring" or "ulysses" over the current mesh's ``sp``
    axis: on each rank's block where the step splits the sequence over
    it, else on the whole sequence, split and gathered as the reference's
    ``shard_map`` does."""
    mesh = current_mesh()
    if mesh is None or "sp" not in mesh.mesh_dim_names:
        raise ValueError(
            f"attn_impl={impl!r} needs a registered mesh with an 'sp' axis "
            f"(parallel.mesh.registered_mesh; make_train_step/"
            f"make_eval_step do this automatically)")
    split = collectives.batch_layout(batch_spec)[1] is not None
    if impl == "ring":
        if split:
            return ring.ring_attention(q, k, v, "sp", True, mesh)
        return ring.make_ring_attention(mesh, "sp", True)(q, k, v)
    if split:
        return ulysses.ulysses_attention(q, k, v, "sp", mesh=mesh)
    return ulysses.make_ulysses_attention(mesh, "sp", None)(q, k, v)


def _attention(q, k, v, cfg: GPTConfig):
    """Causal attention on plain tensors (on a mesh, this rank's heads)."""
    return _dispatch_attention(q, k, v, cfg, _local_attention)


def _dispatch_attention(q, k, v, cfg, local_attention):
    """``attn_impl`` "ring" and "ulysses" (GPT's and Llama's), else
    ``local_attention(q, k, v, cfg)``: where the step splits the sequence
    over sp, over the whole gathered sequence, keeping this rank's
    rows."""
    _check_local_heads(q, k, cfg)
    if cfg.attn_impl in ("ring", "ulysses"):
        return _sequence_parallel_attention(q, k, v, cfg.attn_impl)
    seq = collectives.batch_layout(batch_spec)[1]
    if seq is None:
        return local_attention(q, k, v, cfg)
    S = q.shape[1]
    q, k, v = (collectives.gather_sum(x, seq, 1) for x in (q, k, v))
    return local_attention(q, k, v, cfg).narrow(1, seq.index * S, S)


def _local_attention(q, k, v, cfg: GPTConfig):
    if cfg.attn_impl == "dot":
        return _dot_attention(q, k, v)
    if cfg.attn_impl == "flash":
        kept = _KEPT
        return flash_attention(q, k, v, True, cfg.attn_blk_q, cfg.attn_blk_k,
                               None if kept is None else kept.take)
    raise ValueError(f"Unknown attn_impl {cfg.attn_impl!r}")


# -- rematerialisation --------------------------------------------------

def _alias(value):
    """``value`` (a tensor, None, or a tuple of them) as new tensors on the
    same storage, with no autograd history."""
    if isinstance(value, tuple):
        return tuple(_alias(v) for v in value)
    return None if value is None else value.detach()


class _Kept:
    """What remat_policy="selective" keeps of one block: the output of
    every projection (q, k, v, output and FFN; among them the attn_q,
    attn_k, attn_v and ffn_in the JAX package names, taken before rotary)
    and the flash forward's (out, lse) (attn_raw). :meth:`contexts` is
    the block's ``checkpoint`` ``context_fn``: in the forward
    :meth:`take` runs what it is given and keeps the result; in the
    recompute of the backward it hands the kept results back in order,
    and the rest reruns: LayerNorm, rotary, GELU and the casts, dot
    attention and the MoE layer, with their collectives in the forward's
    order. Only the calls that ask for it (:func:`_matmul`, the flash
    forward) see it: nothing runs per operator, and the backward is the
    forward's own graph, as under "full"."""

    def __init__(self):
        self.values = []
        self.index = None  # the next value to hand back, in the recompute

    def take(self, compute):
        """``compute()``, kept, in the forward; what it returned there, in
        the recompute."""
        if self.index is None:
            value = compute()
            self.values.append(_alias(value))
            return value
        self.index += 1
        return _alias(self.values[self.index - 1])

    @contextlib.contextmanager
    def _running(self, recompute: bool):
        global _KEPT
        outer, _KEPT = _KEPT, self
        self.index = 0 if recompute else None
        try:
            yield
        finally:
            _KEPT = outer

    @classmethod
    def contexts(cls):
        kept = cls()
        return kept._running(False), kept._running(True)


_KEPT: Optional[_Kept] = None  # of the selective block being run


class _KeptProduct(torch.autograd.Function):
    """In a selective block's recompute, ``out``: the output of ``a2 @ b``
    (``a`` folded to 2-D) that the block's forward kept. The backward runs
    the forward's graph, whose product (aten's ``mm``) reads what the
    recompute saves in its place, matched by order: so this saves what
    that ``mm`` saved, ``b`` when ``a2`` needs a gradient, then ``a2``
    when ``b`` does. Its own graph is dropped undifferentiated."""

    @staticmethod
    def forward(ctx, a2, b, out):
        ctx.save_for_backward(*([b] if a2.requires_grad else []),
                              *([a2] if b.requires_grad else []))
        return out

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a selective block's recompute is not "
                           "differentiated")


def _matmul(a, b):
    """``a @ b`` for a ``[..., K]`` by a ``[K, N]``; in a block under
    remat_policy="selective", the product kept in its forward and taken
    back in its recompute."""
    kept = _KEPT
    if kept is None:
        return a @ b
    out = kept.take(lambda: a @ b)
    if kept.index is None:  # the forward: the product is in its graph
        return out
    return _KeptProduct.apply(a.reshape(-1, a.shape[-1]), b, out)


def _remat_block(block: "Block", cfg: GPTConfig):
    """``block`` under the config's remat policy (the JAX package's
    ``hidden_states``), through one non-reentrant ``checkpoint`` with or
    without a mesh (on a mesh the block is an FSDP2 unit, whose hooks see
    an ordinary forward and backward): "full" keeps the block's input
    alone, "selective" also what :class:`_Kept` names. The block as it is
    when remat is off or nothing records gradients."""
    if not cfg.remat:
        return block
    if cfg.remat_policy not in ("full", "selective"):
        raise ValueError(f"Unknown remat_policy {cfg.remat_policy!r}; "
                         "expected 'full' or 'selective'")
    if not torch.is_grad_enabled():
        return block
    if cfg.remat_policy == "selective":
        return partial(checkpoint, block, use_reentrant=False,
                       preserve_rng_state=False, context_fn=_Kept.contexts)
    return partial(checkpoint, block, use_reentrant=False,
                   preserve_rng_state=False)


# -- modules ------------------------------------------------------------

def _empty(shape, cfg: GPTConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                    device=device))


class Block(nn.Module):
    """One transformer block; parameter names and shapes are those of one
    layer of the JAX package's stacked ``params["layers"]``."""

    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        h, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.ln1_scale = _empty((d,), cfg, device)
        self.ln1_bias = _empty((d,), cfg, device)
        self.wq = _empty((d, h, hd), cfg, device)
        self.wk = _empty((d, kvh, hd), cfg, device)
        self.wv = _empty((d, kvh, hd), cfg, device)
        self.wo = _empty((h, hd, d), cfg, device)
        self.b_out = _empty((d,), cfg, device)
        if cfg.is_moe:
            E = cfg.n_experts
            self.router = _empty((d, E), cfg, device)
            self.w_in = _empty((E, d, f), cfg, device)
            self.b_in = _empty((E, f), cfg, device)
            self.w_out = _empty((E, f, d), cfg, device)
        else:
            self.w_in = _empty((d, f), cfg, device)
            self.b_in = _empty((f,), cfg, device)
            self.w_out = _empty((f, d), cfg, device)
        if not cfg.parallel_block:
            self.ln2_scale = _empty((d,), cfg, device)
            self.ln2_bias = _empty((d,), cfg, device)

    def forward(self, x, rotary, cfg: GPTConfig):
        """x: [B, S, d] → ([B, S, d], the MoE aux term or None); rotary:
        the forward's :func:`_rotary_tables`. On a tp mesh the heads and
        the MLP columns of this rank's blocks; the residual stream is
        whole."""
        dt = cfg.dtype
        B, S, d = x.shape
        h = _layernorm(x, local(self.ln1_scale), local(self.ln1_bias),
                       cfg.layernorm_eps)
        wq, heads = tp_local(self.wq)
        h_attn = to_tp(h, heads)

        def proj(w):  # [d, heads, hd] → [B, S, heads, hd]
            w = local(w)
            return _matmul(h_attn, w.to(dt).reshape(d, -1)).view(
                B, S, w.shape[1], w.shape[2])

        q = _rotary(proj(wq), rotary, cfg.rotary_dim)
        k = _rotary(proj(self.wk), rotary, cfg.rotary_dim)
        v = proj(self.wv)
        attn = _attention(q, k, v, cfg)
        attn_out = from_tp(_matmul(attn.reshape(B, S, -1),
                                   local(self.wo).to(dt).reshape(-1, d)),
                           heads)

        if not cfg.parallel_block:
            x = x + attn_out
            h = _layernorm(x, local(self.ln2_scale), local(self.ln2_bias),
                           cfg.layernorm_eps)
        aux = None
        if cfg.is_moe:
            mlp_out, aux = _moe_ffn(cfg, h, self)
        else:
            w_in, mlp = tp_local(self.w_in)
            # GPT-J: the shared LN feeds both branches; through one entry
            # into the tp region when both are split, so that its gradient
            # sums in the order it does without a mesh.
            mlp_in = (h_attn if cfg.parallel_block
                      and (heads is None) == (mlp is None) else to_tp(h, mlp))
            ff = F.gelu(_matmul(mlp_in, w_in.to(dt))
                        + local(self.b_in).to(dt), approximate="tanh")
            mlp_out = from_tp(_matmul(ff, local(self.w_out).to(dt)), mlp)
        mlp_out = mlp_out + local(self.b_out).to(dt)
        if cfg.parallel_block:
            return x + attn_out + mlp_out, aux
        return x + mlp_out, aux


def _moe_ffn(cfg: GPTConfig, h, block: Block):
    """The reference's ``_moe_ffn``: top-k routed mixture of experts with
    capacity-based token drop → (out ``[B, S, d]``, this rank's share of
    the load-balancing term).

    An assignment's slot in its expert's buffer counts in (sequence, k)
    order and assignments past the capacity ``C = max(1, int(capacity_
    factor * S * K / E))`` are dropped, on the global S: where the step
    splits the sequence over ``sp``, each rank's slots start after the
    per-expert counts of the ranks before it. Dispatch and combine are
    dense einsums against one-hot tensors. Over ``ep`` the router and the
    aux term are computed whole on every rank; each rank dispatches, runs
    and combines its own experts between the entry into the ``ep``
    region (``to_tp``: identity forward, the gradient summed over ``ep``
    backward), on ``h`` and the router's probabilities, and its exit
    (``from_tp``: the output summed over ``ep``).

    The aux term is ``E * Σ_e f_e · p_e`` (f: the share of tokens whose
    top-1 choice is e; p: the mean router probability of e) over the
    global batch: f is summed over the ranks the batch is split over, and
    each rank's share takes its own p, so that the shares sum to it over
    those ranks. Profiler ranges name the routing and the one-hot
    dispatch and combine tensors (``moe.route``), the dispatch einsum
    (``moe.dispatch``), the experts (``moe.experts``) and the combine
    einsum (``moe.combine``)."""
    dt = cfg.dtype
    with record_function("moe.route"):
        (probs, gate_idx, onehot, keep, cap_onehot, ep, mlp,
         groups) = _moe_route(cfg, h, block)
        gate_vals = torch.gather(to_tp(probs, ep), -1, gate_idx)
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
        dispatch = (keep[..., None] * cap_onehot).sum(2)  # [B, S, E, C]
        combine = (gate_vals[..., None, None] * keep[..., None]
                   * cap_onehot).sum(2)
    with record_function("moe.dispatch"):
        x_e = to_tp(torch.einsum("bsec,bsd->ebcd", dispatch.to(dt),
                                 to_tp(h, ep)), mlp)
    with record_function("moe.experts"):
        w_in = tp_local(block.w_in)[0]
        y = torch.einsum("ebcd,edf->ebcf", x_e, w_in.to(dt))
        y = F.gelu(y + local(block.b_in)[:, None, None, :].to(dt),
                   approximate="tanh")
        y = from_tp(torch.einsum("ebcf,efd->ebcd", y,
                                 local(block.w_out).to(dt)), mlp)
    with record_function("moe.combine"):
        out = from_tp(torch.einsum("bsec,ebcd->bsd", combine.to(dt), y),
                      ep)

    B, S, _ = h.shape
    E = cfg.n_experts
    n = B * S
    f_e = onehot[:, :, 0, :].sum((0, 1))
    for g in groups:
        f_e = all_reduce(f_e, g.group)
        n *= g.size
    aux = E * torch.sum((f_e / n) * (probs.sum((0, 1)) / n))
    return out, aux


def _moe_route(cfg: GPTConfig, h, block: Block):
    """:func:`_moe_ffn`'s routing: (the router's fp32 probabilities, each
    token's top-k experts, their one-hot ``[B, S, K, E]``, which of them
    keep a slot and that slot's one-hot ``[B, S, K, E here, C]`` for this
    rank's experts, how the experts split over ``ep`` and their FFN over
    ``tp``, the axes the batch is split over)."""
    B, S, d = h.shape
    E = cfg.n_experts
    K = min(cfg.expert_top_k, E)
    groups, seq = collectives.batch_layout(batch_spec)
    C = max(1, int(cfg.capacity_factor * S * (seq.size if seq else 1) * K
                   / E))

    probs = torch.softmax(h.float() @ local(block.router).float(), dim=-1)
    # Ties go to the lower expert index, as lax.top_k's.
    gate_idx = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True).indices[..., :K]  # [B, S, K]
    onehot = F.one_hot(gate_idx, E).float()  # [B, S, K, E]
    flat = onehot.reshape(B, S * K, E)
    pos = torch.cumsum(flat, dim=1) - flat
    if seq is not None:
        counts = [torch.empty((B, E), device=h.device)
                  for _ in range(seq.size)]
        torch.distributed.all_gather(counts, flat.sum(1), group=seq.group)
        for c in counts[:seq.index]:
            pos = pos + c[:, None, :]
    pos = pos.reshape(B, S, K, E)

    w_in, mlp = tp_local(block.w_in)
    ep = ep_local(block.w_in)
    El = w_in.shape[0]
    mine = slice(0, E) if ep is None else slice(ep.index * El,
                                                (ep.index + 1) * El)
    keep = (onehot * (pos < C))[..., mine]
    cap_onehot = F.one_hot(pos[..., mine].clamp_max(C - 1).long(),
                           C).float()
    return probs, gate_idx, onehot, keep, cap_onehot, ep, mlp, groups


class GPT(nn.Module):
    """The GPT model. Parameters are allocated uninitialised; build one
    with :func:`init` (random) or :func:`from_jax_params` (carried over
    from the JAX package)."""

    jax_stacks = {"layers": "blocks"}
    # On a mesh (sharding.shard_model): FSDP2's units, and loss_fn's entry.
    fsdp_methods = ("hidden_states",)

    def fsdp_units(self):
        return tuple(self.blocks)

    def __init__(self, cfg: GPTConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        d, v = cfg.d_model, cfg.vocab_size
        self.cfg = cfg
        self.wte = _empty((v, d), cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.lnf_scale = _empty((d,), cfg, dev)
        self.lnf_bias = _empty((d,), cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _empty((d, v), cfg, dev)
            self.lm_head_bias = _empty((v,), cfg, dev)

    def hidden_states(self, tokens, positions=None):
        """tokens [B, S] int → (final-layernormed hidden [B, S, d], aux).
        :func:`loss_fn` enters the model here; on a mesh it is an FSDP
        forward method (``shard_model``), so the root's parameters are
        gathered around it."""
        return self._hidden_states(tokens, positions)

    def _hidden_states(self, tokens, positions=None):
        if positions is None:
            positions = _positions(tokens)
        x = embed(tokens, self.wte).to(self.cfg.dtype)
        rotary = _rotary_tables(positions, self.cfg.rotary_dim, x.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x, a = _remat_block(block, self.cfg)(x, rotary, self.cfg)
            if a is not None:
                aux = aux + a
        x = _layernorm(x, local(self.lnf_scale), local(self.lnf_bias),
                       self.cfg.layernorm_eps)
        # The summed MoE load-balancing term (0 for a dense model); where
        # the step splits the batch, this rank's share of it.
        return x, aux

    def _head(self, x) -> Tuple[torch.Tensor, Optional[AxisShard]]:
        """(logits: on a mesh this rank's block of the vocab, how the
        vocab is split over tp or None)."""
        dt = self.cfg.dtype
        if self.cfg.tie_embeddings:
            w, vocab = tp_local(self.wte)
            return to_tp(x, vocab) @ w.to(dt).T, vocab
        w, vocab = tp_local(self.lm_head)
        return (to_tp(x, vocab) @ w.to(dt)
                + local(self.lm_head_bias).to(dt)), vocab

    def forward_with_aux(self, tokens, positions=None):
        """tokens [B, S] → (logits [B, S, vocab] in cfg.dtype, aux)."""
        x, aux = self._hidden_states(tokens, positions)
        logits, vocab = self._head(x)
        return gather_tp(logits, vocab), aux

    def forward(self, tokens, positions=None):
        """tokens [B, S] int → logits [B, S, vocab] (compute dtype)."""
        return self.forward_with_aux(tokens, positions)[0]


def _positions(tokens):
    """Each token's position in its sequence, ``[B, S]``: global where
    the step splits the sequence over ``sp`` (this rank holds block
    ``index`` of it)."""
    B, S = tokens.shape
    start = sequence_span(S, collectives.batch_layout(batch_spec)[1])[0]
    return (start + torch.arange(S, device=tokens.device)).expand(B, S)


# -- loss ---------------------------------------------------------------

def loss_fn(model: GPT, tokens, targets, mask=None, z_loss: float = 0.0,
            batch_groups=()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32 (+ optional z-loss, and for a MoE
    config ``router_aux_weight`` times the load-balancing term) → (loss,
    {"loss", "accuracy", "perplexity"}), all 0-d tensors on the model's
    device; perplexity is that of the cross-entropy alone.

    With ``cfg.loss_chunk > 0`` the head matmul and fp32 softmax run per
    chunk of tokens under a checkpoint, so one chunk's fp32 logits exist
    at a time (in the backward too); a chunk that does not divide B·S is
    lowered to its largest divisor, as in the JAX package.

    ``batch_groups`` are the process groups the batch is split over (on a
    mesh, those of its batch axes): the loss divides this rank's sum by
    the global mask count, as the JAX package's ``mask.sum()`` over the
    global batch, and the metrics are the global ones."""
    cfg = model.cfg
    x, aux = model.hidden_states(tokens)
    B, S = tokens.shape
    if mask is None:
        mask32 = torch.ones((B, S), dtype=torch.float32, device=x.device)
    else:
        mask32 = mask.float()

    def chunk_stats(x_c, t_c, m_c):
        logits, vocab = model._head(x_c)
        return ce_stats(logits, t_c, m_c, z_loss, vocab)

    T = B * S
    chunk = cfg.loss_chunk
    if chunk and T % chunk and T > chunk:
        chunk = max(c for c in range(1, chunk + 1) if T % c == 0)
    if chunk and T > chunk:
        nll_sum = hit_sum = torch.zeros((), dtype=torch.float32,
                                        device=x.device)
        xf = x.reshape(T // chunk, chunk, x.shape[-1])
        tf = targets.reshape(T // chunk, chunk)
        mf = mask32.reshape(T // chunk, chunk)
        for x_c, t_c, m_c in zip(xf, tf, mf):
            if torch.is_grad_enabled():
                nll_c, hit_c = checkpoint(chunk_stats, x_c, t_c, m_c,
                                          use_reentrant=False)
            else:
                nll_c, hit_c = chunk_stats(x_c, t_c, m_c)
            nll_sum = nll_sum + nll_c
            hit_sum = hit_sum + hit_c
    else:
        nll_sum, hit_sum = chunk_stats(x, targets, mask32)
    return loss_and_metrics(nll_sum, hit_sum, mask32, batch_groups,
                            aux if cfg.is_moe else None,
                            cfg.router_aux_weight)


# -- parameters ---------------------------------------------------------

def param_specs(cfg: GPTConfig, rules: ShardingRules) -> Dict[str, Any]:
    """PartitionSpecs of the model's parameters, after
    ``ray_tpu/models/gpt.py``'s ``param_specs``: the root's tensors by
    name, and under ``"layers"`` each layer's tensors by leaf name, with
    the JAX leaf's spec less its leading ``layers`` entry (the port's
    layers are a ``ModuleList``, not a stacked axis)."""
    check_unstacked(rules)
    r = rules
    layers = {
        "ln1_scale": r.spec("embed"),
        "ln1_bias": r.spec("embed"),
        "wq": r.spec("embed", "heads", "head_dim"),
        "wk": r.spec("embed", "kv_heads", "head_dim"),
        "wv": r.spec("embed", "kv_heads", "head_dim"),
        "wo": r.spec("heads", "head_dim", "embed"),
        "b_out": r.spec("embed"),
    }
    if cfg.is_moe:
        layers["router"] = r.spec("embed", None)
        layers["w_in"] = r.spec("expert", "embed", "mlp")
        layers["b_in"] = r.spec("expert", "mlp")
        layers["w_out"] = r.spec("expert", "mlp", "embed")
    else:
        layers["w_in"] = r.spec("embed", "mlp")
        layers["b_in"] = r.spec("mlp")
        layers["w_out"] = r.spec("mlp", "embed")
    if not cfg.parallel_block:
        layers["ln2_scale"] = r.spec("embed")
        layers["ln2_bias"] = r.spec("embed")
    specs = {
        "wte": r.spec("vocab", "embed"),
        "layers": layers,
        "lnf_scale": r.spec("embed"),
        "lnf_bias": r.spec("embed"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = r.spec("embed", "vocab")
        specs["lm_head_bias"] = r.spec("vocab")
    return specs


def batch_spec(rules: ShardingRules) -> PartitionSpec:
    return rules.spec("batch", "sequence")


def init(cfg: GPTConfig, generator: torch.Generator,
         device: DeviceLike = None, mesh=None,
         rules: Optional[ShardingRules] = None) -> GPT:
    """A model with the JAX package's init distributions (GPT-2-style
    scaled normal: std 0.02, output projections 0.02/sqrt(2L); LayerNorm
    scales 1, biases 0), drawn from ``generator``, which must live on
    ``device``. The draws differ from ``jax.random``'s for the same seed.
    With ``mesh`` the model is placed there by :func:`param_specs` of
    ``rules`` (default ``ShardingRules()``) and holds the same global
    values."""
    model = build(GPT, param_specs, cfg, device, mesh, rules)
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)
    normal = {"wte": std, "lm_head": std, "wq": std, "wk": std, "wv": std,
              "w_in": std, "router": std, "wo": out_std, "w_out": out_std}
    return draw(model, generator, normal,
                lambda leaf: 1.0 if leaf.endswith("_scale") else 0.0)


def from_jax_params(params: Dict[str, Any], cfg: GPTConfig,
                    device: DeviceLike = None) -> GPT:
    """The port's model holding exactly the values of ``params``: the
    nested dict that ``ray_tpu.models.gpt.init`` returns, with numpy
    leaves and layers stacked on a leading ``[L, ...]`` axis. Values are
    copied into ``cfg.param_dtype`` (exact when the leaves are of that
    dtype)."""
    return load_jax_params(GPT(cfg, device), params)


__all__ = ["GPT", "GPTConfig", "PRESETS", "Block", "batch_spec", "config",
           "flops_per_token", "from_jax_params", "init", "leaf_groups",
           "loss_fn", "param_specs", "to_jax_params"]
