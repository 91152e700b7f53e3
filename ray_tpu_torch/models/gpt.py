"""GPT family — the dense path of ``ray_tpu/models/gpt.py`` in PyTorch:
forward, loss and rematerialisation.

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
checkpointed (``torch.utils.checkpoint``) while gradients are recorded:
``"full"`` saves only the block's input and recomputes the block in the
backward; ``"selective"`` also keeps the outputs of the block's matmuls
and of the flash forward, so the backward recomputes only the cheap
elementwise work. The MoE FFN and ring/Ulysses attention belong to later
slices of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.flash_attention import _flash_forward, flash_attention
from ray_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                             TPShard, all_reduce, from_tp,
                                             gather_tp, local, local_block,
                                             shard_model, to_tp, tp_local)


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
    # Mixture-of-experts (a later slice of the port).
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
    # MoE variants (their FFN is a later slice of the port).
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


def _rotary(x, positions, rotary_dim):
    """Rotary embedding on the first ``rotary_dim`` dims of each head,
    rotating the prefix's two halves against each other (as the JAX
    package's ``_rotary`` computes). x: [B, S, H, D], positions: [B, S]."""
    if rotary_dim == 0:
        return x
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(
        half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
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


def _attention(q, k, v, cfg: GPTConfig):
    """Causal attention on plain tensors (on a mesh, this rank's heads)."""
    _check_local_heads(q, k, cfg)
    if cfg.attn_impl == "dot":
        return _dot_attention(q, k, v)
    if cfg.attn_impl == "flash":
        return _recorded(
            lambda: _flash_forward(q, k, v, True, cfg.attn_blk_q,
                                   cfg.attn_blk_k),
            lambda saved: flash_attention(q, k, v, True, cfg.attn_blk_q,
                                          cfg.attn_blk_k, saved),
            lambda: flash_attention(q, k, v, True, cfg.attn_blk_q,
                                    cfg.attn_blk_k))
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} (sequence parallelism) is a later "
            f"slice of the port; use 'dot' or 'flash'")
    raise ValueError(f"Unknown attn_impl {cfg.attn_impl!r}")


# -- rematerialisation --------------------------------------------------

class _Recording:
    """What remat_policy="selective" keeps of one block: the output of
    every matmul (the q, k, v, output and FFN projections; among them the
    attn_q, attn_k, attn_v and ffn_in the JAX package names, taken before
    rotary) and the flash forward's (out, lse) (attn_raw). The forward
    appends them; the backward's replay takes them back in order."""

    def __init__(self):
        self.outputs = []
        self.replaying = False


_RECORDING: Optional[_Recording] = None  # of the block being run


def _recorded(compute, replay, plain):
    """Under a selective block: ``compute()``, kept, in its forward;
    ``replay(kept value)`` in its backward. Else ``plain()``."""
    rec = _RECORDING
    if rec is None:
        return plain()
    if rec.replaying:
        return replay(rec.outputs.pop(0))
    value = compute()
    rec.outputs.append(value)
    return value[0] if isinstance(value, tuple) else value


class _KeptMatmul(torch.autograd.Function):
    """``a @ b`` for a ``[..., K]`` by a ``[K, N]`` whose value was kept:
    returns it, and differentiates the product."""

    @staticmethod
    def forward(ctx, a, b, out):
        ctx.save_for_backward(a, b)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gb = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ b.T, gb, None


def _matmul(a, b):
    return _recorded(lambda: a @ b,
                     lambda out: _KeptMatmul.apply(a, b, out),
                     lambda: a @ b)


class _SelectiveBlock(torch.autograd.Function):
    """One block under remat_policy="selective". The forward runs it
    without a graph and keeps its input and a :class:`_Recording`; the
    backward replays it with the kept values handed back, so it recomputes
    LayerNorm, rotary, GELU and the casts (and dot attention), but no
    matmul and no K1, and differentiates the replay."""

    @staticmethod
    def forward(ctx, block, cfg, positions, x, *params):
        global _RECORDING
        rec = _Recording()
        _RECORDING = rec
        try:
            y = block(x, positions, cfg)
        finally:
            _RECORDING = None
        ctx.block, ctx.cfg, ctx.recording = block, cfg, rec
        ctx.save_for_backward(positions, x)
        return y

    @staticmethod
    def backward(ctx, grad):
        global _RECORDING
        positions, x = ctx.saved_tensors
        params = list(ctx.block.parameters())
        ctx.recording.replaying = True
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            _RECORDING = ctx.recording
            try:
                y = ctx.block(x, positions, ctx.cfg)
            finally:
                _RECORDING = None
            grads = torch.autograd.grad(y, [x] + params, grad)
        return (None, None, None, *grads)


def _remat_block(block: "Block", cfg: GPTConfig):
    """``block`` under the config's remat policy (the JAX package's
    ``hidden_states``): the block as it is when remat is off or nothing
    records gradients."""
    if not cfg.remat:
        return block
    if cfg.remat_policy not in ("full", "selective"):
        raise ValueError(f"Unknown remat_policy {cfg.remat_policy!r}; "
                         "expected 'full' or 'selective'")
    if not torch.is_grad_enabled():
        return block
    if cfg.remat_policy == "selective":
        return lambda x, positions, cfg: _SelectiveBlock.apply(
            block, cfg, positions, x, *block.parameters())
    return partial(checkpoint, block, use_reentrant=False)


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
        self.w_in = _empty((d, f), cfg, device)
        self.b_in = _empty((f,), cfg, device)
        self.w_out = _empty((f, d), cfg, device)
        if not cfg.parallel_block:
            self.ln2_scale = _empty((d,), cfg, device)
            self.ln2_bias = _empty((d,), cfg, device)

    def forward(self, x, positions, cfg: GPTConfig):
        """x: [B, S, d] → [B, S, d]. On a tp mesh the heads and the MLP
        columns of this rank's blocks; the residual stream is whole."""
        dt = cfg.dtype
        B, S, d = x.shape
        h = _layernorm(x, local(self.ln1_scale), local(self.ln1_bias),
                       cfg.layernorm_eps)
        wq, heads = tp_local(self.wq)
        w_in, mlp = tp_local(self.w_in)
        h_attn = to_tp(h, heads)

        def proj(w):  # [d, heads, hd] → [B, S, heads, hd]
            w = local(w)
            return _matmul(h_attn, w.to(dt).reshape(d, -1)).view(
                B, S, w.shape[1], w.shape[2])

        q = _rotary(proj(wq), positions, cfg.rotary_dim)
        k = _rotary(proj(self.wk), positions, cfg.rotary_dim)
        v = proj(self.wv)
        attn = _attention(q, k, v, cfg)
        attn_out = from_tp(_matmul(attn.reshape(B, S, -1),
                                   local(self.wo).to(dt).reshape(-1, d)),
                           heads)

        if cfg.parallel_block:
            # GPT-J: the shared LN feeds both branches; through one entry
            # into the tp region when both are split, so that its gradient
            # sums in the order it does without a mesh.
            mlp_in = (h_attn if (heads is None) == (mlp is None)
                      else to_tp(h, mlp))
        else:
            x = x + attn_out
            mlp_in = to_tp(_layernorm(x, local(self.ln2_scale),
                                      local(self.ln2_bias),
                                      cfg.layernorm_eps), mlp)
        ff = F.gelu(_matmul(mlp_in, w_in.to(dt))
                    + local(self.b_in).to(dt), approximate="tanh")
        mlp_out = (from_tp(_matmul(ff, local(self.w_out).to(dt)), mlp)
                   + local(self.b_out).to(dt))
        if cfg.parallel_block:
            return x + attn_out + mlp_out
        return x + mlp_out


class GPT(nn.Module):
    """The GPT model. Parameters are allocated uninitialised; build one
    with :func:`init` (random) or :func:`from_jax_params` (carried over
    from the JAX package)."""

    def __init__(self, cfg: GPTConfig, device: DeviceLike = None):
        super().__init__()
        if cfg.is_moe:
            raise NotImplementedError(
                "MoE GPT configs (n_experts > 0) are a later slice of the "
                "port")
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
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        x = _embed(tokens, self.wte).to(self.cfg.dtype)
        for block in self.blocks:
            x = _remat_block(block, self.cfg)(x, positions, self.cfg)
        x = _layernorm(x, local(self.lnf_scale), local(self.lnf_bias),
                       self.cfg.layernorm_eps)
        # The MoE load-balancing term; 0 for the dense models served here.
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def _head(self, x) -> Tuple[torch.Tensor, Optional[TPShard]]:
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


def _embed(tokens, wte):
    """``F.embedding(tokens, wte)``; on a vocab split over tp, this rank's
    rows (zero for ids outside its block) summed over the group."""
    table, vocab = tp_local(wte)
    if vocab is None:
        return F.embedding(tokens, table)
    n = table.shape[0]
    ids = tokens - vocab.index * n
    inside = (ids >= 0) & (ids < n)
    rows = F.embedding(ids.clamp(0, n - 1), table)
    return from_tp(rows.masked_fill(~inside[..., None], 0.0), vocab)


# -- loss ---------------------------------------------------------------

def _ce_stats(logits, targets, mask, z_loss: float,
              vocab: Optional[TPShard] = None):
    """fp32 CE pieces for one [..., vocab] logits slab → (Σ nll·m, Σ hit·m);
    hits by first-max argmax, as ``jnp.argmax``. With ``vocab`` the slab
    is this rank's block of a vocab split over tp."""
    logits = logits.float()
    if vocab is None:
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        hits = logits.argmax(-1) == targets
    else:
        logz, tgt, hits = _vocab_parallel_stats(logits, targets, vocab)
    nll = logz - tgt
    if z_loss:
        nll = nll + z_loss * logz ** 2
    return (nll * mask).sum(), (hits.float() * mask).sum()


def _vocab_parallel_stats(logits, targets, vocab: TPShard):
    """(logsumexp, target logit, first-max argmax == target) over the
    whole vocab from this rank's block ``[start, start + n)`` of the
    logits: explicit max and sum reductions over tp, no gathered logits.
    On one rank each is the plain formula's value exactly."""
    n = logits.shape[-1]
    start = vocab.index * n
    lse = torch.logsumexp(logits, dim=-1)
    top = all_reduce(lse, vocab.group, torch.distributed.ReduceOp.MAX)
    logz = top + torch.log(from_tp(torch.exp(lse - top), vocab))
    ids = targets.long() - start
    inside = (ids >= 0) & (ids < n)
    tgt = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    tgt = from_tp(tgt.masked_fill(~inside, 0.0), vocab)
    arg = logits.detach().argmax(-1)
    best = torch.gather(logits.detach(), -1, arg[..., None])[..., 0]
    top_best = all_reduce(best, vocab.group, torch.distributed.ReduceOp.MAX)
    first = torch.where(best == top_best, arg + start, n * vocab.size)
    first = all_reduce(first, vocab.group, torch.distributed.ReduceOp.MIN)
    return logz, tgt, first == targets


def _batch_sum(x, groups):
    """``x`` summed over the process groups the batch is split over."""
    for group in groups:
        x = all_reduce(x, group)
    return x


def _loss_and_metrics(nll_sum, hit_sum, mask32, batch_groups):
    """(this rank's Σ nll over the global count of masked tokens, the
    global {"loss", "accuracy", "perplexity"}). Summed over the ranks of
    ``batch_groups``, the first is the global loss, so the gradients are
    summed over them, never averaged."""
    denom = torch.clamp_min(_batch_sum(mask32.sum(), batch_groups), 1.0)
    ce = nll_sum / denom
    loss = _batch_sum(nll_sum.detach(), batch_groups) / denom
    acc = _batch_sum(hit_sum.detach(), batch_groups) / denom
    # Perplexity from the cross-entropy alone, as in the JAX package.
    return ce, {"loss": loss, "accuracy": acc,
                "perplexity": torch.exp(torch.clamp_max(loss, 20.0))}


def loss_fn(model: GPT, tokens, targets, mask=None, z_loss: float = 0.0,
            batch_groups=()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32 (+ optional z-loss) → (loss,
    {"loss", "accuracy", "perplexity"}), all 0-d tensors on the model's
    device.

    With ``cfg.loss_chunk > 0`` the head matmul and fp32 softmax run per
    chunk of tokens under a checkpoint, so one chunk's fp32 logits exist
    at a time (in the backward too); a chunk that does not divide B·S is
    lowered to its largest divisor, as in the JAX package.

    ``batch_groups`` are the process groups the batch is split over (on a
    mesh, those of its batch axes): the loss divides this rank's sum by
    the global mask count, as the JAX package's ``mask.sum()`` over the
    global batch, and the metrics are the global ones."""
    cfg = model.cfg
    x, _ = model.hidden_states(tokens)
    B, S = tokens.shape
    if mask is None:
        mask32 = torch.ones((B, S), dtype=torch.float32, device=x.device)
    else:
        mask32 = mask.float()

    def chunk_stats(x_c, t_c, m_c):
        logits, vocab = model._head(x_c)
        return _ce_stats(logits, t_c, m_c, z_loss, vocab)

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
    return _loss_and_metrics(nll_sum, hit_sum, mask32, batch_groups)


# -- parameters ---------------------------------------------------------

def param_specs(cfg: GPTConfig, rules: ShardingRules) -> Dict[str, Any]:
    """PartitionSpecs of the model's parameters, after
    ``ray_tpu/models/gpt.py``'s ``param_specs``: the root's tensors by
    name, and under ``"layers"`` each layer's tensors by leaf name, with
    the JAX leaf's spec less its leading ``layers`` entry (the port's
    layers are a ``ModuleList``, not a stacked axis)."""
    if rules.layers is not None:
        raise NotImplementedError(
            f"rules.layers={rules.layers!r} (pipeline stages) waits for "
            f"ROADMAP.md queue 1, item 8")
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE GPT configs (n_experts > 0) are a later slice of the port "
            "(ROADMAP.md queue 1, item 8)")
    r = rules
    layers = {
        "ln1_scale": r.spec("embed"),
        "ln1_bias": r.spec("embed"),
        "wq": r.spec("embed", "heads", "head_dim"),
        "wk": r.spec("embed", "kv_heads", "head_dim"),
        "wv": r.spec("embed", "kv_heads", "head_dim"),
        "wo": r.spec("heads", "head_dim", "embed"),
        "b_out": r.spec("embed"),
        "w_in": r.spec("embed", "mlp"),
        "b_in": r.spec("mlp"),
        "w_out": r.spec("mlp", "embed"),
    }
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


def _placed(model_cls, cfg, device, mesh, specs) -> nn.Module:
    """``model_cls(cfg)`` with uninitialised parameters: on ``device``,
    or, with a mesh, allocated as placed there by ``specs``."""
    if mesh is None:
        return model_cls(cfg, device)
    model = shard_model(model_cls(cfg, "meta"), mesh, specs)
    return model.to_empty(device=resolve_device(device))


def _draw(model: nn.Module, generator: torch.Generator,
          stds: Dict[str, float], fill) -> nn.Module:
    """Each parameter whose leaf name is in ``stds`` drawn from N(0, std²)
    by ``generator`` whole, in ``named_parameters`` order, of which this
    rank keeps its block (all of it off a mesh); every other set to
    ``fill(leaf)``. So a mesh gives the same global values as one device
    with the same seed, and holds one whole tensor at a time."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in stds:
                draw = torch.randn(p.shape, generator=generator,
                                   dtype=torch.float32, device=p.device)
                local(p).copy_(local_block(draw.mul_(stds[leaf]), p))
            else:
                local(p).fill_(fill(leaf))
    return model


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
    specs = None if mesh is None else param_specs(
        cfg, rules or ShardingRules())
    model = _placed(GPT, cfg, device, mesh, specs)
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)
    normal = {"wte": std, "lm_head": std, "wq": std, "wk": std, "wv": std,
              "w_in": std, "wo": out_std, "w_out": out_std}
    return _draw(model, generator, normal,
                 lambda leaf: 1.0 if leaf.endswith("_scale") else 0.0)


def _assign(param: nn.Parameter, arr, name: str) -> None:
    t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                         f"the config's {tuple(param.shape)}")
    param.copy_(t)


def from_jax_params(params: Dict[str, Any], cfg: GPTConfig,
                    device: DeviceLike = None) -> GPT:
    """The port's model holding exactly the values of ``params``: the
    nested dict that ``ray_tpu.models.gpt.init`` returns, with numpy
    leaves and layers stacked on a leading ``[L, ...]`` axis. Values are
    copied into ``cfg.param_dtype`` (exact when the leaves are of that
    dtype)."""
    return _load_jax_params(GPT(cfg, device), params)


def _load_jax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy ``params`` (the JAX package's nested dict, layers stacked on a
    leading ``[L, ...]`` axis) into ``model``'s tensors and its
    ``blocks``; returns ``model``."""
    layers = params["layers"]
    with torch.no_grad():
        for name, p in model.named_parameters(recurse=False):
            _assign(p, params[name], name)
        for i, block in enumerate(model.blocks):
            for name, p in block.named_parameters():
                _assign(p, np.asarray(layers[name])[i], f"layers.{name}[{i}]")
    return model


def leaf_groups(model: nn.Module) -> Dict[str, List[str]]:
    """The JAX package's parameter leaves of ``model`` (a GPT, or any
    model of the port whose layers are its ``blocks``), each with the
    names of the port's tensors that hold it, in the structure
    :func:`to_jax_params` walks: ``"wte"`` → ``["wte"]``; a layer leaf
    such as ``"layers.wq"`` → ``["blocks.0.wq", ...,
    "blocks.{L-1}.wq"]``, the slices of its leading ``[L, ...]`` axis in
    order."""
    groups = {name: [name]
              for name, _ in model.named_parameters(recurse=False)}
    for name, _ in model.blocks[0].named_parameters():
        groups[f"layers.{name}"] = [f"blocks.{i}.{name}"
                                    for i in range(len(model.blocks))]
    return groups


def to_jax_params(model: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params` (for a GPT, or any model of
    the port whose layers are its ``blocks``): the JAX package's nested
    parameter dict with numpy leaves, layers stacked on a leading ``[L,
    ...]`` axis."""
    params = {name: p.detach().cpu().numpy()
              for name, p in model.named_parameters(recurse=False)}
    params["layers"] = {
        name: np.stack([dict(b.named_parameters())[name].detach().cpu()
                        .numpy() for b in model.blocks])
        for name, _ in model.blocks[0].named_parameters()}
    return params


__all__ = ["GPT", "GPTConfig", "PRESETS", "Block", "batch_spec", "config",
           "flops_per_token", "from_jax_params", "init", "leaf_groups",
           "loss_fn", "param_specs", "to_jax_params"]
