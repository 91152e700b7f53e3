"""T5-style encoder-decoder — ``ray_tpu/models/t5.py`` in PyTorch.

Same configuration fields and presets, parameter names and shapes (the
encoder's and the decoder's layers two ``ModuleList``s, where the JAX
package stacks each for ``lax.scan``), and numerics: pre-RMSNorm blocks
in fp32, cast back; T5's log-bucketed relative positions
(:func:`_relative_buckets`, computed on the CPU, where torch's fp32 log
gives the JAX package's buckets, and cached per device) whose bias table
is cast to the compute dtype and then to fp32; the attention scale in the
compute dtype before the fp32 softmax, the causal fill -1e30; the
gated-GELU feed-forward (tanh form); the tied head scaled by
``d_model ** -0.5`` in the compute dtype. With ``remat`` (the default)
each block is checkpointed while gradients are recorded.

On a mesh (:func:`init` or :func:`from_jax_params` with ``mesh``, placed
by :func:`param_specs`) self- and cross-attention compute on this rank's
``tp`` heads (the relative-bias tables on their columns of those heads)
and the FFN on its columns, as ``models/gpt.py``'s blocks; the embedding
takes the vocab-parallel lookup and the tied head gives this rank's block
of the vocab, whose cross-entropy :func:`loss_fn` reduces over tp and
divides by the global count of targets where the current step splits the
batch over the data ranks (``models/_common.py``). ``encode`` and
``decode`` read the root's parameters; they are methods that FSDP2
gathers around, as ``forward``.

Under rules that put the sequence on ``sp`` (``context_parallel_rules()``;
:func:`batch_spec` is ``("batch", "sequence")``, for the encoder's tokens
and the decoder's alike, whose lengths may differ) each rank holds a
block of every row's columns: self-attention takes its query rows against
keys and values gathered over ``sp``, with the relative buckets and the
decoder's causal mask at the rows' global positions; cross-attention
takes them against the encoder's output gathered over ``sp``;
:func:`loss_fn` counts the targets over the whole global batch. ``encode``,
``decode`` and ``forward`` return this rank's rows, and the step sums the
gradients over ``sp`` (``sharding.average_replicated_grads`` with
:func:`batch_spec`).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import (as_dtype, build, check_unstacked,
                                          checkpointed, draw, embed,
                                          masked_ce, sequence_span)
from ray_tpu_torch.models._params import (leaf_groups, load_jax_params,
                                          to_jax_params)
from ray_tpu_torch.models.gpt import _empty
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                             from_tp, gather_tp, local, to_tp,
                                             tp_local)


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 1024
    n_encoder_layers: int = 6
    n_decoder_layers: int = 6
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    layernorm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, f, h = self.d_model, self.d_ff, self.n_heads
        attn = 4 * d * d
        ffn = 3 * d * f  # gated: wi_0, wi_1, wo
        enc = self.n_encoder_layers * (attn + ffn + 2 * d)
        dec = self.n_decoder_layers * (2 * attn + ffn + 3 * d)
        rel = 2 * self.rel_pos_buckets * h  # enc + dec bias tables
        return self.vocab_size * d + enc + dec + rel + 2 * d


PRESETS: Dict[str, T5Config] = {
    "t5-small": T5Config(),
    "t5-base": T5Config(d_model=768, n_heads=12, d_ff=2048,
                        n_encoder_layers=12, n_decoder_layers=12),
    "t5-tiny": T5Config(vocab_size=256, d_model=64, n_heads=4, d_ff=128,
                        n_encoder_layers=2, n_decoder_layers=2,
                        rel_pos_buckets=8, rel_pos_max_distance=32,
                        dtype=torch.float32, remat=False),
}


def config(name: str, **overrides) -> T5Config:
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg


# -- numerics -----------------------------------------------------------

def _rmsnorm(x, scale, eps):
    x32 = x.float()
    var = (x32 ** 2).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _relative_buckets(rel_pos, bidirectional: bool, num_buckets: int,
                      max_distance: int):
    """T5's log-bucketed relative positions (t5x relative_position_bucket).
    ``rel_pos`` = q_pos - k_pos: positive = key in the past. The large
    buckets truncate an fp32 log to int, in the JAX package's order of
    operations."""
    ret = 0
    n = rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(n.float() / max_exact + 1e-6) / \
        math.log(max_distance / max_exact)
    large = max_exact + (log_ratio * (num_buckets - max_exact)).to(
        torch.int32)
    large = large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, large)


@functools.lru_cache(maxsize=32)
def _bucket_table(q_start: int, q_len: int, k_len: int, bidirectional: bool,
                  num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """The ``[Q, K]`` buckets of the queries at positions ``q_start ..
    q_start + Q - 1`` against the keys at ``0 .. K - 1``, computed on the
    CPU, on ``device``; a plain tensor even when first asked for under
    ``inference_mode``, so that a later forward that records gradients
    may index with it."""
    with torch.inference_mode(False):
        rel = (q_start + torch.arange(q_len))[:, None] - \
            torch.arange(k_len)[None, :]
        buckets = _relative_buckets(rel, bidirectional, num_buckets,
                                    max_distance)
        return buckets.long().to(device)


def _rel_bias(table, q_len: int, seq, bidirectional: bool, cfg: T5Config):
    """[1, H, Q, K] in the compute dtype for this rank's ``Q`` query rows
    against the whole sequence: on a tp mesh this rank's heads (the
    table's columns); where the sequence is split over ``seq``, the rows
    at their global positions and ``K = Q * seq.size``."""
    table = local(table)
    start, k_len = sequence_span(q_len, seq)
    buckets = _bucket_table(start, q_len, k_len, bidirectional,
                            cfg.rel_pos_buckets, cfg.rel_pos_max_distance,
                            table.device)
    bias = table[buckets]  # [Q, K, H]
    return bias.permute(2, 0, 1)[None].to(cfg.dtype)  # [1, H, Q, K]


# -- modules ------------------------------------------------------------

class Attention(nn.Module):
    """``wq``, ``wk``, ``wv`` [d, h, hd] and ``wo`` [h, hd, d]."""

    def __init__(self, cfg: T5Config, device):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.cfg = cfg
        for name in ("wq", "wk", "wv"):
            setattr(self, name, _empty((d, h, hd), cfg, device))
        self.wo = _empty((h, hd, d), cfg, device)

    def forward(self, q_in, kv_in, bias=None, causal: bool = False,
                seq=None):
        """On a tp mesh over this rank's heads (``bias`` over the same);
        the output summed. Self-attention passes ``q_in`` as ``kv_in``;
        with ``seq`` (its sequence split over ``sp``) its keys and values
        are gathered over the axis and the queries are this rank's rows,
        at their global positions for the causal mask."""
        dt = self.cfg.dtype
        wq, heads = tp_local(self.wq)
        self_attn = kv_in is q_in
        q_in = to_tp(q_in, heads)
        kv_in = q_in if self_attn else to_tp(kv_in, heads)
        q = torch.einsum("bsd,dhk->bshk", q_in, wq.to(dt))
        k, v = (collectives.gather_sum(torch.einsum(
            "bsd,dhk->bshk", kv_in, local(w).to(dt)), seq, 1)
            for w in (self.wk, self.wv))
        # The JAX package applies 1/sqrt(head_dim) explicitly (upstream T5
        # folds it into wq's init).
        scale = as_dtype(1.0 / math.sqrt(q.shape[-1]), dt)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()
        if bias is not None:
            logits = logits + bias.float()
        if causal:
            Q, K = logits.shape[-2], logits.shape[-1]
            keep = torch.ones((Q, K), dtype=torch.bool,
                              device=logits.device)
            keep = keep.tril(sequence_span(Q, seq)[0])
            logits = torch.where(keep, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return from_tp(torch.einsum("bshk,hkd->bsd", out,
                                    local(self.wo).to(dt)), heads)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.ln1 = _empty((d,), cfg, device)
        self.ln2 = _empty((d,), cfg, device)
        self.attn = Attention(cfg, device)
        self.wi_0 = _empty((d, f), cfg, device)
        self.wi_1 = _empty((d, f), cfg, device)
        self.wo_ff = _empty((f, d), cfg, device)

    def _ffn(self, x):
        dt = self.cfg.dtype
        wi_0, mlp = tp_local(self.wi_0)
        x = to_tp(x, mlp)
        gate = F.gelu(x @ wi_0.to(dt), approximate="tanh")
        up = x @ local(self.wi_1).to(dt)
        return from_tp((gate * up) @ local(self.wo_ff).to(dt), mlp)

    def forward(self, x, bias, seq=None):
        eps = self.cfg.layernorm_eps
        h = _rmsnorm(x, local(self.ln1), eps)
        x = x + self.attn(h, h, bias=bias, seq=seq)
        return x + self._ffn(_rmsnorm(x, local(self.ln2), eps))


class DecoderBlock(EncoderBlock):
    def __init__(self, cfg: T5Config, device):
        super().__init__(cfg, device)
        self.ln3 = _empty((cfg.d_model,), cfg, device)
        self.cross = Attention(cfg, device)

    def forward(self, x, enc_out, bias, seq=None):
        """``enc_out`` is the whole encoder sequence (gathered over
        ``sp`` where the step splits it)."""
        eps = self.cfg.layernorm_eps
        h = _rmsnorm(x, local(self.ln1), eps)
        x = x + self.attn(h, h, bias=bias, causal=True, seq=seq)
        x = x + self.cross(_rmsnorm(x, local(self.ln3), eps), enc_out)
        return x + self._ffn(_rmsnorm(x, local(self.ln2), eps))


class T5(nn.Module):
    """The encoder-decoder. Parameters are allocated uninitialised; build
    one with :func:`init` (random) or :func:`from_jax_params` (carried
    over from the JAX package)."""

    jax_stacks = {"encoder": "encoder", "decoder": "decoder"}
    # On a mesh (sharding.shard_model): FSDP2's units, the layers of both
    # stacks, and the entries besides forward that read the root's
    # parameters.
    fsdp_methods = ("encode", "decode")

    def fsdp_units(self):
        return (*self.encoder, *self.decoder)

    def __init__(self, cfg: T5Config, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        d, h = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.wte = _empty((cfg.vocab_size, d), cfg, dev)
        self.enc_rel_bias = _empty((cfg.rel_pos_buckets, h), cfg, dev)
        self.dec_rel_bias = _empty((cfg.rel_pos_buckets, h), cfg, dev)
        self.enc_final_ln = _empty((d,), cfg, dev)
        self.dec_final_ln = _empty((d,), cfg, dev)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, dev)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(DecoderBlock(cfg, dev)
                                     for _ in range(cfg.n_decoder_layers))

    def forward(self, encoder_tokens, decoder_tokens, whole: bool = True):
        """→ logits [B, Sd, vocab] in the compute dtype; with
        ``whole=False`` (logits, how the vocab is split over tp or None):
        on a mesh this rank's block of the vocab."""
        logits, vocab = self._decode(self._encode(encoder_tokens),
                                     decoder_tokens)
        return gather_tp(logits, vocab) if whole else (logits, vocab)

    def encode(self, tokens):
        """tokens [B, S] → encoder hidden [B, S, d]."""
        return self._encode(tokens)

    def decode(self, enc_out, decoder_tokens):
        """enc_out [B, Se, d] + decoder_tokens [B, Sd] → logits [B, Sd,
        V]."""
        logits, vocab = self._decode(enc_out, decoder_tokens)
        return gather_tp(logits, vocab)

    def _encode(self, tokens):
        cfg = self.cfg
        seq = collectives.batch_layout(batch_spec)[1]
        x = embed(tokens, self.wte).to(cfg.dtype)
        bias = _rel_bias(self.enc_rel_bias, tokens.shape[1], seq, True, cfg)
        for block in self.encoder:
            x = checkpointed(block, cfg.remat)(x, bias, seq)
        return _rmsnorm(x, local(self.enc_final_ln), cfg.layernorm_eps)

    def _decode(self, enc_out, decoder_tokens):
        cfg = self.cfg
        dt = cfg.dtype
        seq = collectives.batch_layout(batch_spec)[1]
        # The encoder's output is split like its tokens: each decoder row
        # attends over all of it.
        enc_out = collectives.gather_sum(enc_out, seq, 1)
        x = embed(decoder_tokens, self.wte).to(dt)
        self_bias = _rel_bias(self.dec_rel_bias, decoder_tokens.shape[1],
                              seq, False, cfg)
        for block in self.decoder:
            x = checkpointed(block, cfg.remat)(x, enc_out, self_bias, seq)
        x = _rmsnorm(x, local(self.dec_final_ln), cfg.layernorm_eps)
        # Tied embedding head with T5's rescale.
        x = x * as_dtype(cfg.d_model ** -0.5, dt)
        wte, vocab = tp_local(self.wte)
        return to_tp(x, vocab) @ wte.to(dt).T, vocab


def encode(model: T5, tokens):
    """tokens [B, S] → encoder hidden [B, S, d]."""
    return model.encode(tokens)


def decode(model: T5, enc_out, decoder_tokens):
    """enc_out [B, Se, d] + decoder_tokens [B, Sd] → logits [B, Sd, V]."""
    return model.decode(enc_out, decoder_tokens)


def forward(model: T5, encoder_tokens, decoder_tokens):
    return model(encoder_tokens, decoder_tokens)


def loss_fn(model: T5, encoder_tokens, decoder_tokens, targets, mask=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token cross-entropy (fp32) over ``mask`` → (loss, {"loss",
    "accuracy"}). Where the current step splits the batch over data ranks
    (``parallel.mesh.registered_mesh``), the inputs are this rank's rows,
    the first value is this rank's share (its sum over the global count
    of targets) and the metrics are the global batch's."""
    logits, vocab = model(encoder_tokens, decoder_tokens, whole=False)
    return masked_ce(logits, targets, mask, vocab, batch_spec=batch_spec)


# -- parameters ---------------------------------------------------------

def param_specs(cfg: T5Config, rules: ShardingRules) -> Dict[str, Any]:
    """The JAX package's ``param_specs``, each stacked leaf's spec less its
    leading ``layers`` entry (the port's layers are ``ModuleList``s)."""
    check_unstacked(rules)
    r = rules

    def attn():
        return {"wq": r.spec("embed", "heads", "head_dim"),
                "wk": r.spec("embed", "heads", "head_dim"),
                "wv": r.spec("embed", "heads", "head_dim"),
                "wo": r.spec("heads", "head_dim", "embed")}

    enc = {"ln1": r.spec("embed"), "ln2": r.spec("embed"), "attn": attn(),
           "wi_0": r.spec("embed", "mlp"), "wi_1": r.spec("embed", "mlp"),
           "wo_ff": r.spec("mlp", "embed")}
    dec = dict(enc, ln3=r.spec("embed"), cross=attn())
    return {
        "wte": r.spec("vocab", "embed"),
        "enc_rel_bias": r.spec(None, "heads"),
        "dec_rel_bias": r.spec(None, "heads"),
        "encoder": enc,
        "decoder": dec,
        "enc_final_ln": r.spec("embed"),
        "dec_final_ln": r.spec("embed"),
    }


def batch_spec(rules: ShardingRules) -> PartitionSpec:
    return rules.spec("batch", "sequence")


def init(cfg: T5Config, generator: torch.Generator,
         device: DeviceLike = None, mesh=None,
         rules: Optional[ShardingRules] = None) -> T5:
    """A model with the JAX package's init distributions (every weight and
    bias table N(0, 1/d_model); RMSNorm scales 1), drawn from
    ``generator``, which must live on ``device``. The draws differ from
    ``jax.random``'s for the same seed. With ``mesh`` the model is placed
    there by :func:`param_specs` of ``rules`` (default
    ``ShardingRules()``) and holds the same global values."""
    std = 1.0 / math.sqrt(cfg.d_model)
    normal = dict.fromkeys(("wte", "enc_rel_bias", "dec_rel_bias", "wq",
                            "wk", "wv", "wo", "wi_0", "wi_1", "wo_ff"), std)
    return draw(build(T5, param_specs, cfg, device, mesh, rules), generator,
                normal, lambda leaf: 1.0)


def from_jax_params(params: Dict[str, Any], cfg: T5Config,
                    device: DeviceLike = None, mesh=None,
                    rules: Optional[ShardingRules] = None) -> T5:
    """The port's model holding exactly the values of ``params``: the
    nested dict that ``ray_tpu.models.t5.init`` returns, with numpy leaves
    and each stack's layers on a leading ``[L, ...]`` axis. With ``mesh``
    the model is placed as :func:`init` places it."""
    return load_jax_params(build(T5, param_specs, cfg, device, mesh, rules),
                           params)


__all__ = ["Attention", "DecoderBlock", "EncoderBlock", "PRESETS", "T5",
           "T5Config", "batch_spec", "config", "decode", "encode", "forward",
           "from_jax_params", "init", "leaf_groups", "loss_fn",
           "param_specs", "to_jax_params"]
