"""BERT-style bidirectional encoder with a masked-LM head —
``ray_tpu/models/bert.py`` in PyTorch.

Same configuration fields and presets, parameter names and shapes (the
layers a ``ModuleList``, where the JAX package stacks them for
``lax.scan``), and numerics: the three embeddings summed in the parameter
dtype and cast before the embedding LayerNorm; post-LayerNorm blocks (LN
of ``x + sublayer(x)``, eps 1e-12, in fp32); the attention scale applied
in the compute dtype, the ``-1e9`` padding bias added in fp32 before the
fp32 softmax; the tanh form of GELU; the masked-LM head over the tied
``wte`` and the tanh [CLS] pooler in fp32. With ``remat`` (the default)
each block is checkpointed while gradients are recorded.

On a mesh (:func:`init` or :func:`from_jax_params` with ``mesh``, placed
by :func:`param_specs`) each block computes on its local ``tp`` blocks of
the heads and the FFN's columns, as ``models/gpt.py``'s; the embedding
takes the vocab-parallel lookup, and the tied MLM head gives this rank's
block of the vocab, whose cross-entropy :func:`mlm_loss` reduces over tp
and divides by the global count of masked positions where the current
step splits the batch over the data ranks (``models/_common.py``). The
heads read the root's parameters outside ``forward``; they are methods
(``Bert.mlm_logits``, ``Bert.pooled``) that FSDP2 gathers around.

Under rules that put the sequence on ``sp`` (``context_parallel_rules()``;
:func:`batch_spec` is ``("batch", "sequence")``) each rank holds a block
of every row's columns: its positions are global, each block's queries
attend over keys and values gathered over ``sp`` (the padding bias over
the gathered ``attention_mask``), the pooler reads position 0 from ``sp``
index 0, and :func:`mlm_loss` counts the masked positions over the whole
global batch; the step sums the gradients over ``sp``
(``sharding.average_replicated_grads`` with :func:`batch_spec`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import (as_dtype, build, check_unstacked,
                                          checkpointed, draw, embed,
                                          masked_ce, sequence_span,
                                          wrap_ids)
from ray_tpu_torch.models._params import (leaf_groups, load_jax_params,
                                          to_jax_params)
from ray_tpu_torch.models.gpt import _empty, _layernorm
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                             from_tp, gather_tp, local, to_tp,
                                             tp_local)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    n_layers: int = 12
    max_seq_len: int = 512
    n_segments: int = 2
    layernorm_eps: float = 1e-12
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, f = self.d_model, self.d_ff
        attn = 4 * d * d + 4 * d  # qkvo weights + biases
        ffn = 2 * d * f + f + d
        block = attn + ffn + 4 * d  # + two layernorms (scale, bias)
        embeds = (self.vocab_size + self.max_seq_len
                  + self.n_segments) * d + 2 * d  # + embedding layernorm
        pooler = d * d + d
        mlm = d * d + d + 2 * d + self.vocab_size  # transform+ln+bias
        return embeds + self.n_layers * block + pooler + mlm


PRESETS: Dict[str, BertConfig] = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(d_model=1024, n_heads=16, d_ff=4096,
                             n_layers=24),
    "bert-tiny": BertConfig(vocab_size=256, d_model=64, n_heads=4,
                            d_ff=128, n_layers=2, max_seq_len=64,
                            dtype=torch.float32, remat=False),
}


def config(name: str, **overrides) -> BertConfig:
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg


# -- modules ------------------------------------------------------------

class Block(nn.Module):
    """One post-LN encoder block; names and shapes of one layer of the JAX
    package's stacked ``params["layers"]``."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
        self.cfg = cfg
        for name in ("wq", "wk", "wv"):
            setattr(self, name, _empty((d, h, hd), cfg, device))
        self.wo = _empty((h, hd, d), cfg, device)
        for name in ("bq", "bk", "bv"):
            setattr(self, name, _empty((h, hd), cfg, device))
        self.bo = _empty((d,), cfg, device)
        self.ln1_s = _empty((d,), cfg, device)
        self.ln1_b = _empty((d,), cfg, device)
        self.wi = _empty((d, f), cfg, device)
        self.bi = _empty((f,), cfg, device)
        self.wo_ff = _empty((f, d), cfg, device)
        self.bo_ff = _empty((d,), cfg, device)
        self.ln2_s = _empty((d,), cfg, device)
        self.ln2_b = _empty((d,), cfg, device)

    def _attention(self, x, mask_bias, seq):
        """On a tp mesh over this rank's heads; the output summed. With
        the sequence split over ``seq``, this rank's query rows against
        the keys and values of the whole sequence, gathered."""
        dt = self.cfg.dtype
        wq, heads = tp_local(self.wq)
        x = to_tp(x, heads)

        def proj(w, b):
            return torch.einsum("bsd,dhk->bshk", x, local(w).to(dt)) + \
                local(b).to(dt)

        q = proj(wq, self.bq)
        k, v = (collectives.gather_sum(proj(w, b), seq, 1)
                for w, b in ((self.wk, self.bk), (self.wv, self.bv)))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / as_dtype(
            math.sqrt(self.cfg.head_dim), dt)
        logits = logits.float() + mask_bias  # fp32 softmax
        probs = torch.softmax(logits, dim=-1).to(dt)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return from_tp(torch.einsum("bqhd,hdm->bqm", ctx,
                                    local(self.wo).to(dt)), heads) + \
            local(self.bo).to(dt)

    def forward(self, x, mask_bias, seq=None):
        cfg = self.cfg
        dt = cfg.dtype
        # Post-LN residual order (original BERT): LN(x + sublayer(x)).
        x = _layernorm(x + self._attention(x, mask_bias, seq),
                       local(self.ln1_s),
                       local(self.ln1_b), cfg.layernorm_eps)
        wi, mlp = tp_local(self.wi)
        hidden = F.gelu(to_tp(x, mlp) @ wi.to(dt) + local(self.bi).to(dt),
                        approximate="tanh")
        ffn = from_tp(hidden @ local(self.wo_ff).to(dt), mlp) + \
            local(self.bo_ff).to(dt)
        return _layernorm(x + ffn, local(self.ln2_s), local(self.ln2_b),
                          cfg.layernorm_eps)


def _segment_rows(segment_ids, table):
    """``jnp.take(table, segment_ids, axis=0)`` for the few segment rows
    (ids wrapped and NaN rows out of range, as ``_common.embed``), as a
    select of each row: its backward sums a row's gradient by a reduction
    over the positions. The embedding's backward over ids that repeat
    thousands of times (every position is segment 0 or 1) is not
    deterministic on the card: two runs of one step gave ``wse`` gradients
    that differ in ~46% of their elements (tests/measure_zoo_mesh_gap.py)."""
    ids, outside = wrap_ids(segment_ids, table.shape[0])
    rows = table[0].expand(*ids.shape, table.shape[-1])
    for s in range(1, table.shape[0]):
        rows = torch.where((ids == s)[..., None], table[s], rows)
    return rows.masked_fill(outside[..., None], float("nan"))


class Bert(nn.Module):
    """The BERT encoder and its heads. Parameters are allocated
    uninitialised; build one with :func:`init` (random) or
    :func:`from_jax_params` (carried over from the JAX package)."""

    jax_stacks = {"layers": "blocks"}
    # On a mesh (sharding.shard_model): FSDP2's units, and the heads'
    # entries, which read the root's parameters after the encoder.
    fsdp_methods = ("mlm_logits", "pooled")

    def fsdp_units(self):
        return tuple(self.blocks)

    def __init__(self, cfg: BertConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        d = cfg.d_model
        self.cfg = cfg
        self.wte = _empty((cfg.vocab_size, d), cfg, dev)
        self.wpe = _empty((cfg.max_seq_len, d), cfg, dev)
        self.wse = _empty((cfg.n_segments, d), cfg, dev)
        self.emb_ln_s = _empty((d,), cfg, dev)
        self.emb_ln_b = _empty((d,), cfg, dev)
        self.pooler_w = _empty((d, d), cfg, dev)
        self.pooler_b = _empty((d,), cfg, dev)
        self.mlm_w = _empty((d, d), cfg, dev)
        self.mlm_b = _empty((d,), cfg, dev)
        self.mlm_ln_s = _empty((d,), cfg, dev)
        self.mlm_ln_b = _empty((d,), cfg, dev)
        self.mlm_bias = _empty((cfg.vocab_size,), cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))

    def forward(self, tokens, segment_ids=None, attention_mask=None):
        """→ [B, S, d_model] contextual embeddings (:func:`encode`)."""
        return self._encode(tokens, segment_ids, attention_mask)

    def _encode(self, tokens, segment_ids=None, attention_mask=None):
        """Where the current step splits the sequence over ``sp``
        (``batch_spec``), the inputs and the result are this rank's
        columns: the positions are global and every query attends over
        the gathered keys, padding on other ranks included."""
        cfg = self.cfg
        seq = collectives.batch_layout(batch_spec)[1]
        S = tokens.shape[1]
        start = sequence_span(S, seq)[0]
        if segment_ids is None:
            segment_ids = torch.zeros_like(tokens)
        if attention_mask is None:
            attention_mask = torch.ones_like(tokens)
        x = (embed(tokens, self.wte)
             + local(self.wpe)[None, start:start + S]
             + _segment_rows(segment_ids, local(self.wse)))
        x = _layernorm(x.to(cfg.dtype), local(self.emb_ln_s),
                       local(self.emb_ln_b), cfg.layernorm_eps)
        # [B, 1, 1, S] additive bias: -1e9 on padding keys.
        keys = collectives.gather_sum(attention_mask, seq, 1)
        mask_bias = torch.where(keys[:, None, None, :] > 0, 0.0,
                                -1e9).float()
        for block in self.blocks:
            x = checkpointed(block, cfg.remat)(x, mask_bias, seq)
        return x

    def mlm_logits(self, tokens, segment_ids=None, attention_mask=None,
                   whole: bool = True):
        """The masked-LM head over the tied embedding → [B, S, vocab]
        (fp32); with ``whole=False`` (logits, how the vocab is split over
        tp or None): on a mesh this rank's block of the vocab."""
        cfg = self.cfg
        dt = cfg.dtype
        x = self._encode(tokens, segment_ids, attention_mask)
        x = F.gelu(x @ local(self.mlm_w).to(dt) + local(self.mlm_b).to(dt),
                   approximate="tanh")
        x = _layernorm(x, local(self.mlm_ln_s), local(self.mlm_ln_b),
                       cfg.layernorm_eps)
        wte, vocab = tp_local(self.wte)
        logits = to_tp(x.float(), vocab) @ wte.float().T
        logits = logits + local(self.mlm_bias).float()
        return gather_tp(logits, vocab) if whole else (logits, vocab)

    def pooled(self, tokens, segment_ids=None, attention_mask=None):
        """The tanh [CLS] pooler → [B, d_model]. Over a sequence split
        over ``sp``, position 0 lies on ``sp`` index 0: every rank takes
        that rank's row and returns the same value. Each rank's loss on
        it is its share of a sum over ``sp`` (``masked_ce`` with
        :func:`batch_spec` counts the rows once per ``sp`` rank), so the
        backward sums the row's gradient over ``sp`` into index 0, as
        ``average_replicated_grads`` sums the pooler's."""
        x = self._encode(tokens, segment_ids, attention_mask)
        seq = collectives.batch_layout(batch_spec)[1]
        cls = collectives.gather_sum(x[:, :1], seq, 1)[:, 0].float()
        return torch.tanh(cls @ local(self.pooler_w).float()
                          + local(self.pooler_b).float())


def encode(model: Bert, tokens, segment_ids=None, attention_mask=None):
    """→ [B, S, d_model] contextual embeddings. ``attention_mask`` is 1
    for real tokens, 0 for padding (padding positions are excluded from
    every token's attention)."""
    return model(tokens, segment_ids, attention_mask)


def mlm_logits(model: Bert, tokens, segment_ids=None, attention_mask=None):
    """Masked-LM head over the tied embedding → [B, S, vocab] (fp32)."""
    return model.mlm_logits(tokens, segment_ids, attention_mask)


def pooled(model: Bert, tokens, segment_ids=None, attention_mask=None):
    """The tanh [CLS] pooler → [B, d_model] (sentence representation)."""
    return model.pooled(tokens, segment_ids, attention_mask)


def mlm_loss(model: Bert, tokens, targets, mask_positions,
             attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over masked positions (mask_positions is 1
    where a token was masked and must be predicted). Where the current
    step splits the batch over data ranks (``parallel.mesh.
    registered_mesh``), the inputs are this rank's rows and the result is
    this rank's share: its sum over the global count of masked positions,
    as GSPMD's mean over the global batch divides. The target's
    log-probability is taken from the log-softmax, as the JAX package's
    ``jnp.take_along_axis`` takes it: a target out of range gives a NaN
    loss and its position no gradient."""
    logits, vocab = model.mlm_logits(tokens, attention_mask=attention_mask,
                                     whole=False)
    return masked_ce(logits, targets, mask_positions, vocab,
                     pick_log_probs=True, batch_spec=batch_spec)[0]


# -- parameters ---------------------------------------------------------

def param_specs(cfg: BertConfig, rules: ShardingRules) -> Dict[str, Any]:
    """The JAX package's ``param_specs``, each layer leaf's spec less its
    leading ``layers`` entry (the port's layers are a ``ModuleList``)."""
    check_unstacked(rules)
    r = rules
    layers = {
        "wq": r.spec("embed", "heads", "head_dim"),
        "wk": r.spec("embed", "heads", "head_dim"),
        "wv": r.spec("embed", "heads", "head_dim"),
        "wo": r.spec("heads", "head_dim", "embed"),
        "bq": r.spec("heads", "head_dim"),
        "bk": r.spec("heads", "head_dim"),
        "bv": r.spec("heads", "head_dim"),
        "bo": r.spec("embed"),
        "ln1_s": r.spec(None), "ln1_b": r.spec(None),
        "wi": r.spec("embed", "mlp"),
        "bi": r.spec("mlp"),
        "wo_ff": r.spec("mlp", "embed"),
        "bo_ff": r.spec("embed"),
        "ln2_s": r.spec(None), "ln2_b": r.spec(None),
    }
    return {
        "wte": r.spec("vocab", "embed"),
        "wpe": r.spec(None, "embed"),
        "wse": r.spec(None, "embed"),
        "emb_ln_s": PartitionSpec(), "emb_ln_b": PartitionSpec(),
        "layers": layers,
        "pooler_w": r.spec("embed", None), "pooler_b": PartitionSpec(),
        "mlm_w": r.spec("embed", None), "mlm_b": PartitionSpec(),
        "mlm_ln_s": PartitionSpec(), "mlm_ln_b": PartitionSpec(),
        "mlm_bias": r.spec("vocab"),
    }


def batch_spec(rules: ShardingRules) -> PartitionSpec:
    return rules.spec("batch", "sequence")


def init(cfg: BertConfig, generator: torch.Generator,
         device: DeviceLike = None, mesh=None,
         rules: Optional[ShardingRules] = None) -> Bert:
    """A model with the JAX package's init distributions (every weight
    N(0, 0.02²); LayerNorm scales 1, biases 0), drawn from ``generator``,
    which must live on ``device``. The draws differ from ``jax.random``'s
    for the same seed. With ``mesh`` the model is placed there by
    :func:`param_specs` of ``rules`` (default ``ShardingRules()``) and
    holds the same global values."""
    normal = dict.fromkeys(("wte", "wpe", "wse", "pooler_w", "mlm_w", "wq",
                            "wk", "wv", "wo", "wi", "wo_ff"), 0.02)
    return draw(build(Bert, param_specs, cfg, device, mesh, rules),
                generator, normal,
                lambda leaf: 1.0 if leaf.endswith("_s") else 0.0)


def from_jax_params(params: Dict[str, Any], cfg: BertConfig,
                    device: DeviceLike = None, mesh=None,
                    rules: Optional[ShardingRules] = None) -> Bert:
    """The port's model holding exactly the values of ``params``: the
    nested dict that ``ray_tpu.models.bert.init`` returns, with numpy
    leaves and layers stacked on a leading ``[L, ...]`` axis. With
    ``mesh`` the model is placed as :func:`init` places it."""
    return load_jax_params(
        build(Bert, param_specs, cfg, device, mesh, rules), params)


__all__ = ["Bert", "BertConfig", "Block", "PRESETS", "batch_spec", "config",
           "encode", "from_jax_params", "init", "leaf_groups", "mlm_logits",
           "mlm_loss", "param_specs", "pooled", "to_jax_params"]
