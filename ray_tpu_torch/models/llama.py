"""Llama family — ``ray_tpu/models/llama.py`` in PyTorch: forward, loss and
rematerialisation.

Same configuration fields and presets, same parameter shapes and names
(layers are a ``ModuleList`` here, where the JAX package stacks them on a
leading axis for ``lax.scan``), same numerics:

* sequential pre-norm blocks, no biases;
* RMSNorm in fp32, times the fp32 scale, cast back to the activation
  dtype;
* rotary embeddings over the whole head dim, rotating its two halves
  against each other, at ``rope_theta``; the fp32 angles are cast to the
  activation dtype before the products;
* grouped-query attention (``n_kv_heads`` below ``n_heads``);
* the SwiGLU FFN, ``silu(gate) * up``;
* parameters kept in ``param_dtype`` and cast to ``cfg.dtype`` at each
  use, and a residual stream in ``cfg.dtype``.

``attn_impl="flash"`` runs attention through the port's flash kernels
(``ops/flash_attention.py``: K1 forward, K2/K3 backward) at the JAX
package's default 1024 x 1024 tiles, with k and v on their own KV heads;
``"dot"`` is the plain causal attention, the port's GPT's. With ``remat``
each block is checkpointed (``torch.utils.checkpoint``) while gradients
are recorded, saving only its input, as ``jax.checkpoint`` with
``nothing_saveable`` does. :func:`loss_fn` is the JAX package's unchunked
next-token cross-entropy. ``"ring"`` and ``"ulysses"`` are GPT's
sequence-parallel attention (``models/gpt.py``), as the reference reuses
them; where the step splits the sequence over ``sp``, positions are
global.

On a mesh (:func:`init` with ``mesh``, or ``sharding.shard_model`` by
:func:`param_specs`) each block computes on its local ``tp`` blocks of
the parameters as ``models/gpt.py`` does: query and KV heads split over
``tp`` together (``tp`` must divide ``n_kv_heads``, so each rank keeps the
model's grouping), the FFN's columns, and the vocab of the embedding and
the head; ``forward`` gathers the logits' vocab.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import (build, ce_stats, check_unstacked,
                                          draw, embed, loss_and_metrics)
from ray_tpu_torch.models._params import (leaf_groups, load_jax_params,
                                          to_jax_params)
from ray_tpu_torch.models.gpt import (_dispatch_attention, _dot_attention,
                                      _empty, _positions)
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                             AxisShard, from_tp, gather_tp,
                                             local, to_tp, tp_local)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layers: int = 32
    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: Optional[int] = None  # != n_heads → GQA
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    remat: bool = True
    attn_impl: str = "dot"  # "dot" | "flash" | "ring" | "ulysses"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def num_params(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        kvh = self.kv_heads * self.head_dim
        per_layer = (d * d + 2 * d * kvh + d * d  # q, k, v, o
                     + 3 * d * f                   # gate, up, down
                     + 2 * d)                      # two RMSNorm scales
        head = 0 if self.tie_embeddings else v * d
        return v * d + L * per_layer + d + head


# -- presets ------------------------------------------------------------

PRESETS: Dict[str, LlamaConfig] = {
    "llama2-7b": LlamaConfig(),
    "llama3-8b": LlamaConfig(
        vocab_size=128256, n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=8192, rope_theta=500000.0),
    "tinyllama-1b": LlamaConfig(
        vocab_size=32000, n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=5632, max_seq_len=2048),
    # Test-size configs.
    "llama-tiny": LlamaConfig(
        vocab_size=256, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, dtype=torch.float32, remat=False),
    "llama-micro": LlamaConfig(
        vocab_size=512, n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
        d_ff=256, max_seq_len=256, dtype=torch.float32, remat=False),
}


def config(name: str, **overrides) -> LlamaConfig:
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg


def flops_per_token(cfg: LlamaConfig) -> float:
    """Approximate training FLOPs/token: 6N plus the attention term at
    ``cfg.max_seq_len``."""
    attn = 12 * cfg.n_layers * cfg.d_model * cfg.max_seq_len
    return 6.0 * cfg.num_params() + attn


# -- numerics -----------------------------------------------------------

def _rmsnorm(x, scale, eps):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _rotary(x, positions, theta):
    """Llama (half-rotation) rotary over the full head dim.
    x: [B, S, H, D], positions: [B, S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(
        half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, cfg: LlamaConfig):
    """Causal attention on plain tensors (on a mesh, this rank's heads);
    "ring" and "ulysses" are GPT's, as the reference reuses them."""
    return _dispatch_attention(q, k, v, cfg, _local_attention)


def _local_attention(q, k, v, cfg: LlamaConfig):
    if cfg.attn_impl == "dot":
        return _dot_attention(q, k, v)
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, True, 1024, 1024)
    raise ValueError(f"Unknown attn_impl {cfg.attn_impl!r}")


# -- modules ------------------------------------------------------------

class Block(nn.Module):
    """One Llama block; parameter names and shapes are those of one layer
    of the JAX package's stacked ``params["layers"]``."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        h, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.attn_norm = _empty((d,), cfg, device)
        self.wq = _empty((d, h, hd), cfg, device)
        self.wk = _empty((d, kvh, hd), cfg, device)
        self.wv = _empty((d, kvh, hd), cfg, device)
        self.wo = _empty((h, hd, d), cfg, device)
        self.ffn_norm = _empty((d,), cfg, device)
        self.w_gate = _empty((d, f), cfg, device)
        self.w_up = _empty((d, f), cfg, device)
        self.w_down = _empty((f, d), cfg, device)

    def forward(self, x, positions, cfg: LlamaConfig):
        """x: [B, S, d] in cfg.dtype → [B, S, d]. On a tp mesh the heads
        and the FFN columns of this rank's blocks; the residual stream is
        whole."""
        dt = cfg.dtype
        B, S, d = x.shape
        wq, heads = tp_local(self.wq)
        h = to_tp(_rmsnorm(x, local(self.attn_norm), cfg.rms_eps), heads)

        def proj(w):  # [d, heads, hd] → [B, S, heads, hd]
            w = local(w)
            return (h @ w.to(dt).reshape(d, -1)).view(B, S, w.shape[1],
                                                      w.shape[2])

        q = _rotary(proj(wq), positions, cfg.rope_theta)
        k = _rotary(proj(self.wk), positions, cfg.rope_theta)
        attn = _attention(q, k, proj(self.wv), cfg)
        x = x + from_tp(attn.reshape(B, S, -1)
                        @ local(self.wo).to(dt).reshape(-1, d), heads)

        w_gate, mlp = tp_local(self.w_gate)
        h = to_tp(_rmsnorm(x, local(self.ffn_norm), cfg.rms_eps), mlp)
        ff = F.silu(h @ w_gate.to(dt)) * (h @ local(self.w_up).to(dt))
        return x + from_tp(ff @ local(self.w_down).to(dt), mlp)


class Llama(nn.Module):
    """The Llama model. Parameters are allocated uninitialised; build one
    with :func:`init` (random) or :func:`from_jax_params` (carried over
    from the JAX package)."""

    jax_stacks = {"layers": "blocks"}
    # On a mesh (sharding.shard_model): FSDP2's units, and loss_fn's entry.
    fsdp_methods = ("hidden_states",)

    def fsdp_units(self):
        return tuple(self.blocks)

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        d, v = cfg.d_model, cfg.vocab_size
        self.cfg = cfg
        self.wte = _empty((v, d), cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _empty((d,), cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _empty((d, v), cfg, dev)

    def hidden_states(self, tokens, positions=None):
        """tokens [B, S] int → final-normed hidden [B, S, d].
        :func:`loss_fn` enters the model here; on a mesh it is an FSDP
        forward method, as GPT's."""
        return self._hidden_states(tokens, positions)

    def _hidden_states(self, tokens, positions=None):
        cfg = self.cfg
        if positions is None:
            positions = _positions(tokens)
        x = embed(tokens, self.wte).to(cfg.dtype)
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                block = partial(checkpoint, block, use_reentrant=False)
            x = block(x, positions, cfg)
        return _rmsnorm(x, local(self.final_norm), cfg.rms_eps)

    def _head(self, x) -> Tuple[torch.Tensor, Optional[AxisShard]]:
        """(logits: on a mesh this rank's block of the vocab, how the
        vocab is split over tp or None)."""
        dt = self.cfg.dtype
        if self.cfg.tie_embeddings:
            w, vocab = tp_local(self.wte)
            return to_tp(x, vocab) @ w.to(dt).T, vocab
        w, vocab = tp_local(self.lm_head)
        return to_tp(x, vocab) @ w.to(dt), vocab

    def forward(self, tokens, positions=None):
        """tokens [B, S] int → logits [B, S, vocab] (compute dtype)."""
        logits, vocab = self._head(self._hidden_states(tokens, positions))
        return gather_tp(logits, vocab)


# -- loss ---------------------------------------------------------------

def loss_fn(model: Llama, tokens, targets, mask=None, z_loss: float = 0.0,
            batch_groups=()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32 over the whole ``[B, S, vocab]``
    logits (+ optional z-loss) → (loss, {"loss", "accuracy",
    "perplexity"}), all 0-d tensors on the model's device; accuracy by
    first-max argmax. ``batch_groups`` as in ``models.gpt.loss_fn``."""
    logits, vocab = model._head(model.hidden_states(tokens))
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.float()
    nll_sum, hit_sum = ce_stats(logits, targets, mask, z_loss, vocab)
    return loss_and_metrics(nll_sum, hit_sum, mask, batch_groups)


# -- parameters ---------------------------------------------------------

def param_specs(cfg: LlamaConfig, rules: ShardingRules) -> Dict[str, Any]:
    """PartitionSpecs of the model's parameters, after
    ``ray_tpu/models/llama.py``'s ``param_specs``, laid out as
    ``models.gpt.param_specs`` lays out GPT's."""
    check_unstacked(rules)
    r = rules
    layers = {
        "attn_norm": r.spec("embed"),
        "wq": r.spec("embed", "heads", "head_dim"),
        "wk": r.spec("embed", "kv_heads", "head_dim"),
        "wv": r.spec("embed", "kv_heads", "head_dim"),
        "wo": r.spec("heads", "head_dim", "embed"),
        "ffn_norm": r.spec("embed"),
        "w_gate": r.spec("embed", "mlp"),
        "w_up": r.spec("embed", "mlp"),
        "w_down": r.spec("mlp", "embed"),
    }
    specs = {
        "wte": r.spec("vocab", "embed"),
        "layers": layers,
        "final_norm": r.spec("embed"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = r.spec("embed", "vocab")
    return specs


def batch_spec(rules: ShardingRules) -> PartitionSpec:
    return rules.spec("batch", "sequence")


def init(cfg: LlamaConfig, generator: torch.Generator,
         device: DeviceLike = None, mesh=None,
         rules: Optional[ShardingRules] = None) -> Llama:
    """A model with the JAX package's init distributions (normal, std
    0.02, ``wo`` and ``w_down`` 0.02/sqrt(2L); RMSNorm scales 1), drawn
    from ``generator``, which must live on ``device``. The draws differ
    from ``jax.random``'s for the same seed. With ``mesh`` the model is
    placed there by :func:`param_specs` of ``rules`` (default
    ``ShardingRules()``) and holds the same global values, as
    ``models.gpt.init``."""
    model = build(Llama, param_specs, cfg, device, mesh, rules)
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)
    normal = {"wte": std, "lm_head": std, "wq": std, "wk": std, "wv": std,
              "w_gate": std, "w_up": std, "wo": out_std, "w_down": out_std}
    return draw(model, generator, normal, lambda leaf: 1.0)


def from_jax_params(params: Dict[str, Any], cfg: LlamaConfig,
                    device: DeviceLike = None) -> Llama:
    """The port's model holding exactly the values of ``params``: the
    nested dict that ``ray_tpu.models.llama.init`` returns, with numpy
    leaves and layers stacked on a leading ``[L, ...]`` axis. Values are
    copied into ``cfg.param_dtype`` (exact when the leaves are of that
    dtype)."""
    return load_jax_params(Llama(cfg, device), params)


__all__ = ["Block", "Llama", "LlamaConfig", "PRESETS", "batch_spec",
           "config", "flops_per_token", "from_jax_params", "init",
           "leaf_groups", "loss_fn", "param_specs", "to_jax_params"]
