"""Vision Transformer — ``ray_tpu/models/vit.py`` in PyTorch.

Same configuration fields and presets, parameter names and shapes (the
layers a ``ModuleList``, where the JAX package stacks them for
``lax.scan``), and numerics: the patch embedding is a reshape and one
matmul, each patch flattened in ``(p, p, C)`` order (:func:`patchify`);
pre-LayerNorm blocks in fp32, cast back; the attention scale applied in
the compute dtype before the fp32 softmax; the tanh form of GELU;
parameters kept in ``param_dtype`` and cast to ``cfg.dtype`` at use. With
``remat`` each block is checkpointed while gradients are recorded.

On a mesh (:func:`init` or :func:`from_jax_params` with ``mesh``, placed
by :func:`param_specs`) each block computes on its local ``tp`` blocks of
the heads and the MLP's columns, and the classifier on its block of the
classes, as ``models/gpt.py``'s blocks and head; :func:`loss_fn` takes
the vocab-parallel cross-entropy over the classes and divides by the
global batch where the current step splits it over the data ranks
(``models/_common.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import (as_dtype, build, check_unstacked,
                                          checkpointed, draw, masked_ce)
from ray_tpu_torch.models._params import (leaf_groups, load_jax_params,
                                          to_jax_params)
from ray_tpu_torch.models.gpt import _empty, _layernorm
from ray_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                             from_tp, gather_tp, local, to_tp,
                                             tp_local)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    n_channels: int = 3
    n_classes: int = 1000
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    layernorm_eps: float = 1e-6
    remat: bool = False
    pool: str = "cls"  # "cls" | "mean"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.n_channels * self.patch_size ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + (1 if self.pool == "cls" else 0)

    def num_params(self) -> int:
        d, f, L = self.d_model, self.d_ff, self.n_layers
        per_layer = 4 * d * d + 2 * d * f + f + d + 4 * d
        return (self.patch_dim * d + d + self.seq_len * d
                + L * per_layer + 2 * d + d * self.n_classes
                + self.n_classes + (d if self.pool == "cls" else 0))


PRESETS: Dict[str, ViTConfig] = {
    "vit-b16": ViTConfig(),
    "vit-l16": ViTConfig(n_layers=24, d_model=1024, n_heads=16, d_ff=4096),
    "vit-s16": ViTConfig(n_layers=12, d_model=384, n_heads=6, d_ff=1536),
    # Test-size configs.
    "vit-tiny": ViTConfig(
        image_size=32, patch_size=8, n_classes=10, n_layers=2, d_model=64,
        n_heads=4, d_ff=128, dtype=torch.float32),
}


def config(name: str, **overrides) -> ViTConfig:
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg


def flops_per_image(cfg: ViTConfig) -> float:
    return 6.0 * cfg.num_params() * cfg.seq_len


# -- modules ------------------------------------------------------------

class Block(nn.Module):
    """One encoder block; names and shapes of one layer of the JAX
    package's stacked ``params["layers"]``."""

    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
        self.cfg = cfg
        self.ln1_scale = _empty((d,), cfg, device)
        self.ln1_bias = _empty((d,), cfg, device)
        self.wq = _empty((d, h, hd), cfg, device)
        self.wk = _empty((d, h, hd), cfg, device)
        self.wv = _empty((d, h, hd), cfg, device)
        self.wo = _empty((h, hd, d), cfg, device)
        self.ln2_scale = _empty((d,), cfg, device)
        self.ln2_bias = _empty((d,), cfg, device)
        self.w_in = _empty((d, f), cfg, device)
        self.b_in = _empty((f,), cfg, device)
        self.w_out = _empty((f, d), cfg, device)
        self.b_out = _empty((d,), cfg, device)

    def forward(self, x):
        """x: [B, S, d] → [B, S, d]; on a tp mesh the heads and the MLP
        columns of this rank's blocks, the residual stream whole."""
        cfg = self.cfg
        dt = cfg.dtype
        h = _layernorm(x, local(self.ln1_scale), local(self.ln1_bias),
                       cfg.layernorm_eps)
        wq, heads = tp_local(self.wq)
        h = to_tp(h, heads)
        q = torch.einsum("bsd,dhk->bshk", h, wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", h, local(self.wk).to(dt))
        v = torch.einsum("bsd,dhk->bshk", h, local(self.wv).to(dt))
        scale = as_dtype(1.0 / math.sqrt(cfg.head_dim), dt)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()
        probs = torch.softmax(logits, dim=-1).to(dt)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        x = x + from_tp(torch.einsum("bshk,hkd->bsd", attn,
                                     local(self.wo).to(dt)), heads)

        h = _layernorm(x, local(self.ln2_scale), local(self.ln2_bias),
                       cfg.layernorm_eps)
        w_in, mlp = tp_local(self.w_in)
        ff = F.gelu(to_tp(h, mlp) @ w_in.to(dt) + local(self.b_in).to(dt),
                    approximate="tanh")
        ff = from_tp(ff @ local(self.w_out).to(dt), mlp)
        return x + ff + local(self.b_out).to(dt)


class ViT(nn.Module):
    """The ViT. Parameters are allocated uninitialised; build one with
    :func:`init` (random) or :func:`from_jax_params` (carried over from
    the JAX package)."""

    jax_stacks = {"layers": "blocks"}
    # On a mesh (sharding.shard_model): FSDP2's units; forward is the
    # only entry.
    fsdp_methods = ()

    def fsdp_units(self):
        return tuple(self.blocks)

    def __init__(self, cfg: ViTConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        d = cfg.d_model
        self.cfg = cfg
        self.patch_proj = _empty((cfg.patch_dim, d), cfg, dev)
        self.patch_bias = _empty((d,), cfg, dev)
        self.pos_embed = _empty((cfg.seq_len, d), cfg, dev)
        self.lnf_scale = _empty((d,), cfg, dev)
        self.lnf_bias = _empty((d,), cfg, dev)
        self.head_w = _empty((d, cfg.n_classes), cfg, dev)
        self.head_b = _empty((cfg.n_classes,), cfg, dev)
        if cfg.pool == "cls":
            self.cls_token = _empty((d,), cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))

    def forward(self, images, whole: bool = True):
        """images [B, H, W, C] float → logits [B, n_classes] (fp32); with
        ``whole=False`` (logits, how the classes are split over tp or
        None): on a mesh this rank's block of the classes."""
        cfg = self.cfg
        dt = cfg.dtype
        patches = patchify(cfg, images.to(dt))
        x = patches @ local(self.patch_proj).to(dt) + \
            local(self.patch_bias).to(dt)
        if cfg.pool == "cls":
            cls = local(self.cls_token).to(dt).expand(x.shape[0], 1,
                                                      cfg.d_model)
            x = torch.cat([cls, x], dim=1)
        x = x + local(self.pos_embed).to(dt)
        for block in self.blocks:
            x = checkpointed(block, cfg.remat)(x)
        x = _layernorm(x, local(self.lnf_scale), local(self.lnf_bias),
                       cfg.layernorm_eps)
        pooled = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
        head_w, classes = tp_local(self.head_w)
        logits = (to_tp(pooled, classes) @ head_w.to(dt)
                  + local(self.head_b).to(dt)).float()
        if whole:
            return gather_tp(logits, classes)
        return logits, classes


def patchify(cfg: ViTConfig, images):
    """[B, H, W, C] → [B, n_patches, patch_dim] by reshape and permute,
    each patch in ``(p, p, C)`` order (not ``F.unfold``'s ``(C, p, p)``)."""
    B, H, W, C = images.shape
    p = cfg.patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, Hp, Wp, p, p, C]
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def forward(model: ViT, images):
    """images [B, H, W, C] float → logits [B, n_classes] (fp32)."""
    return model(images)


def loss_fn(model: ViT, images, labels
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax cross-entropy classification loss (fp32) → (loss,
    {"loss", "accuracy"}). Where the current step splits the batch over
    data ranks (``parallel.mesh.registered_mesh``), ``images`` and
    ``labels`` are this rank's rows, the first value is this rank's share
    of the global mean and the metrics are the global batch's. An image
    has no sequence to split: ranks over ``sp`` hold the same rows and
    return the same share."""
    logits, classes = model(images, whole=False)
    return masked_ce(logits, labels, None, classes, batch_spec=batch_spec)


# -- parameters ---------------------------------------------------------

def param_specs(cfg: ViTConfig, rules: ShardingRules) -> Dict[str, Any]:
    """The JAX package's ``param_specs``, each layer leaf's spec less its
    leading ``layers`` entry (the port's layers are a ``ModuleList``)."""
    check_unstacked(rules)
    r = rules
    layers = {
        "ln1_scale": r.spec("embed"),
        "ln1_bias": r.spec("embed"),
        "wq": r.spec("embed", "heads", "head_dim"),
        "wk": r.spec("embed", "heads", "head_dim"),
        "wv": r.spec("embed", "heads", "head_dim"),
        "wo": r.spec("heads", "head_dim", "embed"),
        "ln2_scale": r.spec("embed"),
        "ln2_bias": r.spec("embed"),
        "w_in": r.spec("embed", "mlp"),
        "b_in": r.spec("mlp"),
        "w_out": r.spec("mlp", "embed"),
        "b_out": r.spec("embed"),
    }
    specs = {
        "patch_proj": r.spec(None, "embed"),
        "patch_bias": r.spec("embed"),
        "pos_embed": r.spec(None, "embed"),
        "layers": layers,
        "lnf_scale": r.spec("embed"),
        "lnf_bias": r.spec("embed"),
        "head_w": r.spec("embed", "vocab"),
        "head_b": r.spec("vocab"),
    }
    if cfg.pool == "cls":
        specs["cls_token"] = r.spec("embed")
    return specs


def batch_spec(rules: ShardingRules) -> PartitionSpec:
    """Spec for image batches [B, H, W, C]."""
    return rules.spec("batch", None, None, None)


def init(cfg: ViTConfig, generator: torch.Generator,
         device: DeviceLike = None, mesh=None,
         rules: Optional[ShardingRules] = None) -> ViT:
    """A model with the JAX package's init distributions (std 0.02, the
    output projections 0.02/sqrt(2L); LayerNorm scales 1, biases 0),
    drawn from ``generator``, which must live on ``device``. The draws
    differ from ``jax.random``'s for the same seed. With ``mesh`` the
    model is placed there by :func:`param_specs` of ``rules`` (default
    ``ShardingRules()``) and holds the same global values."""
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)
    normal = {"patch_proj": std, "pos_embed": std, "head_w": std,
              "cls_token": std, "wq": std, "wk": std, "wv": std,
              "w_in": std, "wo": out_std, "w_out": out_std}
    return draw(build(ViT, param_specs, cfg, device, mesh, rules),
                generator, normal,
                lambda leaf: 1.0 if leaf.endswith("_scale") else 0.0)


def from_jax_params(params: Dict[str, Any], cfg: ViTConfig,
                    device: DeviceLike = None, mesh=None,
                    rules: Optional[ShardingRules] = None) -> ViT:
    """The port's model holding exactly the values of ``params``: the
    nested dict that ``ray_tpu.models.vit.init`` returns, with numpy
    leaves and layers stacked on a leading ``[L, ...]`` axis. With
    ``mesh`` the model is placed as :func:`init` places it."""
    return load_jax_params(build(ViT, param_specs, cfg, device, mesh, rules),
                           params)


__all__ = ["Block", "PRESETS", "ViT", "ViTConfig", "batch_spec", "config",
           "flops_per_image", "forward", "from_jax_params", "init",
           "leaf_groups", "loss_fn", "param_specs", "patchify",
           "to_jax_params"]
