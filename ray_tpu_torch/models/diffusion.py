"""Denoising diffusion UNet and DDIM sampler — ``ray_tpu/models/diffusion.py``
in PyTorch.

Same configuration fields and presets, same parameter names, shapes and
tree (``down[si]["blocks"][i]``, ``"skip"`` only where a block changes
width, ``"down"``/``"up"`` on all stages but one), and the same numerics:

* NHWC activations, as the JAX package's inputs and outputs; conv kernels
  stay in its HWIO layout as parameters and are viewed as OIHW at each
  use, so carried-over weights, checkpoints and Adafactor's factored dims
  are those of the JAX leaves;
* ``"SAME"`` padding by XLA's rule, which pads a stride-2 convolution of
  an even size by 0 before and 1 after (:func:`_same_padding`);
* GroupNorm in fp32 with ``min(n_groups, C)`` groups, lowered until they
  divide ``C``, eps 1e-5, cast back;
* the sinusoidal time embedding (``cos`` then ``sin``), the time MLP and
  each block's time projection in fp32, only their sum cast;
* mid-level self-attention with one head of width ``C``, its logits
  divided by √C in the compute dtype and the softmax in fp32;
* nearest 2x upsampling, and the decoder's pop of the post-downsample
  skip after each up-conv;
* parameters kept in ``param_dtype`` and cast to ``cfg.dtype`` at use.

The DDIM timesteps are ``jnp.linspace``'s float32 values truncated to int
(:func:`ddim_timesteps`). Randomness is an explicit ``torch.Generator``;
:func:`ddim_sample` takes ``x_T`` and :func:`loss_fn` takes ``t`` and
``eps`` so that a caller can hold the port to draws made elsewhere.

On a mesh (:func:`init` or :func:`from_jax_params` with ``mesh``) every
weight is replicated (:func:`param_specs`) and the batch is split over
the data axes: FSDP2 averages the gradients over ``dp`` (its units are
the residual blocks and the mid attention), and under ``fsdp_rules`` every
weight stays out of FSDP2 and ``sharding.average_replicated_grads``
averages them. :func:`loss_fn` draws ``t`` and ``eps`` for the global
batch and keeps this rank's rows, so one seed gives one loss on any mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import (as_dtype, batch_groups,
                                          batch_rows, batch_sum, build)
from ray_tpu_torch.models._params import (leaf_groups, load_jax_params, nest,
                                          to_jax_params)
from ray_tpu_torch.models.gpt import _empty
from ray_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                             local, local_block)


@dataclass(frozen=True)
class UNetConfig:
    image_size: int = 32
    in_channels: int = 3
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 2)
    n_res_blocks: int = 2
    n_groups: int = 32
    time_dim: int = 512
    n_timesteps: int = 1000
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.channel_mults)


PRESETS: Dict[str, UNetConfig] = {
    "ddpm-cifar": UNetConfig(),
    "sd-base": UNetConfig(
        image_size=64, in_channels=4, base_channels=192,
        channel_mults=(1, 2, 3, 4), n_res_blocks=2),
    # Test-size config.
    "unet-tiny": UNetConfig(
        image_size=16, in_channels=3, base_channels=16,
        channel_mults=(1, 2), n_res_blocks=1, n_groups=4, time_dim=32,
        n_timesteps=50, dtype=torch.float32),
}


def config(name: str, **overrides) -> UNetConfig:
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg


# -- primitives ---------------------------------------------------------

def _same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: out = ceil(size /
    stride), the total pad split with the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b=None, stride: int = 1):
    """``lax.conv_general_dilated(x, w, stride, "SAME")`` in NHWC/HWIO,
    then ``+ b``, all in ``x``'s dtype."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_padding(x.shape[1], kh, stride)
    left, right = _same_padding(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels last)
    if (top, left) == (bottom, right):
        padding = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        padding = (0, 0)
    out = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                   padding=padding).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def _groupnorm(x, scale, bias, n_groups: int, eps: float = 1e-5):
    B, H, W, C = x.shape
    g = min(n_groups, C)
    while C % g:
        g -= 1
    x32 = x.float().reshape(B, H, W, g, C // g)
    mu = x32.mean(dim=(1, 2, 4), keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (y * scale.float() + bias.float()).to(x.dtype)


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding. t: [B] int/float → [B, dim] fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# -- modules ------------------------------------------------------------

def _locals(module: nn.Module):
    """{name: local block} of the module's own parameters: on a mesh each
    is a DTensor, replicated, so the block is the whole tensor."""
    return {n: local(p) for n, p in module.named_parameters(recurse=False)}


class ResBlock(nn.Module):
    """One residual block; names and shapes of the JAX package's
    ``_res_block_init`` dict."""

    def __init__(self, cfg: UNetConfig, cin: int, cout: int, device):
        super().__init__()
        self.n_groups = cfg.n_groups
        self.gn1_scale = _empty((cin,), cfg, device)
        self.gn1_bias = _empty((cin,), cfg, device)
        self.conv1 = _empty((3, 3, cin, cout), cfg, device)
        self.conv1_b = _empty((cout,), cfg, device)
        self.time_w = _empty((cfg.time_dim, cout), cfg, device)
        self.time_b = _empty((cout,), cfg, device)
        self.gn2_scale = _empty((cout,), cfg, device)
        self.gn2_bias = _empty((cout,), cfg, device)
        self.conv2 = _empty((3, 3, cout, cout), cfg, device)
        self.conv2_b = _empty((cout,), cfg, device)
        if cin != cout:
            self.skip = _empty((1, 1, cin, cout), cfg, device)

    def forward(self, x, temb):
        p = _locals(self)
        h = _groupnorm(x, p["gn1_scale"], p["gn1_bias"], self.n_groups)
        h = _conv(F.silu(h), p["conv1"], p["conv1_b"])
        t = F.silu(temb) @ p["time_w"].to(temb.dtype) + p["time_b"].to(
            temb.dtype)
        h = h + t[:, None, None, :].to(h.dtype)
        h = _groupnorm(h, p["gn2_scale"], p["gn2_bias"], self.n_groups)
        h = _conv(F.silu(h), p["conv2"], p["conv2_b"])
        skip = _conv(x, p["skip"]) if "skip" in p else x
        return skip + h


class Attention(nn.Module):
    """Single-head self-attention over the H·W positions."""

    def __init__(self, cfg: UNetConfig, c: int, device):
        super().__init__()
        self.n_groups = cfg.n_groups
        self.gn_scale = _empty((c,), cfg, device)
        self.gn_bias = _empty((c,), cfg, device)
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _empty((c, c), cfg, device))

    def forward(self, x):
        B, H, W, C = x.shape
        p = _locals(self)
        h = _groupnorm(x, p["gn_scale"], p["gn_bias"], self.n_groups)
        flat = h.reshape(B, H * W, C)
        dt = flat.dtype
        q = flat @ p["wq"].to(dt)
        k = flat @ p["wk"].to(dt)
        v = flat @ p["wv"].to(dt)
        logits = (q @ k.transpose(1, 2) / as_dtype(math.sqrt(C), dt)).float()
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = (probs @ v) @ p["wo"].to(dt)
        return x + out.reshape(B, H, W, C)


class Stage(nn.Module):
    """One resolution of the encoder or decoder: its blocks and, on all
    but one stage, the ``down``/``up`` conv (``kind``) with its bias."""

    def __init__(self, cfg: UNetConfig, widths, kind: Optional[str], c: int,
                 device):
        super().__init__()
        self.blocks = nn.ModuleList(ResBlock(cfg, cin, cout, device)
                                    for cin, cout in widths)
        self.kind = kind
        if kind is not None:
            setattr(self, kind, _empty((3, 3, c, c), cfg, device))
            setattr(self, kind + "_b", _empty((c,), cfg, device))

    def resample(self, h):
        p = _locals(self)
        if self.kind == "down":
            return _conv(h, p["down"], p["down_b"], stride=2)
        h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _conv(h, p["up"], p["up_b"])


class UNet(nn.Module):
    """The UNet. Parameters are allocated uninitialised; build one with
    :func:`init` (random) or :func:`from_jax_params` (carried over from
    the JAX package)."""

    jax_stacks: Dict[str, str] = {}
    # On a mesh (sharding.shard_model): forward is the only entry.
    fsdp_methods = ()

    def fsdp_units(self):
        """FSDP2's units: each stage's residual blocks, and the mid
        blocks."""
        blocks = [b for stage in self.down for b in stage.blocks]
        blocks += [self.mid1, self.mid_attn, self.mid2]
        return (*blocks, *(b for stage in self.up for b in stage.blocks))

    def __init__(self, cfg: UNetConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        chans = cfg.stage_channels
        td = cfg.time_dim
        self.time_w1 = _empty((td // 4, td), cfg, dev)
        self.time_b1 = _empty((td,), cfg, dev)
        self.time_w2 = _empty((td, td), cfg, dev)
        self.time_b2 = _empty((td,), cfg, dev)
        self.conv_in = _empty((3, 3, cfg.in_channels, chans[0]), cfg, dev)
        self.conv_in_b = _empty((chans[0],), cfg, dev)
        self.gn_out_scale = _empty((chans[0],), cfg, dev)
        self.gn_out_bias = _empty((chans[0],), cfg, dev)
        self.conv_out = _empty((3, 3, chans[0], cfg.in_channels), cfg, dev)
        self.conv_out_b = _empty((cfg.in_channels,), cfg, dev)

        n = cfg.n_res_blocks
        down, cin = [], chans[0]
        for si, c in enumerate(chans):
            widths = [(cin if i == 0 else c, c) for i in range(n)]
            cin = c
            down.append(Stage(cfg, widths,
                              "down" if si < len(chans) - 1 else None, c,
                              dev))
        self.down = nn.ModuleList(down)
        self.mid1 = ResBlock(cfg, chans[-1], chans[-1], dev)
        self.mid_attn = Attention(cfg, chans[-1], dev)
        self.mid2 = ResBlock(cfg, chans[-1], chans[-1], dev)
        up = []
        for si in reversed(range(len(chans))):
            c = chans[si]
            # Input = current features + same-resolution skip.
            widths = [((cin if i == 0 else c) + c, c) for i in range(n)]
            cin = c
            up.append(Stage(cfg, widths, "up" if si > 0 else None, c, dev))
        self.up = nn.ModuleList(up)

    def forward(self, x, t):
        """Predicted noise, fp32 [B, H, W, C], of ``x`` [B, H, W, C] at
        timesteps ``t`` [B] (int)."""
        cfg = self.cfg
        p = _locals(self)
        x = x.to(cfg.dtype)
        temb = timestep_embedding(t, cfg.time_dim // 4)
        temb = temb @ p["time_w1"].float() + p["time_b1"].float()
        temb = F.silu(temb) @ p["time_w2"].float() + p["time_b2"].float()

        h = _conv(x, p["conv_in"], p["conv_in_b"])
        skips = [h]
        for stage in self.down:
            for block in stage.blocks:
                h = block(h, temb)
                skips.append(h)
            if stage.kind is not None:
                h = stage.resample(h)
                skips.append(h)

        h = self.mid1(h, temb)
        h = self.mid_attn(h)
        h = self.mid2(h, temb)

        for stage in self.up:
            for block in stage.blocks:
                h = block(torch.cat([h, skips.pop()], dim=-1), temb)
            if stage.kind is not None:
                h = stage.resample(h)
                skips.pop()  # consume the post-downsample skip at this res

        h = _groupnorm(h, p["gn_out_scale"], p["gn_out_bias"], cfg.n_groups)
        out = _conv(F.silu(h), p["conv_out"], p["conv_out_b"])
        return out.float()


def forward(model: UNet, x, t):
    """Predict noise. x: [B, H, W, C], t: [B] int → fp32 [B, H, W, C]."""
    return model(x, t)


# -- parameters ---------------------------------------------------------

def init(cfg: UNetConfig, generator: torch.Generator,
         device: DeviceLike = None, mesh=None,
         rules: Optional[ShardingRules] = None) -> UNet:
    """A model with the JAX package's init distributions (convs N(0,
    1/fan_in), dense N(0, 1/cin), ``conv2``, ``wo`` and ``conv_out`` scaled
    by 1e-2; GroupNorm scales 1, biases 0), drawn from ``generator``,
    which must live on ``device``. The draws differ from ``jax.random``'s
    for the same seed. With ``mesh`` the model is placed there (every
    weight replicated) and holds the same values."""
    model = build(UNet, param_specs, cfg, device, mesh, rules)
    small = ("conv2", "wo", "conv_out")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2:  # a conv [kh, kw, cin, cout] or dense [cin, cout]
                std = (1e-2 if leaf in small else 1.0) / math.sqrt(
                    math.prod(p.shape[:-1]))
                value = torch.randn(p.shape, generator=generator,
                                    dtype=torch.float32, device=p.device)
                local(p).copy_(local_block(value * std, p))
            else:
                local(p).fill_(1.0 if leaf.endswith("_scale") else 0.0)
    return model


def from_jax_params(params: Dict[str, Any], cfg: UNetConfig,
                    device: DeviceLike = None, mesh=None,
                    rules: Optional[ShardingRules] = None) -> UNet:
    """The port's model holding exactly the values of ``params``: the
    nested tree that ``ray_tpu.models.diffusion.init`` returns, with numpy
    leaves. Values are copied into ``cfg.param_dtype``. With ``mesh`` the
    model is placed as :func:`init` places it."""
    return load_jax_params(
        build(UNet, param_specs, cfg, device, mesh, rules), params)


def param_specs(cfg: UNetConfig, rules: ShardingRules):
    """Replicated weights (conv UNets are batch-parallel; batch over dp),
    in the JAX package's tree."""
    return nest(leaf_groups(UNet(cfg, "meta")), lambda k, n: PartitionSpec())


def batch_spec(rules: ShardingRules) -> PartitionSpec:
    return rules.spec("batch", None, None, None)


# -- diffusion process --------------------------------------------------

# XLA's CPU backend, which computes the JAX package's reference values,
# fuses ``1 - i * r`` into one rounding over the leading multiple of 32
# elements of a linspace of 352 steps or more (its vectorised loop) and
# rounds the product apart elsewhere.
_FUSED_MIN, _FUSED_BLOCK = 352, 32


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 as the JAX package
    computes it: ``start * (1 - i*r) + stop * (i*r)`` for i < div = num - 1,
    with r = 1/div in float32 (XLA multiplies by the reciprocal of the
    constant divisor), then ``stop``."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    i = np.arange(div, dtype=np.float32)
    r = np.float32(1) / np.float32(div)
    step = i * r
    rest = np.float32(1) - step
    if div >= _FUSED_MIN:
        k = div // _FUSED_BLOCK * _FUSED_BLOCK
        rest[:k] = 1.0 - i[:k].astype(np.float64) * np.float64(r)
    out = start * rest + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


def _schedule(cfg: UNetConfig) -> Tuple[np.ndarray, np.ndarray]:
    betas = _linspace_f32(1e-4, 0.02, cfg.n_timesteps)
    return betas, np.cumprod(np.float32(1) - betas, dtype=np.float32)


def make_schedule(cfg: UNetConfig, device: DeviceLike = None):
    """Linear beta schedule → (betas, alphas_bar) as fp32 [T]."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in _schedule(cfg))


def ddim_timesteps(n_timesteps: int, n_steps: int) -> np.ndarray:
    """The sampler's timesteps: ``jnp.linspace(T - 1, 0, n_steps)
    .astype(int32)``, whose float32 values truncate (665.99994 → 665)."""
    return _linspace_f32(n_timesteps - 1, 0, n_steps).astype(np.int32)


def loss_fn(model: UNet, images, generator: Optional[torch.Generator] = None,
            t=None, eps=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Simple DDPM epsilon-prediction MSE loss. ``t`` [B] and ``eps``
    (images' shape, fp32) are drawn from ``generator`` unless given.

    Where the current step splits the batch over data ranks
    (``parallel.mesh.registered_mesh``), ``images`` (and ``t``, ``eps``
    when given) are this rank's rows: ``t`` and ``eps`` are drawn for the
    whole global batch, every rank alike, and this rank keeps its rows;
    the first value is this rank's share (its mean over the count of
    blocks) and the metric the global batch's loss. Ranks over ``sp``
    hold the same rows (an image has no sequence) and return the same."""
    cfg = model.cfg
    dev = images.device
    alphas_bar = torch.from_numpy(_schedule(cfg)[1]).to(dev)
    groups = batch_groups(batch_spec)
    B, rows = batch_rows(images.shape[0], groups)
    if t is None:
        t = torch.randint(0, cfg.n_timesteps, (B,), generator=generator,
                          device=dev)[rows]
    if eps is None:
        eps = torch.randn((B,) + tuple(images.shape[1:]),
                          generator=generator, dtype=torch.float32,
                          device=dev)[rows]
    ab = alphas_bar[t.long()][:, None, None, None]
    x_t = torch.sqrt(ab) * images.float() + torch.sqrt(1 - ab) * eps
    pred = model(x_t, t)
    loss = ((pred - eps) ** 2).mean()
    if not groups:
        return loss, {"loss": loss.detach()}
    # Every block holds as many items: the global mean is the blocks'.
    share = loss / (B // images.shape[0])
    return share, {"loss": batch_sum(share.detach(),
                                     [g.group for g in groups])}


@torch.no_grad()
def ddim_sample(model: UNet, generator: Optional[torch.Generator],
                batch: int, n_steps: int = 50, eta: float = 0.0,
                x_T=None) -> torch.Tensor:
    """DDIM sampler → fp32 images [batch, H, W, C]. ``x_T`` is drawn from
    ``generator`` unless given; the per-step noise (``eta > 0``) always
    is. The step's scalars are computed in fp32, as the JAX package's."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    shape = (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
    x = x_T.float() if x_T is not None else torch.randn(
        shape, generator=generator, dtype=torch.float32, device=dev)
    if tuple(x.shape) != shape:
        raise ValueError(f"x_T of shape {tuple(x.shape)}, not {shape}")
    ab = _schedule(cfg)[1]
    ts = ddim_timesteps(cfg.n_timesteps, n_steps)
    one, zero = np.float32(1), np.float32(0)
    for idx, t in enumerate(ts):
        ab_t = ab[t]
        ab_next = ab[ts[idx + 1]] if idx + 1 < n_steps else one
        eps = model(x, torch.full((batch,), int(t), dtype=torch.int32,
                                  device=dev))
        x0 = (x - float(np.sqrt(one - ab_t)) * eps) / float(np.sqrt(ab_t))
        x0 = x0.clamp(-3.0, 3.0)
        sigma = (np.float32(eta) * np.sqrt((one - ab_next) / (one - ab_t))
                 * np.sqrt(one - ab_t / ab_next))
        dir_xt = float(np.sqrt(max(one - ab_next - sigma ** 2, zero))) * eps
        x = float(np.sqrt(ab_next)) * x0 + dir_xt
        if eta:
            x = x + float(sigma) * torch.randn(
                shape, generator=generator, dtype=torch.float32, device=dev)
    return x


__all__ = ["Attention", "PRESETS", "ResBlock", "Stage", "UNet", "UNetConfig",
           "batch_spec", "config", "ddim_sample",
           "ddim_timesteps", "forward", "from_jax_params", "init",
           "leaf_groups", "loss_fn", "make_schedule", "param_specs",
           "timestep_embedding", "to_jax_params"]
