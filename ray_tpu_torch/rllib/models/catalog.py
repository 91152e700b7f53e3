"""ModelCatalog: observation encoders from model config.

The port of ``ray_tpu/rllib/models/catalog.py``: maps (observation space,
model config) to a network. Both encoder families keep the JAX package's
parameter trees, so a tree written by either package loads in the other:

* MLP (``fcnet_hiddens``) for flat observations: ``[{"w", "b"}, ...]``
  with ``w`` as ``[in, out]``;
* CNN (``conv_filters`` [[out_channels, kernel, stride], ...]) for image
  observations (rank-3 HWC): kernels as ``[k, k, in, out]`` (HWIO), run
  by ``F.conv2d`` on NHWC input with ``"SAME"`` padding and flattened in
  NHWC order, as ``lax.conv_general_dilated`` lays them out there.

Parameters are drawn on the host from a ``torch.Generator`` and then moved
to the device, so one seed gives one tree on every device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_CONV_FILTERS = [[16, 4, 2], [32, 4, 2], [64, 3, 1]]


def _normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return w.to(device).requires_grad_()


def _zeros(n: int, device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=device,
                       requires_grad=True)


def mlp_init(gen: torch.Generator, sizes: Sequence[int],
             device=None) -> List[Dict[str, torch.Tensor]]:
    return [{"w": _normal(gen, (sizes[i], sizes[i + 1]),
                          math.sqrt(2.0 / sizes[i]), device),
             "b": _zeros(sizes[i + 1], device)}
            for i in range(len(sizes) - 1)]


def mlp_apply(params, x: torch.Tensor, activate_last: bool = False
              ) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or activate_last:
            x = torch.tanh(x)
    return x


def _same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: out = ceil(size / s), the
    odd pixel on the high side."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class ModelCatalog:
    """Builds (init_fn, apply_fn, feature_dim) encoders."""

    @staticmethod
    def is_image_space(obs_space) -> bool:
        shape = getattr(obs_space, "shape", None)
        return shape is not None and len(shape) == 3

    @staticmethod
    def get_encoder(obs_space, model_config: Dict[str, Any]
                    ) -> Tuple[Callable, Callable, int]:
        """Returns (init(gen, device) -> params, apply(params, obs) ->
        [B, F], feature_dim). ``obs`` enters flattened for MLP, HWC for
        CNN."""
        if ModelCatalog.is_image_space(obs_space):
            return ModelCatalog._cnn_encoder(obs_space, model_config)
        obs_dim = int(np.prod(obs_space.shape))
        hiddens = tuple(model_config.get("fcnet_hiddens", (64, 64)))
        sizes = [obs_dim, *hiddens]

        def init(gen, device=None):
            return {"mlp": mlp_init(gen, sizes, device)}

        def apply(params, obs):
            obs = obs.reshape((obs.shape[0], -1))
            return mlp_apply(params["mlp"], obs, activate_last=True)

        return init, apply, hiddens[-1] if hiddens else obs_dim

    @staticmethod
    def _cnn_encoder(obs_space, model_config):
        h, w, c = obs_space.shape
        filters = model_config.get("conv_filters") or DEFAULT_CONV_FILTERS
        head_dim = int(model_config.get("post_fcnet_dim", 256))

        # Output spatial dims (SAME padding, strided), and each layer's
        # padding of its input.
        shapes, pads = [], []
        ch, hh, ww = c, h, w
        for out_ch, k, s in filters:
            ph, pw = _same_padding(hh, k, s), _same_padding(ww, k, s)
            pads.append((pw[0], pw[1], ph[0], ph[1]))
            hh = -(-hh // s)
            ww = -(-ww // s)
            shapes.append((ch, out_ch, k))
            ch = out_ch
        flat_dim = hh * ww * ch

        def init(gen, device=None):
            convs = [{"w": _normal(gen, (k, k, in_ch, out_ch),
                                   math.sqrt(2.0 / (in_ch * k * k)), device),
                      "b": _zeros(out_ch, device)}
                     for in_ch, out_ch, k in shapes]
            return {"convs": convs,
                    "head": mlp_init(gen, [flat_dim, head_dim], device)}

        strides = [s for _, _, s in filters]

        # Pixel observations (uint8 spaces, e.g. wrapped Atari) are kept
        # uint8 on the host and scaled to [0, 1] here, as the JAX
        # package's apply does.
        scale = (np.float32(1.0 / 255.0)
                 if getattr(obs_space, "dtype", None) == np.uint8
                 else np.float32(1.0))

        def apply(params, obs):
            x = obs.reshape((-1, h, w, c)).to(torch.float32) * float(scale)
            x = x.permute(0, 3, 1, 2)  # NCHW for conv2d
            for conv, s, pad in zip(params["convs"], strides, pads):
                x = F.conv2d(F.pad(x, pad), conv["w"].permute(3, 2, 0, 1),
                             stride=s)
                x = torch.relu(x + conv["b"][:, None, None])
            x = x.permute(0, 2, 3, 1).reshape((x.shape[0], -1))  # NHWC
            return mlp_apply(params["head"], x, activate_last=True)

        return init, apply, head_dim
