"""How far the DDIM images of a bf16 UNet lie from the same sampler in
fp32, in the JAX package and in the port, on the CPU: a one-off
measurement, not a test.

Both packages take the same weights (``ray_tpu.models.diffusion.init``,
carried with ``from_jax_params``) and the same ``x_T`` (the JAX sampler's
own draw from its key), at a preset's full width and depth, 50 DDIM steps
at ``eta`` 0, with a cut batch. For each package it prints the max and
the RMS of |bf16 - fp32| over its own images and the largest |pixel|;
then the max distance between the two packages' fp32 images and between
their bf16 images, and the FLOPs of one forward per image
(``torch.utils.flop_counter`` on the port's UNet on the meta device). Run
from the repo root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/measure_unet_bf16_gap.py [PRESET BATCH ...]

(default ``ddpm-cifar 2``). ``sd-base`` at batch 1 takes a few minutes
and under 8 GB.
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu.models import diffusion as jd
from ray_tpu_torch.models import diffusion as td

STEPS, SEED = 50, 0


def _stats(a, b):
    d = np.abs(a - b)
    return float(d.max()), float(np.sqrt((d ** 2).mean()))


def forward_flops(preset: str) -> int:
    """FLOPs of one forward of the port's UNet per image."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = td.config(preset, dtype=torch.float32)
    model = td.UNet(cfg, "meta")
    x = torch.zeros((1, cfg.image_size, cfg.image_size, cfg.in_channels),
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        model(x, torch.zeros((1,), dtype=torch.long, device="meta"))
    return counter.get_total_flops()


def measure(preset: str, batch: int) -> dict:
    params = jax.tree_util.tree_map(
        np.asarray, jd.init(jd.config(preset, dtype=jnp.float32),
                            jax.random.PRNGKey(SEED)))
    key = jax.random.PRNGKey(SEED + 1)
    cfg = jd.config(preset)
    x_T = np.asarray(jax.random.normal(
        jax.random.split(key)[0],
        (batch, cfg.image_size, cfg.image_size, cfg.in_channels),
        jnp.float32))
    out = {}
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        with jax.default_matmul_precision("highest"):
            sample = jax.jit(jd.ddim_sample, static_argnums=(1, 3, 4))
            out[f"jax_{name}"] = np.asarray(sample(
                params, jd.config(preset, dtype=jdt), key, batch, STEPS))
        model = td.from_jax_params(params, td.config(preset, dtype=tdt),
                                   "cpu")
        out[f"port_{name}"] = td.ddim_sample(
            model, None, batch, STEPS, x_T=torch.from_numpy(x_T)).numpy()
    return out


def main():
    args = sys.argv[1:] or ["ddpm-cifar", "2"]
    for preset, batch in zip(args[::2], map(int, args[1::2])):
        t0 = time.perf_counter()
        print(f"{preset}: {forward_flops(preset) / 1e9:.2f} GFLOP per image "
              f"per forward")
        out = measure(preset, batch)
        for pkg in ("jax", "port"):
            mx, rms = _stats(out[f"{pkg}_bf16"], out[f"{pkg}_fp32"])
            print(f"{preset} batch {batch} {pkg}: max|bf16 - fp32| "
                  f"{mx:.4f}, RMS {rms:.5f}, max|pixel| "
                  f"{np.abs(out[f'{pkg}_fp32']).max():.3f}")
        print(f"{preset}: port vs jax fp32 max "
              f"{_stats(out['port_fp32'], out['jax_fp32'])[0]:.3e}, bf16 max "
              f"{_stats(out['port_bf16'], out['jax_bf16'])[0]:.4f} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
