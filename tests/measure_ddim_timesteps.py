"""Whether the port's DDIM timesteps equal the JAX package's for every
sampler length: a one-off sweep, not a test (each length makes JAX compile
``jnp.linspace`` again).

For T in the arguments (default 1000) and every ``n_steps`` in 2..T, it
compares ``ray_tpu_torch.models.diffusion.ddim_timesteps(T, n_steps)``
with ``jnp.linspace(T - 1, 0, n_steps).astype(int32)`` (what
``ray_tpu.models.diffusion.ddim_sample`` computes), and the float32 values
before the cast, and prints the lengths that differ. Run from the repo
root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/measure_ddim_timesteps.py [T ...]

(~70 s at T 1000.)
"""

import sys
import time

import jax.numpy as jnp
import numpy as np

from ray_tpu_torch.models import diffusion


def main():
    for T in map(int, sys.argv[1:] or ["1000"]):
        t0 = time.perf_counter()
        floats, ints = [], []
        for n in range(2, T + 1):
            ref = np.asarray(jnp.linspace(T - 1, 0, n))
            got = diffusion._linspace_f32(T - 1, 0, n)
            if not np.array_equal(ref, got):
                floats.append(n)
            if not np.array_equal(ref.astype(np.int32),
                                  diffusion.ddim_timesteps(T, n)):
                ints.append(n)
        print(f"T {T}: {T - 1} lengths; float32 values differ at {floats}, "
              f"integers at {ints} ({time.perf_counter() - t0:.0f} s)")


if __name__ == "__main__":
    main()
