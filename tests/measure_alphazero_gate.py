"""cartpole-alphazero's learning curve in the JAX package and in the port.

A one-off CPU measurement, not a test. For each seed given it trains the
tuned example (``tuned_examples/__init__.py``'s cartpole-alphazero: 30
simulations, 64x64, gate 60 within 35 iterations) three ways and prints
each iteration's ``episode_reward_mean`` until the gate or the budget:

* ``jax``: the JAX package's algorithm;
* ``port``: the port's, its network drawn from its own torch generator;
* ``port-from-jax``: the port's, starting from the JAX algorithm's initial
  weights (``set_weights``), every other draw (the environment, Dirichlet
  noise, visit-count sampling, replay) from the same numpy seeds.

Run from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/measure_alphazero_gate.py 0 1

(~2 minutes a seed on one core.)
"""

import sys

import jax
import numpy as np


def curve(algo, ex):
    rewards = []
    for _ in range(ex.max_iters):
        r = algo.train()["episode_reward_mean"]
        rewards.append(round(r, 1))
        if r >= ex.stop_reward:
            break
    algo.stop()
    return rewards


def main(seeds):
    jax.config.update("jax_platforms", "cpu")
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.rllib.tuned_examples import TUNED_EXAMPLES as JAX
    from ray_tpu_torch.rllib.tuned_examples import TUNED_EXAMPLES as PORT

    ray_tpu.init(num_cpus=2, num_tpus=0)
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    ex = PORT["cartpole-alphazero"]
    for seed in seeds:
        def jax_algo():
            return JAX["cartpole-alphazero"].build_config().debugging(
                seed=seed).build()

        def port_algo():
            return ex.build_config().resources(device="cpu").debugging(
                seed=seed).build()

        init = jax.tree.map(np.asarray, jax_algo().get_weights())
        carried = port_algo()
        carried.set_weights(init)
        for name, algo in (("jax", jax_algo()), ("port", port_algo()),
                           ("port-from-jax", carried)):
            rewards = curve(algo, ex)
            print(f"seed {seed} {name:13s} {len(rewards)} iterations, best "
                  f"{max(rewards)}, passed {max(rewards) >= ex.stop_reward}:"
                  f" {rewards}", flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [0])
