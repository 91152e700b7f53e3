"""Multi-agent PPO: two policies with opposing objectives.

The counterpart of the JAX package's ``examples/multi_agent_ppo.py``:

    python -m ray_tpu_torch.examples.multi_agent_ppo          # the card
    python -m ray_tpu_torch.examples.multi_agent_ppo --cpu    # anywhere

Agent a0 is rewarded for action 1, agent a1 for action 0 — a shared
policy cannot satisfy both, so the two mapped policies must diverge
(the canonical policy-map smoke test). The learner's policies live on the
CUDA card unless ``--cpu`` is given; the rollout workers sample on the
CPU.
"""

import argparse

import gymnasium as gym
import numpy as np

from ray_tpu_torch.rllib import MultiAgentEnv, PPOConfig


class OpposingBandits(MultiAgentEnv):
    agent_ids = {"a0", "a1"}
    observation_space = gym.spaces.Box(-1, 1, (2,), np.float32)
    action_space = gym.spaces.Discrete(2)

    def __init__(self, episode_len=10):
        self.episode_len = episode_len
        self._t = 0

    def _obs(self):
        return {a: np.zeros(2, np.float32) for a in ("a0", "a1")}

    def reset(self, *, seed=None, options=None):
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        self._t += 1
        rewards = {"a0": float(action_dict["a0"] == 1),
                   "a1": float(action_dict["a1"] == 0)}
        done = self._t >= self.episode_len
        return (self._obs(), rewards,
                {"a0": done, "a1": done, "__all__": done},
                {"a0": False, "a1": False, "__all__": False}, {})


def main(argv=None):
    """Trains 10 iterations; returns the last result and both policies'
    greedy actions."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="learn on the CPU, not on the card")
    args = parser.parse_args(argv)

    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        # Rollout workers are thread-based: oversubscribing a small host
        # is fine, but the logical CPU pool must fit the worker count.
        ray_tpu_torch.init(num_cpus=8)
    algo = (PPOConfig()
            .environment(lambda cfg: OpposingBandits())
            .rollouts(num_rollout_workers=2)
            .multi_agent(policies={"p0": None, "p1": None},
                         policy_mapping_fn=lambda aid: "p" + aid[1])
            .training(lr=5e-3, train_batch_size=400,
                      num_sgd_iter=6, sgd_minibatch_size=100)
            .resources(device="cpu" if args.cpu else None)
            .debugging(seed=0)).build()
    for i in range(10):
        res = algo.train()
        print(f"iter {i + 1}: joint reward "
              f"{res['episode_reward_mean']:.1f}/20  "
              f"p0 loss {res['p0/total_loss']:.3f}  "
              f"p1 loss {res['p1/total_loss']:.3f}")
    obs = np.zeros(2, np.float32)
    greedy = {pid: algo.compute_single_action(obs, policy_id=pid)
              for pid in ("p0", "p1")}
    print("greedy actions: p0 ->", greedy["p0"], " p1 ->", greedy["p1"])
    algo.stop()
    return res, greedy


if __name__ == "__main__":
    main()
