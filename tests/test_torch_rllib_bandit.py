"""The port's contextual bandits (LinUCB, LinTS) and
``tests/test_rllib_bandit.py``'s cases on the port.

``algorithms/bandit.py`` is a copy of the JAX package's
(``tests/_torch_runtime_copy.py``): the posteriors are numpy on the host in
both packages, so the same seeds give the same arms' posteriors and the
same choices, held here bit for bit. The probe policy `Algorithm` builds
is on the CPU (``.resources(device="cpu")``).
"""

import numpy as np
import pytest

from _torch_rllib_pair import port_cluster


class LinearBanditEnv:
    """K arms with hidden weight vectors; reward = theta_a . x + noise.
    One round per episode (bandit contract)."""

    def __init__(self, config=None):
        import gymnasium as gym
        config = config or {}
        self.dim = int(config.get("dim", 4))
        self.k = int(config.get("arms", 3))
        self.noise = float(config.get("noise", 0.05))
        rng = np.random.default_rng(int(config.get("seed", 0)))
        self.thetas = rng.normal(size=(self.k, self.dim))
        self._rng = rng
        self.observation_space = gym.spaces.Box(
            -1.0, 1.0, (self.dim,), np.float32)
        self.action_space = gym.spaces.Discrete(self.k)
        self._x = None

    def _ctx(self):
        x = self._rng.normal(size=(self.dim,))
        return (x / np.linalg.norm(x)).astype(np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._x = self._ctx()
        return self._x, {}

    def step(self, arm):
        x = self._x
        reward = float(self.thetas[int(arm)] @ x
                       + self.noise * self._rng.normal())
        self.best = float((self.thetas @ x).max())
        self._x = self._ctx()
        return self._x, reward, True, False, {}


@pytest.mark.parametrize("algo_name", ["BanditLinUCB", "BanditLinTS"])
def test_the_posteriors_match_jax(ray_start_regular, port_cluster,
                                  algo_name):
    """Three iterations of both packages' bandit from one seed: the same
    results and every arm's A^-1 and b, bit for bit."""
    import ray_tpu.rllib as jrllib
    import ray_tpu_torch.rllib as rllib
    algos = []
    for mod, extra in ((jrllib, {}), (rllib, {"device": "cpu"})):
        cfg = (getattr(mod, f"{algo_name}Config")()
               .environment(LinearBanditEnv,
                            env_config={"dim": 4, "arms": 3, "seed": 5})
               .training(rounds_per_iteration=50)
               .resources(**extra).debugging(seed=11))
        algos.append(cfg.build())
    jalgo, algo = algos
    for _ in range(3):
        got, want = algo.train(), jalgo.train()
        for k in ("episode_reward_mean", "mean_reward_this_iter",
                  "cumulative_reward", "rounds_total"):
            assert got[k] == want[k], k
    for mine, ref in zip(algo._arms, jalgo._arms):
        np.testing.assert_array_equal(mine.A_inv, ref.A_inv)
        np.testing.assert_array_equal(mine.b, ref.b)
    x = np.ones(4, np.float32) / 2.0
    assert algo.compute_single_action(x) == jalgo.compute_single_action(x)
    for a in algos:
        a.stop()


# -- tests/test_rllib_bandit.py on the port --------------------------------

@pytest.mark.parametrize("algo_name", ["BanditLinUCB", "BanditLinTS"])
def test_bandit_beats_uniform_and_approaches_optimal(port_cluster,
                                                     algo_name):
    from ray_tpu_torch.rllib import BanditLinTSConfig, BanditLinUCBConfig
    cfg_cls = (BanditLinUCBConfig if algo_name == "BanditLinUCB"
               else BanditLinTSConfig)
    config = (cfg_cls()
              .environment(LinearBanditEnv,
                           env_config={"dim": 4, "arms": 3, "seed": 5})
              .training(rounds_per_iteration=200)
              .resources(device="cpu")
              .debugging(seed=11))
    algo = config.build()
    first = algo.train()["mean_reward_this_iter"]
    for _ in range(9):
        res = algo.train()
    last = res["mean_reward_this_iter"]

    # Uniform-random baseline on the same env/context stream.
    env = LinearBanditEnv({"dim": 4, "arms": 3, "seed": 5})
    env.reset(seed=123)
    rng = np.random.default_rng(0)
    uni, opt = [], []
    for _ in range(1000):
        _, r, *_ = env.step(rng.integers(3))
        uni.append(r)
        opt.append(env.best)
    uniform_mean, optimal_mean = np.mean(uni), np.mean(opt)

    assert last > uniform_mean + 0.5 * (optimal_mean - uniform_mean), (
        f"{algo_name}: last={last:.3f} uniform={uniform_mean:.3f} "
        f"optimal={optimal_mean:.3f}")
    # And the posterior sharpens over training.
    assert last >= first - 0.05
    # Greedy single-action API works.
    obs, _ = env.reset(seed=7)
    arm = algo.compute_single_action(obs)
    assert 0 <= arm < 3
    algo.stop()


def test_bandit_state_roundtrip(port_cluster):
    from ray_tpu_torch.rllib import BanditLinUCBConfig
    config = (BanditLinUCBConfig()
              .environment(LinearBanditEnv, env_config={"seed": 2})
              .training(rounds_per_iteration=50)
              .resources(device="cpu")
              .debugging(seed=3))
    algo = config.build()
    algo.train()
    state = algo.get_state()
    algo2 = config.build()
    algo2.set_state(state)
    x = np.ones(4, np.float32) / 2.0
    assert algo.compute_single_action(x) == algo2.compute_single_action(x)
    algo.stop()
    algo2.stop()


def test_bandit_algorithm_save_restore(port_cluster, tmp_path):
    """Algorithm.save/restore persists the arm posteriors (the bandit's
    real 'weights')."""
    from ray_tpu_torch.rllib import BanditLinUCBConfig
    cfg = (BanditLinUCBConfig()
           .environment(LinearBanditEnv, env_config={"seed": 9})
           .training(rounds_per_iteration=100)
           .resources(device="cpu")
           .debugging(seed=6))
    algo = cfg.build()
    algo.train()
    path = algo.save(str(tmp_path))
    algo2 = cfg.build()
    algo2.restore(path)
    x = np.ones(4, np.float32) / 2.0
    assert algo.compute_single_action(x) == algo2.compute_single_action(x)
    np.testing.assert_allclose(algo._arms[0].A_inv, algo2._arms[0].A_inv)
    algo.stop(); algo2.stop()
