"""The port's APEX-DDPG preset and the TD3 engine paths it turns on, the
random baseline, and ``tests/test_rllib_apex_ddpg.py``'s cases on the port.

``algorithms/apex_ddpg.py`` and ``algorithms/random_agent.py`` are copies
of the JAX package's (``tests/_torch_runtime_copy.py``): the preset's
settings equal the JAX preset's, and its learner is the port's DDPG (TD3)
on ``config.device``. The learners run on the CPU
(``.resources(device="cpu")``).
"""

import numpy as np

from _torch_rllib_pair import one_torch_thread, port_cluster
from ray_tpu.rllib import ApexDDPGConfig as JApexDDPGConfig
from ray_tpu.rllib import RandomAgentConfig as JRandomAgentConfig


def test_the_presets_equal_the_jax_packages():
    """Every setting of APEX-DDPG's and the random agent's configs, but
    the port's device (None: the CUDA card)."""
    from ray_tpu_torch.rllib import ApexDDPGConfig, RandomAgentConfig
    for cfg, jcfg in ((ApexDDPGConfig(), JApexDDPGConfig()),
                      (RandomAgentConfig(), JRandomAgentConfig())):
        got, want = cfg.to_dict(), jcfg.to_dict()
        assert got.pop("device") is None
        assert got == want


# -- tests/test_rllib_apex_ddpg.py on the port -----------------------------

def test_apex_ddpg_preset_wiring():
    from ray_tpu_torch.rllib import ApexDDPG, ApexDDPGConfig
    from ray_tpu_torch.rllib.algorithms.ddpg import DDPG
    cfg = ApexDDPGConfig()
    assert issubclass(ApexDDPG, DDPG)
    assert cfg.prioritized_replay and cfg.n_step == 3
    assert cfg.num_rollout_workers == 4
    # DDPG semantics preserved: every-step actor updates, no smoothing.
    assert cfg.policy_delay == 1 and cfg.target_noise == 0.0


def test_td3_engine_prioritized_nstep(port_cluster):
    """The engine paths APEX-DDPG turns on: n-step rewritten batches land
    in a prioritized buffer whose priorities move after updates."""
    from ray_tpu_torch.rllib import TD3Config
    from ray_tpu_torch.rllib.utils.replay_buffers import (
        PrioritizedReplayBuffer)
    algo = (TD3Config().environment("Pendulum-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
            .training(prioritized_replay=True, n_step=3,
                      num_steps_sampled_before_learning_starts=64,
                      train_batch_size=32,
                      num_train_batches_per_iteration=4)
            .resources(device="cpu")
            .debugging(seed=0)).build()
    algo.train()
    assert isinstance(algo._buffer, PrioritizedReplayBuffer)
    pri = np.asarray(algo._buffer._priorities)
    # Updates pushed TD-error priorities in; not all rows still carry
    # the max-priority default.
    assert len(set(np.round(pri, 6))) > 1
    algo.stop()


def test_random_agent_baseline(port_cluster):
    from ray_tpu_torch.rllib import RandomAgentConfig
    algo = (RandomAgentConfig().environment("CartPole-v1")
            .training(rollout_steps_per_iteration=500)
            .resources(device="cpu")
            .debugging(seed=0)).build()
    res = algo.train()
    # Uniform-random CartPole sits near 20 steps/episode.
    assert 10.0 < res["episode_reward_mean"] < 40.0
    assert res["episodes_total"] > 5
    algo.stop()


def test_random_agent_matches_jax(ray_start_regular, port_cluster):
    """The same seed gives the same random episodes in both packages."""
    from ray_tpu_torch.rllib import RandomAgentConfig
    results = []
    for cfg in (JRandomAgentConfig(),
                RandomAgentConfig().resources(device="cpu")):
        algo = (cfg.environment("CartPole-v1")
                .training(rollout_steps_per_iteration=300)
                .debugging(seed=4)).build()
        results.append(algo.train())
        algo.stop()
    want, got = results
    for k in ("episode_reward_mean", "episodes_total", "timesteps_total"):
        assert got[k] == want[k], k
