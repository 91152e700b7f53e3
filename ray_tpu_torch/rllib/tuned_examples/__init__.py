"""Tuned examples: the regression-benchmark registry.

Analog of the reference's rllib/tuned_examples/ YAMLs (e.g.
ppo/atari-ppo.yaml, ppo/cartpole-ppo.yaml): each entry is a tuned config
plus a stopping criterion (reward threshold within a training budget)
that CI asserts — algorithms are regression-tested on LEARNING CURVES,
not just finiteness. ``run_tuned_example`` is the harness the tests and
``bench.py`` share.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


@dataclass
class TunedExample:
    name: str
    build_config: Callable[[], Any]  # () -> AlgorithmConfig, built lazily
    stop_reward: float               # CI tier: episode_reward_mean >= this
    max_iters: int                   # within this many algo.train() calls
    notes: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)
    #: Nightly tier — the REFERENCE-grade stop reward (e.g. cartpole
    #: family gates at 150, matching tuned_examples/ppo/cartpole-ppo.yaml)
    #: with a budget sized for it. CI keeps the fast bar; the nightly
    #: bar is exercised by tests/test_rllib_tuned.py's RAY_TPU_NIGHTLY
    #: tier and documents measured headroom above the CI gate.
    nightly_stop_reward: Optional[float] = None
    nightly_max_iters: Optional[int] = None


def _cartpole_ppo():
    from ray_tpu_torch.rllib import PPOConfig
    return (PPOConfig()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2)
            .training(lr=1e-3, train_batch_size=1024, num_sgd_iter=10,
                      sgd_minibatch_size=256)
            .debugging(seed=7))


def _cartpole_a2c():
    from ray_tpu_torch.rllib import A2CConfig
    return (A2CConfig()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=64)
            .training(lr=2e-3, train_batch_size=512)
            .debugging(seed=11))


def _cartpole_dqn():
    from ray_tpu_torch.rllib import DQNConfig
    return (DQNConfig()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
            .training(lr=8e-4, train_batch_size=64,
                      num_steps_sampled_before_learning_starts=500,
                      num_train_batches_per_iteration=32,
                      target_network_update_freq=128,
                      epsilon_timesteps=3000, dueling=True,
                      double_q=True)
            .debugging(seed=5))


def _cartpole_rainbow():
    """Five of the six Rainbow components (C51 + double + dueling + PER
    + 3-step). Noisy nets are implemented (policy/rainbow_policy.py) but
    off here: noise-driven exploration is reliably outperformed by the
    epsilon schedule at CartPole scale — q-value gaps outgrow the noise
    within a few hundred steps."""
    from ray_tpu_torch.rllib import RainbowConfig
    cfg = (RainbowConfig()
           .environment("CartPole-v1")
           .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
           .training(lr=8e-4, train_batch_size=64, v_min=0.0, v_max=120.0,
                     noisy=False, prioritized_replay=True, n_step=3,
                     epsilon_timesteps=3000,
                     num_steps_sampled_before_learning_starts=500,
                     num_train_batches_per_iteration=64,
                     target_network_update_freq=64)
           .debugging(seed=3))
    cfg.epsilon_initial = 1.0
    cfg.epsilon_final = 0.02
    return cfg


def _cartpole_r2d2():
    """Recurrent replay DQN: LSTM Q-net on sequence windows with stored
    hidden states + burn-in. CartPole learns through the recurrence
    (slower and noisier than feed-forward DQN — the tuned threshold
    reflects the method's variance at this scale)."""
    from ray_tpu_torch.rllib import R2D2Config
    return (R2D2Config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
            .training(lr=1e-3, train_batch_size=32, seq_len=10, burn_in=4,
                      epsilon_timesteps=4000,
                      num_steps_sampled_before_learning_starts=500,
                      num_train_batches_per_iteration=64,
                      target_network_update_freq=128)
            .debugging(seed=3))


def _coordination_qmix():
    """QMIX on the cooperative coordination game: both agents must match
    the shared context to score — team reward only, credit assigned
    through the monotonic mixer."""
    from ray_tpu_torch.rllib import QMixConfig
    from ray_tpu_torch.rllib.env.examples import CoordinationGameEnv
    return (QMixConfig()
            .environment(CoordinationGameEnv,
                         env_config={"rounds": 10, "n_contexts": 2})
            .training(lr=5e-4, train_batch_size=32,
                      rollout_steps_per_iteration=200,
                      epsilon_timesteps=3000,
                      num_train_batches_per_iteration=32)
            .debugging(seed=7))


def _pendulum_sac():
    from ray_tpu_torch.rllib import SACConfig
    return (SACConfig()
            .environment("Pendulum-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
            .training(lr=3e-4, train_batch_size=256,
                      num_steps_sampled_before_learning_starts=500,
                      # 1 gradient step per env step (the canonical SAC
                      # ratio) — at 32/iter the 100-episode reward window
                      # barely moves inside the budget.
                      num_train_batches_per_iteration=256, tau=0.005,
                      model={"fcnet_hiddens": [256, 256]})
            .debugging(seed=2))


def _recsim_slateq():
    """SlateQ on the RecSim-style interest-evolution env: the clickbait
    knob anti-correlates immediate appeal with quality, so beating the
    random baseline (~14.1/episode) requires the learned choice model +
    item-level LTV decomposition."""
    from ray_tpu_torch.rllib import SlateQConfig
    from ray_tpu_torch.rllib.env.recsim import RecSimEnv
    return (SlateQConfig()
            .environment(RecSimEnv, env_config={"seed": 0})
            .debugging(seed=0))


def _spread_maddpg():
    """MADDPG on cooperative navigation (simple-spread shape): shared
    team reward = -sum of landmark distances; random ~= -66/episode."""
    from ray_tpu_torch.rllib import MADDPGConfig
    from ray_tpu_torch.rllib.env.examples import CooperativeNavEnv
    return (MADDPGConfig()
            .environment(CooperativeNavEnv, env_config={"seed": 0})
            .debugging(seed=0))


def _cartpole_alphazero():
    """AlphaZero's own example task (reference alpha_zero README):
    MCTS over clonable CartPole. Random ~= 20; 30-simulation search
    with learned priors passes 60 within the budget."""
    from ray_tpu_torch.rllib import AlphaZeroConfig
    from ray_tpu_torch.rllib.env.examples import ClonableCartPole
    return (AlphaZeroConfig()
            .environment(ClonableCartPole)
            .debugging(seed=0))


def _cartpole_ddppo():
    """Decentralized PPO: 2 workers gradient-allreducing per minibatch;
    the learning curve must track plain PPO's."""
    from ray_tpu_torch.rllib import DDPPOConfig
    return (DDPPOConfig()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2)
            .training(lr=5e-4, num_sgd_iter=4, sgd_minibatch_size=128)
            .debugging(seed=0))


def _pointgoal_dreamer():
    """Dreamer on the 1D reach-the-origin task: the world model fits in
    a few hundred steps, so latent imagination visibly improves the
    policy inside a CI budget (Pendulum-class tasks need 10^5+ frames —
    the reference tunes Dreamer on DMC over millions)."""
    from ray_tpu_torch.rllib import DreamerConfig
    from ray_tpu_torch.rllib.env.examples import PointGoalEnv
    return (DreamerConfig()
            .environment(PointGoalEnv)
            .training(prefill_steps=300, rollout_steps_per_iteration=150,
                      num_train_batches_per_iteration=20, seq_len=10,
                      imagine_horizon=8, action_repeat=1)
            .debugging(seed=0))


def _atari_ppo():
    """The north-star shape (reference: tuned_examples/ppo/atari-ppo.yaml)
    on the synthetic Catch game: pixels in, CNN policy, deepmind wrapper
    stack. dim=42/framestack=2 keep the CPU regression affordable; the
    bench runs the full 84x84x4."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.env.atari import make_synthetic_atari
    return (PPOConfig()
            .environment(make_synthetic_atari,
                         env_config={"dim": 42, "framestack": 2,
                                     "drops": 2, "fall": 14})
            .rollouts(num_rollout_workers=2, rollout_fragment_length=128)
            .training(lr=8e-4, train_batch_size=1024, num_sgd_iter=6,
                      sgd_minibatch_size=256, entropy_coeff=0.01,
                      model={"conv_filters": [[16, 8, 4], [32, 4, 2],
                                              [32, 3, 2]],
                             "post_fcnet_dim": 128})
            .debugging(seed=17))


TUNED_EXAMPLES: Dict[str, TunedExample] = {
    "cartpole-ppo": TunedExample(
        "cartpole-ppo", _cartpole_ppo, stop_reward=60.0, max_iters=20,
        nightly_stop_reward=150.0, nightly_max_iters=80,
        notes="reference: tuned_examples/ppo/cartpole-ppo.yaml"),
    "cartpole-a2c": TunedExample(
        "cartpole-a2c", _cartpole_a2c, stop_reward=50.0, max_iters=30,
        nightly_stop_reward=150.0, nightly_max_iters=150,
        notes="reference: tuned_examples/a2c/cartpole-a2c.yaml"),
    "cartpole-dqn": TunedExample(
        "cartpole-dqn", _cartpole_dqn, stop_reward=50.0, max_iters=40,
        nightly_stop_reward=150.0, nightly_max_iters=200,
        notes="reference: tuned_examples/dqn/cartpole-dqn.yaml"),
    "cartpole-rainbow": TunedExample(
        "cartpole-rainbow", _cartpole_rainbow, stop_reward=65.0,
        max_iters=30, nightly_stop_reward=150.0, nightly_max_iters=120,
        notes="reference: rllib/algorithms/dqn with num_atoms>1 (Rainbow "
              "flags); C51 cross-entropy vs projected target"),
    "cartpole-r2d2": TunedExample(
        "cartpole-r2d2", _cartpole_r2d2, stop_reward=35.0, max_iters=70,
        nightly_stop_reward=100.0, nightly_max_iters=250,
        notes="reference: rllib/algorithms/r2d2"),
    "coordination-qmix": TunedExample(
        "coordination-qmix", _coordination_qmix, stop_reward=8.0,
        max_iters=40,
        notes="reference: rllib/algorithms/qmix; optimal team return 10, "
              "uniform-random ~= 10/9 with 3 actions x 2 contexts"),
    "pendulum-sac": TunedExample(
        "pendulum-sac", _pendulum_sac, stop_reward=-500.0, max_iters=75,
        nightly_stop_reward=-250.0, nightly_max_iters=250,
        notes="reference: tuned_examples/sac/pendulum-sac.yaml; random "
              "policy ~= -1200, tuned SAC reaches > -500"),
    "recsim-slateq": TunedExample(
        "recsim-slateq", _recsim_slateq, stop_reward=17.0, max_iters=10,
        notes="reference: rllib/algorithms/slateq; random slates ~= 14.1,"
              " myopic-greedy is capped by the clickbait knob, tuned "
              "SlateQ reaches ~18 within 8 iterations"),
    "spread-maddpg": TunedExample(
        "spread-maddpg", _spread_maddpg, stop_reward=-45.0, max_iters=14,
        notes="reference: rllib/algorithms/maddpg; random joint policy "
              "~= -66/episode, tuned MADDPG passes -45 by iteration ~8"),
    "cartpole-alphazero": TunedExample(
        "cartpole-alphazero", _cartpole_alphazero, stop_reward=60.0,
        nightly_stop_reward=100.0, nightly_max_iters=80,
        max_iters=35,
        notes="reference: rllib/algorithms/alpha_zero (one-player MCTS "
              "+ ranked rewards on sparse terminal scores); random "
              "~= 20, the 100-episode reward window passes 60 around "
              "iteration 25"),
    "cartpole-ddppo": TunedExample(
        "cartpole-ddppo", _cartpole_ddppo, stop_reward=60.0,
        nightly_stop_reward=150.0, nightly_max_iters=100,
        max_iters=30,
        notes="reference: rllib/algorithms/ddppo; no central learner - "
              "workers allreduce gradients per minibatch"),
    "pointgoal-dreamer": TunedExample(
        "pointgoal-dreamer", _pointgoal_dreamer, stop_reward=-45.0,
        max_iters=22,
        notes="reference: rllib/algorithms/dreamer (RSSM + latent "
              "imagination); random ~= -60/episode, passes -45 within "
              "~16 iterations"),
    "atari-ppo": TunedExample(
        "atari-ppo", _atari_ppo, stop_reward=0.0, max_iters=30,
        notes="reference: tuned_examples/ppo/atari-ppo.yaml; synthetic "
              "Catch: random ~= -1.6/drop-pair, threshold 0 requires "
              "pixel-driven paddle control"),
}


def run_tuned_example(name: str, *, max_iters: Optional[int] = None,
                      tier: str = "ci", device: Any = None
                      ) -> Dict[str, Any]:
    """Train until the tuned stop_reward or the iteration budget; returns
    {passed, iterations, first_reward, best_reward, last_reward,
    env_steps_per_sec}. tier="nightly" gates at the REFERENCE-grade
    nightly_stop_reward (with its larger budget) when the example
    declares one."""
    import time

    ex = TUNED_EXAMPLES[name]
    stop_reward = ex.stop_reward
    budget = max_iters if max_iters is not None else ex.max_iters
    if tier == "nightly" and ex.nightly_stop_reward is not None:
        stop_reward = ex.nightly_stop_reward
        if max_iters is None:
            budget = ex.nightly_max_iters or ex.max_iters * 4
    algo = ex.build_config().resources(device=device).build()
    first = best = last = float("-inf")
    iters = 0
    steps0 = 0
    t0 = time.perf_counter()
    try:
        for i in range(budget):
            res = algo.train()
            iters = i + 1
            last = res.get("episode_reward_mean", float("nan"))
            if iters == 1:
                first = last
            if last == last and last > best:  # skip NaN (no episodes yet)
                best = last
            steps0 = res.get("timesteps_total", steps0)
            if best >= stop_reward:
                break
        dt = time.perf_counter() - t0
    finally:
        algo.stop()
    return {
        "name": name,
        "passed": best >= stop_reward,
        "tier": tier,
        "stop_reward": stop_reward,
        "iterations": iters,
        "first_reward": first,
        "best_reward": best,
        "last_reward": last,
        "env_steps_per_sec": round(steps0 / dt, 1) if dt > 0 else 0.0,
    }
