"""The port's PPO (``ray_tpu_torch.rllib``) against the JAX package's.

From the same parameters (the JAX policy's init carried over as its numpy
tree) and the same batch: ``make_ppo_loss``'s value and gradients,
``_sgd`` on both of its schedules (one update per minibatch, and the fused
schedule of one permutation per epoch), and ``compute_gae`` bit for bit.
Then the JAX package's PPO tests on the port (``tests/test_rllib.py``'s
CartPole bar, the learner group's gradient parity, ``num_learners``, the
evaluation interval), a checkpoint written by either package restored in
the other with the same greedy actions, ``tests/test_rllib_multiagent.py``'s
5 cases, and the ported multi-agent example. The learner runs on the CPU
(``.resources(device="cpu")``); rollouts and episodes are not compared
value for value (JAX's keys and torch's generators differ), learning is
held to the reference's own bars.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib import PPOConfig as JPPOConfig
from ray_tpu.rllib import SampleBatch as JSampleBatch
from ray_tpu.rllib import compute_gae as jcompute_gae
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu_torch.rllib import (MultiAgentBatch, MultiAgentEnv, PPOConfig,
                                 SampleBatch, compute_gae)
from ray_tpu_torch.rllib.algorithms import ppo
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor

# The loss and its gradients from the same parameters: fp32 summation order.
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# The weights after a whole _sgd schedule (3 epochs: 15 Adam steps per
# minibatch, 12 fused): each step's gradients agree to GRAD_RTOL and Adam
# divides by |g|, so the differences grow with the steps.
SGD_ATOL = 1e-5


def _spaces(discrete=True):
    obs = gym.spaces.Box(-1, 1, (4,), np.float32)
    act = (gym.spaces.Discrete(2) if discrete
           else gym.spaces.Box(-1, 1, (2,), np.float32))
    return obs, act


def _policies(discrete=True, seed=0):
    """The JAX policy and the port's, with the JAX policy's parameters."""
    config = {"fcnet_hiddens": (32, 32)}
    jpol = jmake_policy(config, *_spaces(discrete), seed=seed)
    pol = make_policy(config, *_spaces(discrete), seed=seed, device="cpu")
    pol.set_weights(jpol.get_weights())
    return jpol, pol


def _minibatch(n=96, seed=0, discrete=True):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": (rng.integers(0, 2, n) if discrete
                        else rng.normal(size=(n, 2)).astype(np.float32)),
            "old_logp": rng.normal(-0.7, 0.1, n).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": rng.normal(size=n).astype(np.float32)}


def _rollout_batch(n=300, seed=1, discrete=True):
    """A GAE-complete batch of the columns ``_sgd`` reads."""
    mb = _minibatch(n, seed, discrete)
    return {SampleBatch.OBS: mb["obs"], SampleBatch.ACTIONS: mb["actions"],
            SampleBatch.ACTION_LOGP: mb["old_logp"],
            SampleBatch.ADVANTAGES: mb["advantages"] * 3 + 1,
            SampleBatch.VALUE_TARGETS: mb["value_targets"]}


def _assert_trees(got, want, rtol, atol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The learner's small products on one thread: with torch's default
    pool of a thread per core, the other test processes on the host make
    each update wait at the pool's barriers (one PPO iteration 8 s
    instead of 0.5 s). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_cluster():
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


# -- the learner's functions held to JAX's --------------------------------

@pytest.mark.parametrize("discrete", [True, False],
                         ids=["discrete", "box"])
def test_ppo_loss_and_gradients_match_jax(discrete):
    jpol, pol = _policies(discrete, seed=3)
    mb = _minibatch(discrete=discrete)
    jloss = jppo.make_ppo_loss(jpol, 0.2, 0.5, 0.01)
    (want, want_m), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jpol.params, {k: jnp.asarray(v) for k, v in mb.items()})
    loss_fn = ppo.make_ppo_loss(pol, 0.2, 0.5, 0.01)
    got, got_m = loss_fn(pol.params, {k: as_tensor(v, "cpu")
                                      for k, v in mb.items()})
    leaves = jax.tree_util.tree_leaves(pol.params)
    got_g = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    for g, w in zip(got_g, jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


class _Iteration:
    """What ``_sgd`` reads of its algorithm: the iteration (the fused
    schedule's seed)."""
    iteration = 3


@pytest.mark.parametrize("backend", [None, "cpu"],
                         ids=["per_minibatch", "fused"])
def test_sgd_matches_jax_on_both_schedules(backend):
    """A whole ``_sgd`` from the same parameters and batch (300 rows,
    minibatches of 64, 3 epochs): the last minibatch's metrics and the
    weights after it."""
    jpol, pol = _policies(seed=5)
    batch = _rollout_batch()
    jcfg = JPPOConfig().training(lr=1e-3, num_sgd_iter=3,
                                 sgd_minibatch_size=64,
                                 learner_backend=backend)
    cfg = PPOConfig().training(lr=1e-3, num_sgd_iter=3,
                               sgd_minibatch_size=64,
                               learner_backend=backend)
    jupdate, jstate = jppo.PPO._build_update(None, jpol, jcfg)
    _, want = jppo.PPO._sgd(_Iteration(), jpol, jupdate, jstate,
                            JSampleBatch(dict(batch)), jcfg)
    update, state = ppo.PPO._build_update(None, pol, cfg)
    _, got = ppo.PPO._sgd(_Iteration(), pol, update, state,
                          SampleBatch(dict(batch)), cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    _assert_trees(pol.get_weights(), jpol.get_weights(), 1e-4, SGD_ATOL)


def test_compute_gae_is_bit_equal():
    rng = np.random.default_rng(2)
    n = 50
    cols = {SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
            SampleBatch.VF_PREDS: rng.normal(size=n).astype(np.float32),
            SampleBatch.TERMINATEDS: (rng.random(n) < 0.1).astype(
                np.float32)}
    want = jcompute_gae(JSampleBatch(dict(cols)), 0.97, 0.9, 0.3)
    got = compute_gae(SampleBatch(dict(cols)), 0.97, 0.9, 0.3)
    for k in (SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_compute_gae_terminal():
    batch = SampleBatch({
        SampleBatch.REWARDS: [1.0, 1.0, 1.0],
        SampleBatch.VF_PREDS: [0.0, 0.0, 0.0],
        SampleBatch.TERMINATEDS: [0.0, 0.0, 1.0],
    })
    out = compute_gae(batch, gamma=1.0, lam=1.0)
    # With V=0 everywhere, advantages = reward-to-go.
    np.testing.assert_allclose(out[SampleBatch.ADVANTAGES], [3, 2, 1])
    np.testing.assert_allclose(out[SampleBatch.VALUE_TARGETS], [3, 2, 1])


# -- tests/test_rllib.py's PPO cases on the port ---------------------------

def test_ppo_cartpole_learns(port_cluster, tmp_path):
    config = (PPOConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2)
              .training(lr=1e-3, train_batch_size=1024,
                        num_sgd_iter=10, sgd_minibatch_size=256)
              .resources(device="cpu")
              .debugging(seed=7))
    algo = config.build()
    assert all(t.device.type == "cpu" for t in
               jax.tree_util.tree_leaves(algo.local_policy.params))
    results = []
    for _ in range(15):
        results.append(algo.train())
    first = results[0]["episode_reward_mean"]  # after one update
    last = results[-1]["episode_reward_mean"]
    assert np.isfinite(last)
    # CartPole random policy ~ 12-20 (and the mean is a lagging 100-episode
    # window); require a clear 2.5x improvement.
    assert last > 45 and last > 2.5 * first, (
        f"no learning: first={first:.1f} last={last:.1f}")
    assert results[-1]["timesteps_total"] >= 15 * 1024
    # checkpoint round trip
    path = algo.save(str(tmp_path))
    w_before = algo.compute_single_action(np.zeros(4, np.float32))
    algo2 = (PPOConfig().environment("CartPole-v1")
             .rollouts(num_rollout_workers=1).resources(device="cpu")
             .build())
    algo2.restore(path)
    assert algo2.iteration == algo.iteration
    assert algo2.compute_single_action(
        np.zeros(4, np.float32)) == w_before
    algo.stop()
    algo2.stop()


def test_ppo_learner_group_gradient_parity(port_cluster):
    """The learner group's row-weighted gradient average IS the
    full-minibatch gradient."""
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
            .training(lr=1e-3, train_batch_size=128)
            .resources(device="cpu")
            .debugging(seed=11).build())
    pol = algo.local_policy
    loss_fn = ppo.make_ppo_loss(pol, 0.2, 0.5, 0.0)
    rng = np.random.default_rng(0)
    mb = {"obs": rng.normal(size=(64, 4)).astype(np.float32),
          "actions": rng.integers(0, 2, 64),
          "old_logp": (-0.7 * np.ones(64)).astype(np.float32),
          "advantages": rng.normal(size=64).astype(np.float32),
          "value_targets": rng.normal(size=64).astype(np.float32)}
    leaves = jax.tree_util.tree_leaves(pol.params)

    def grads(m):
        loss, _ = loss_fn(pol.params, {k: as_tensor(v, "cpu")
                                       for k, v in m.items()})
        return [g.numpy() for g in torch.autograd.grad(loss, leaves)]

    g_full = grads(mb)
    # Uneven shards (40/24): the row-weighted average must still equal
    # the full-batch gradient.
    gs = [grads({k: v[:40] for k, v in mb.items()}),
          grads({k: v[40:] for k, v in mb.items()})]
    for a, b, c in zip(g_full, *gs):
        np.testing.assert_allclose(a, 40 / 64 * b + 24 / 64 * c,
                                   atol=1e-6, rtol=1e-4)
    algo.stop()


def test_ppo_num_learners_trains(port_cluster):
    """num_learners=2 end-to-end: the group run tracks the solo run
    within Adam's float-amplification envelope and actually trains."""

    def build(num_learners):
        return (PPOConfig()
                .environment("CartPole-v1")
                .rollouts(num_rollout_workers=1,
                          rollout_fragment_length=64)
                .training(lr=1e-3, train_batch_size=128,
                          num_sgd_iter=2, sgd_minibatch_size=64,
                          num_learners=num_learners)
                .resources(device="cpu")
                .debugging(seed=11)
                .build())

    solo = build(0)
    group = build(2)
    for a, b in zip(jax.tree_util.tree_leaves(solo.get_weights()),
                    jax.tree_util.tree_leaves(group.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-6)  # same init
    r_solo = solo.train()
    r_group = group.train()
    assert np.isfinite(r_solo["total_loss"])
    assert np.isfinite(r_group["total_loss"])
    # Same batch, same minibatch schedule: weights stay within a few
    # Adam steps' float-amplification envelope of the solo run.
    lr = 1e-3
    for a, b in zip(jax.tree_util.tree_leaves(solo.get_weights()),
                    jax.tree_util.tree_leaves(group.get_weights())):
        drift = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        assert drift < 8 * lr, f"group diverged from solo: {drift}"
    solo.stop()
    group.stop()


def test_evaluation_interval(port_cluster):
    config = (PPOConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=1)
              .training(train_batch_size=256)
              .evaluation(evaluation_interval=1, evaluation_duration=2)
              .resources(device="cpu")
              .debugging(seed=9))
    algo = config.build()
    res = algo.train()
    assert "evaluation" in res
    assert np.isfinite(res["evaluation"]["episode_reward_mean"])
    assert res["evaluation"]["episodes_this_eval"] == 2
    algo.stop()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_the_packages(ray_start_regular,
                                                 port_cluster, tmp_path,
                                                 writer):
    """An ``algorithm_state.pkl`` trained and saved by one package
    restores in the other: the same weights, iteration and greedy
    actions."""
    def jax_algo():
        return (JPPOConfig().environment("CartPole-v1")
                .rollouts(num_rollout_workers=1)
                .training(train_batch_size=256).debugging(seed=4).build())

    def port_algo():
        return (PPOConfig().environment("CartPole-v1")
                .rollouts(num_rollout_workers=1)
                .training(train_batch_size=256).resources(device="cpu")
                .debugging(seed=4).build())

    src, dst = ((jax_algo(), port_algo()) if writer == "jax"
                else (port_algo(), jax_algo()))
    src.train()
    path = src.save(str(tmp_path / writer))
    dst.restore(path)
    assert dst.iteration == src.iteration == 1
    _assert_trees(dst.get_weights(), src.get_weights(), 0, 0)
    obs = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    assert [dst.compute_single_action(o) for o in obs] == \
        [src.compute_single_action(o) for o in obs]
    src.stop()
    dst.stop()


# -- tests/test_rllib_multiagent.py's cases on the port ---------------------

class OpposingBandits(MultiAgentEnv):
    """Two agents, opposite optima: a0 is rewarded for action 1, a1 for
    action 0 — separate policies MUST diverge to solve it."""

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
        terminateds = {"a0": done, "a1": done, "__all__": done}
        truncateds = {"a0": False, "a1": False, "__all__": False}
        return self._obs(), rewards, terminateds, truncateds, {}


def test_multi_agent_batch_container():
    b = MultiAgentBatch(
        {"p0": SampleBatch({"obs": np.zeros((4, 2))}),
         "p1": SampleBatch({"obs": np.zeros((6, 2))})}, env_steps=5)
    assert b.env_steps() == 5
    assert b.agent_steps() == 10
    cat = MultiAgentBatch.concat_samples([b, b])
    assert cat.env_steps() == 10
    assert len(cat.policy_batches["p1"]) == 12


def test_multi_agent_rollout_worker_batches(port_cluster):
    from ray_tpu_torch.rllib.evaluation.multi_agent_worker import (
        MultiAgentRolloutWorker)
    config = (PPOConfig()
              .environment(lambda cfg: OpposingBandits())
              .multi_agent(policies={"p0": None, "p1": None},
                           policy_mapping_fn=lambda aid: "p" + aid[1]))
    worker = MultiAgentRolloutWorker(config.env_creator(),
                                     config.policy_config(), seed=1)
    batch = worker.sample(25)
    assert isinstance(batch, MultiAgentBatch)
    assert batch.env_steps() == 25
    # both agents act every joint step
    assert len(batch.policy_batches["p0"]) == 25
    assert len(batch.policy_batches["p1"]) == 25
    for sb in batch.policy_batches.values():
        # GAE postprocessing completed for every fragment
        assert SampleBatch.ADVANTAGES in sb
        assert SampleBatch.VALUE_TARGETS in sb
    stats = worker.episode_stats()
    assert stats["episodes"] == 2  # 25 steps / 10-step episodes
    assert np.isfinite(stats["episode_reward_mean"])


def test_multi_agent_ppo_learns_opposing_policies(port_cluster, tmp_path):
    config = (PPOConfig()
              .environment(lambda cfg: OpposingBandits())
              .rollouts(num_rollout_workers=2)
              .multi_agent(policies={"p0": None, "p1": None},
                           policy_mapping_fn=lambda aid: "p" + aid[1])
              .training(lr=5e-3, train_batch_size=400,
                        num_sgd_iter=6, sgd_minibatch_size=100)
              .resources(device="cpu")
              .debugging(seed=3))
    algo = config.build()
    for _ in range(10):
        res = algo.train()
    assert np.isfinite(res["p0/total_loss"])
    assert np.isfinite(res["p1/total_loss"])
    assert res["agent_steps_this_iter"] == 2 * res["timesteps_total"] / \
        res["training_iteration"]
    # the per-step joint reward approaches 2.0 (both agents optimal)
    assert res["episode_reward_mean"] > 16, res["episode_reward_mean"]
    # the policies DIVERGED: p0 greedy-picks 1, p1 greedy-picks 0
    obs = np.zeros(2, np.float32)
    assert algo.compute_single_action(obs, policy_id="p0") == 1
    assert algo.compute_single_action(obs, policy_id="p1") == 0
    # checkpoint round-trips the whole policy map
    path = algo.save(str(tmp_path))
    algo2 = (PPOConfig()
             .environment(lambda cfg: OpposingBandits())
             .rollouts(num_rollout_workers=1)
             .multi_agent(policies={"p0": None, "p1": None},
                          policy_mapping_fn=lambda aid: "p" + aid[1])
             .resources(device="cpu")
             ).build()
    algo2.restore(path)
    assert algo2.compute_single_action(obs, policy_id="p0") == 1
    assert algo2.compute_single_action(obs, policy_id="p1") == 0
    algo.stop()
    algo2.stop()


def test_multi_agent_shared_policy(port_cluster):
    """Both agents mapped onto ONE policy: its batch sees rows from both
    (parameter sharing)."""
    config = (PPOConfig()
              .environment(lambda cfg: OpposingBandits())
              .rollouts(num_rollout_workers=1)
              .multi_agent(policies={"shared": None},
                           policy_mapping_fn=lambda aid: "shared")
              .training(train_batch_size=100)
              .resources(device="cpu")
              .debugging(seed=5))
    algo = config.build()
    res = algo.train()
    assert "shared/total_loss" in res
    assert res["agent_steps_this_iter"] == 200  # 2 agents x 100 steps
    algo.stop()


def test_multi_agent_config_validation():
    with pytest.raises(ValueError, match="policy_mapping_fn"):
        (PPOConfig()
         .environment(lambda cfg: OpposingBandits())
         .multi_agent(policies={"p0": None})).policy_config()
    # mapping to an unknown policy fails loudly at worker construction
    from ray_tpu_torch.rllib.evaluation.multi_agent_worker import (
        resolve_policy_specs)
    env = OpposingBandits()
    with pytest.raises(ValueError, match="not in config.policies"):
        resolve_policy_specs({"p0": None}, lambda aid: "nope", env)
    with pytest.raises(ValueError, match="not reachable"):
        resolve_policy_specs({"p0": None, "unused": None},
                             lambda aid: "p0", env)


# -- the port's entry points and its example --------------------------------

def test_the_learner_defaults_to_the_card(monkeypatch):
    """Without a card, the default device raises rather than fall back to
    the CPU, for every policy class; asked for the CPU, each builds
    there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, discrete in (("actor_critic", True), ("q", True),
                           ("sac", False), ("td3", False), ("r2d2", True),
                           ("rainbow", True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_policy({"policy_class": name}, *_spaces(discrete))
        pol = make_policy({"policy_class": name}, *_spaces(discrete),
                          device="cpu")
        assert pol.device == torch.device("cpu")


def test_the_multi_agent_example(port_cluster):
    from ray_tpu_torch.examples import multi_agent_ppo
    res, greedy = multi_agent_ppo.main(["--cpu"])
    assert np.isfinite(res["p0/total_loss"])
    assert np.isfinite(res["p1/total_loss"])
    assert greedy == {"p0": 1, "p1": 0}
