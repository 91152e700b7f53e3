"""The port's R2D2 and QMIX against the JAX package's, and
``tests/test_rllib_r2d2_qmix.py``'s cases on the port.

Held to the JAX package from the same inputs (numpy seeds) and the
carried-over learner state: the LSTM cell, ``q_seq`` over a window and
its final state, the value rescaling and its inverse; R2D2's sequence
loss, TD errors and gradients with burn-in on stored states and without,
and several updates on the same windows sampled from both packages'
sequence buffers (a soft target sync every 2 steps); QMIX's agent
utilities and monotone mixer, and two whole ``training_step``s (the same
joint rollouts from the same seeds, the updates and the hard target sync)
with ``double_q`` on and off. Checkpoints written by either package
restore in the other. The learners run on the CPU
(``.resources(device="cpu")``).
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rllib_pair import (LOSS_TOL, assert_state, bare, carry, closure,
                               grads_close, one_torch_thread, port_cluster,
                               transitions)
from ray_tpu.rllib import QMixConfig as JQMixConfig
from ray_tpu.rllib import R2D2Config as JR2D2Config
from ray_tpu.rllib import SampleBatch as JSampleBatch
from ray_tpu.rllib.algorithms import qmix as jqmix
from ray_tpu.rllib.algorithms import r2d2 as jr2d2
from ray_tpu.rllib.env.examples import CoordinationGameEnv as JCoordination
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu.rllib.policy import r2d2_policy as jrp
from ray_tpu_torch.rllib import QMixConfig, R2D2Config, SampleBatch
from ray_tpu_torch.rllib.algorithms import qmix, r2d2
from ray_tpu_torch.rllib.env.examples import CoordinationGameEnv
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy import r2d2_policy as rp
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor

HIDDENS = [32, 32]
SPACES = (gym.spaces.Box(-np.inf, np.inf, (4,), np.float32),
          gym.spaces.Discrete(2))
SEQ_COLUMNS = ("obs", "actions", "rewards", "terminateds", "mask", "h0",
               "c0")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# -- R2D2 ------------------------------------------------------------------

def _r2d2_configs(burn_in, **kw):
    kw = dict(lr=1e-3, lstm_cell_size=16, model={"fcnet_hiddens": HIDDENS},
              burn_in=burn_in, seq_len=8, train_batch_size=12,
              target_network_update_freq=2, tau=0.5, **kw)
    return (JR2D2Config().training(**kw).debugging(seed=3),
            R2D2Config().training(**kw).debugging(seed=3))


def _policies(jcfg, cfg):
    jpol = jmake_policy(jcfg.policy_config(), *SPACES, seed=3)
    pol = make_policy(cfg.policy_config(), *SPACES, seed=3, device="cpu")
    pol.set_weights(jpol.get_weights())
    return jpol, pol


def test_lstm_step_q_seq_and_rescale_match_jax():
    """One cell step, a window through ``q_seq`` from a stored state (its
    Q values and final state), and the value rescaling both ways."""
    jpol, pol = _policies(*_r2d2_configs(4))
    rng = np.random.default_rng(0)
    h, c = (rng.normal(size=(5, 16)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(5, 32)).astype(np.float32)
    want = jrp.lstm_step(jpol.params["lstm"], jnp.asarray(h), jnp.asarray(c),
                         jnp.asarray(x))
    got = rp.lstm_step(pol.params["lstm"], _t(h), _t(c), _t(x))
    for g, w in zip(got, want):
        _close(g, w)
    obs = rng.normal(size=(5, 7, 4)).astype(np.float32)
    q, (hT, cT) = jpol.q_seq(jpol.params, jnp.asarray(obs), jnp.asarray(h),
                             jnp.asarray(c))
    gq, (ghT, gcT) = pol.q_seq(pol.params, _t(obs), _t(h), _t(c))
    assert gq.shape == (5, 7, 2)
    for g, w in ((gq, q), (ghT, hT), (gcT, cT)):
        _close(g, w)
    v = np.float32([-300.0, -50.0, -1.0, -1e-3, 0.0, 0.3, 7.0, 200.0])
    _close(rp.value_rescale(_t(v)), jrp.value_rescale(jnp.asarray(v)))
    _close(rp.value_rescale_inv(_t(v)), jrp.value_rescale_inv(
        jnp.asarray(v)), 1e-4)


def _episodes(seed, n=600):
    """Seeded CartPole-shaped rows with the stored pre-step LSTM state
    that rollout workers record."""
    rows = dict(transitions(n, "cartpole", seed))
    rng = np.random.default_rng(seed + 1)
    for k in ("lstm_h", "lstm_c"):
        rows[k] = rng.normal(0, 0.3, (n, 16)).astype(np.float32)
    return rows


@pytest.mark.parametrize("burn_in", [4, 0], ids=["burn-in", "no-burn-in"])
def test_r2d2_loss_and_updates_match_jax(burn_in):
    """The sequence loss, its TD errors and gradients on windows sampled
    bit-equal from both packages' sequence buffers (padded short
    episodes, terminal steps, stored start states); then five updates,
    the losses and the whole learner state after each. (The TD errors of
    later updates feed nothing, R2D2 has no priorities, and a near-tie of
    the double-Q argmax may pick the other action's target in one
    package: they are held at the first update only.)"""
    jcfg, cfg = _r2d2_configs(burn_in)
    jpol, pol = _policies(jcfg, cfg)
    jalgo = bare(jr2d2.R2D2, jcfg, jpol)
    algo = bare(r2d2.R2D2, cfg, pol)
    carry(jalgo, algo)
    rows = _episodes(5)
    jalgo._buffer.add(JSampleBatch(dict(rows)))
    algo._buffer.add(SampleBatch(dict(rows)))
    jloss = closure(jalgo._update_jit)["loss_fn"]
    for step in range(5):
        mb, jmb = algo._buffer.sample(12, 8), jalgo._buffer.sample(12, 8)
        assert set(mb) == set(jmb)
        for k in jmb:
            np.testing.assert_array_equal(mb[k], jmb[k], err_msg=k)
        device_mb = {k: jnp.asarray(v) for k, v in jmb.items()
                     if k in SEQ_COLUMNS}
        if step == 0:
            (want, want_td), want_g = jax.value_and_grad(
                jloss, has_aux=True)(jpol.params, jalgo._target_params,
                                     device_mb)
            got, got_td = algo._loss_fn(
                pol.params, algo._target_params,
                {k: as_tensor(v, "cpu") for k, v in mb.items()
                 if k in SEQ_COLUMNS})
            got_g = torch.autograd.grad(
                got, jax.tree_util.tree_leaves(pol.params))
            np.testing.assert_allclose(float(got.detach()), float(want),
                                       rtol=LOSS_TOL)
            _close(got_td, want_td)
            grads_close(got_g, want_g)
        jpol.params, jalgo._opt_state, want, want_td = jalgo._update_jit(
            jpol.params, jalgo._target_params, jalgo._opt_state, device_mb)
        jalgo._grad_steps += 1
        if jalgo._grad_steps % jcfg.target_network_update_freq == 0:
            jalgo._target_params = jalgo._soft_sync_jit(
                jpol.params, jalgo._target_params)
        got, got_td = algo.learn_on_batch(mb)
        np.testing.assert_allclose(got, float(want), rtol=LOSS_TOL)
        assert got_td.shape == np.shape(want_td)
        assert_state(algo, jalgo)
    assert algo._grad_steps == jalgo._grad_steps == 5


# -- QMIX ------------------------------------------------------------------

def _qmix_pair(double_q):
    kw = dict(lr=1e-3, double_q=double_q, mixing_embed_dim=8,
              model={"fcnet_hiddens": [16]}, rollout_steps_per_iteration=40,
              num_steps_sampled_before_learning_starts=32,
              train_batch_size=16, num_train_batches_per_iteration=5,
              target_network_update_freq=4, epsilon_timesteps=100)
    env_config = {"rounds": 5, "n_actions": 3}
    jcfg = (JQMixConfig().environment(JCoordination, env_config=env_config)
            .training(**kw).debugging(seed=6))
    cfg = (QMixConfig().environment(CoordinationGameEnv,
                                    env_config=env_config)
           .training(**kw).resources(device="cpu").debugging(seed=6))
    jalgo = bare(jqmix.QMix, jcfg, None,
                 _env_creator=lambda c: JCoordination(c))
    algo = bare(qmix.QMix, cfg, None,
                _env_creator=lambda c: CoordinationGameEnv(c))
    carry(jalgo, algo)
    return jalgo, algo


@pytest.mark.parametrize("double_q", [True, False],
                         ids=["double", "single"])
def test_qmix_mixer_and_training_steps_match_jax(double_q):
    """The agent utilities and the monotone mixer on seeded inputs; then
    two whole ``training_step``s of both packages from the same state:
    the same joint rollouts (the numpy generators of one seed, the same
    greedy actions), ten updates with a hard target sync every 4, the
    results and the learner state after each."""
    jalgo, algo = _qmix_pair(double_q)
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(6, 2, 2)).astype(np.float32)
    qs = rng.normal(size=(6, 2)).astype(np.float32)
    state = rng.normal(size=(6, 4)).astype(np.float32)
    fns = closure(jalgo._update_jit)
    jfns = closure(fns["loss_fn"])
    _close(algo.agent_qs(algo.params, _t(obs)),
           jfns["agent_qs"](jalgo.params, jnp.asarray(obs)))
    _close(algo.mix(algo.params, _t(qs), _t(state)),
           jfns["mix"](jalgo.params, jnp.asarray(qs), jnp.asarray(state)))
    for _ in range(2):
        want, got = jalgo.training_step(), algo.training_step()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
        assert_state(algo, jalgo)
    assert algo._grad_steps == jalgo._grad_steps == 10


# -- tests/test_rllib_r2d2_qmix.py on the port -----------------------------

def test_value_rescale_roundtrip():
    x = torch.tensor([-50.0, -1.0, 0.0, 0.3, 7.0, 200.0])
    np.testing.assert_allclose(rp.value_rescale_inv(rp.value_rescale(x)),
                               x.numpy(), rtol=1e-4, atol=1e-4)


def test_lstm_policy_state_semantics():
    pol = rp.R2D2Policy(gym.spaces.Box(-1, 1, (4,), np.float32),
                        gym.spaces.Discrete(2),
                        {"lstm_cell_size": 8, "fcnet_hiddens": (16,)},
                        seed=0, device="cpu")
    pol.epsilon = 0.0
    obs = np.ones((1, 4), np.float32)
    gen = pol.make_generator(0)
    pol.reset_state()
    pol.compute_actions(obs, gen)
    assert pol.state_rows["lstm_h"].shape == (8,)
    # Pre-step state of step 1 is zeros (fresh episode)...
    np.testing.assert_array_equal(pol.state_rows["lstm_h"], 0.0)
    pol.compute_actions(obs, gen)
    # ...and of step 2 is the (nonzero) post-step-1 state.
    assert np.abs(pol.state_rows["lstm_h"]).sum() > 0
    # q_seq from zeros over [obs, obs] ends in the same state as two
    # manual steps.
    h0 = torch.zeros((1, 8))
    c0 = torch.zeros((1, 8))
    with torch.no_grad():
        q, (h, c) = pol.q_seq(pol.params, _t(obs)[None], h0, c0)
    assert q.shape == (1, 1, 2)
    pol.reset_state()
    pol.compute_actions(obs, gen)
    np.testing.assert_allclose(h[0].numpy(), pol._h[0], atol=1e-5)


def test_sequence_buffer_windows_and_padding():
    from ray_tpu_torch.rllib.utils.replay_buffers import SequenceReplayBuffer
    buf = SequenceReplayBuffer(capacity_episodes=10, seed=0)
    # One 7-step episode and one 3-step episode.
    batch = SampleBatch({
        "obs": np.arange(10, dtype=np.float32).reshape(10, 1),
        "actions": np.zeros(10, np.int64),
        "rewards": np.ones(10, np.float32),
        "terminateds": np.float32([0, 0, 0, 0, 0, 0, 1, 0, 0, 1]),
        "eps_id": np.int64([1] * 7 + [2] * 3),
        "lstm_h": np.tile(np.arange(10, dtype=np.float32)[:, None],
                          (1, 4)),
        "lstm_c": np.zeros((10, 4), np.float32),
    })
    buf.add(batch)
    assert len(buf) == 10
    mb = buf.sample(8, seq_len=5)
    assert mb["obs"].shape == (8, 5, 1)
    assert mb["mask"].shape == (8, 5)
    assert mb["h0"].shape == (8, 4)
    for i in range(8):
        valid = int(mb["mask"][i].sum())
        assert valid >= 1
        # h0 equals the stored pre-step state of the first window step.
        first_obs = mb["obs"][i, 0, 0]
        np.testing.assert_array_equal(mb["h0"][i],
                                      np.full(4, first_obs))
        # Padding rows are zero.
        if valid < 5:
            assert mb["obs"][i, valid:].sum() == 0


def test_qmix_monotone_mixer_and_learning(port_cluster):
    """QMIX must solve the coordination game (team reward only): both
    agents matching the shared context. Uniform random ~= 1.1; the tuned
    gate is 8.0 of the optimal 10."""
    from ray_tpu_torch.rllib.tuned_examples import run_tuned_example
    out = run_tuned_example("coordination-qmix", device="cpu")
    assert out["passed"], out


def test_qmix_joint_action_greedy(port_cluster):
    algo = (QMixConfig()
            .environment(CoordinationGameEnv, env_config={"rounds": 4})
            .training(rounds_per_iteration=None)
            .resources(device="cpu")
            .debugging(seed=1)).build()
    obs, _ = CoordinationGameEnv({"rounds": 4}).reset(seed=0)
    joint = algo.compute_joint_action(obs)
    assert set(joint) == {"a0", "a1"}
    assert all(0 <= a < 3 for a in joint.values())
    algo.stop()


@pytest.mark.slow
def test_tuned_r2d2_learns(port_cluster):
    from ray_tpu_torch.rllib.tuned_examples import run_tuned_example
    out = run_tuned_example("cartpole-r2d2", device="cpu")
    assert out["passed"], out


def test_qmix_checkpoint_roundtrip(port_cluster):
    """save/restore must carry the LEARNED mixer/utility params (not the
    unused probe policy)."""
    cfg = (QMixConfig()
           .environment(CoordinationGameEnv, env_config={"rounds": 5})
           .training(rollout_steps_per_iteration=50,
                     num_train_batches_per_iteration=4,
                     num_steps_sampled_before_learning_starts=20)
           .resources(device="cpu")
           .debugging(seed=4))
    algo = cfg.build()
    algo.train()
    path = algo.save()
    obs, _ = CoordinationGameEnv({"rounds": 5}).reset(seed=1)
    joint = algo.compute_joint_action(obs)
    algo2 = cfg.build()
    algo2.restore(path)
    assert algo2.compute_joint_action(obs) == joint
    np.testing.assert_allclose(algo2.params["q"][0]["w"].detach().numpy(),
                               algo.params["q"][0]["w"].detach().numpy())
    algo.stop(); algo2.stop()


def test_r2d2_compute_single_action(port_cluster):
    algo = (R2D2Config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=1)
            .resources(device="cpu")
            .debugging(seed=1)).build()
    a = algo.compute_single_action(np.zeros(4, np.float32))
    assert a in (0, 1)
    algo.stop()


# -- across the packages ---------------------------------------------------

def _checkpoint_configs(name):
    if name == "r2d2":
        kw = dict(train_batch_size=8, lstm_cell_size=16,
                  num_steps_sampled_before_learning_starts=100,
                  num_train_batches_per_iteration=4,
                  model={"fcnet_hiddens": HIDDENS})
        return [c.environment("CartPole-v1").rollouts(
            num_rollout_workers=1, rollout_fragment_length=128).training(
                **kw).debugging(seed=4) for c in (JR2D2Config(),
                                                  R2D2Config())]
    kw = dict(rollout_steps_per_iteration=50,
              num_train_batches_per_iteration=4,
              num_steps_sampled_before_learning_starts=20)
    return [c.environment(env, env_config={"rounds": 5}).training(
        **kw).debugging(seed=4) for c, env in (
            (JQMixConfig(), JCoordination), (QMixConfig(),
                                             CoordinationGameEnv))]


def _greedy(algo, name):
    if name == "r2d2":  # stateful: the same sequence from the same state
        algo.local_policy.reset_state()
        obs = np.random.default_rng(0).normal(size=(6, 4)).astype(
            np.float32)
        return [algo.compute_single_action(o) for o in obs]
    return [algo.compute_joint_action(
        CoordinationGameEnv({"rounds": 5}).reset(seed=s)[0])
        for s in range(4)]


@pytest.mark.parametrize("name", ["r2d2", "qmix"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_the_packages(ray_start_regular,
                                                 port_cluster, tmp_path,
                                                 name, writer):
    """An R2D2 or QMIX ``algorithm_state.pkl`` trained and saved by one
    package restores in the other: the same weights, iteration and
    greedy (joint) actions."""
    jcfg, cfg = _checkpoint_configs(name)
    cfg.resources(device="cpu")
    src, dst = (jcfg, cfg) if writer == "jax" else (cfg, jcfg)
    saved = src.build()
    for _ in range(2):
        saved.train()
    path = saved.save(str(tmp_path))
    restored = dst.build()
    restored.restore(path)
    assert restored.iteration == saved.iteration == 2
    for a, b in zip(jax.tree_util.tree_leaves(saved.get_weights()),
                    jax.tree_util.tree_leaves(restored.get_weights())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert _greedy(restored, name) == _greedy(saved, name)
    saved.stop()
    restored.stop()
