"""The port's Rainbow against the JAX package's, and
``tests/test_rllib_rainbow.py``'s cases on the port.

Held to the JAX package from the same inputs (numpy seeds) and the noise
the JAX code draws from its key, drawn here from that key as it splits
it: the noisy layer, the C51 projection (a terminal row, atoms landing on
a bin edge, atoms of one row sharing a bin), the distributional policy's
log-probabilities, the Rainbow loss and its gradients with noisy heads on
and off, and several updates of the learner (prioritized 3-step rows,
their priorities and the target sync) from the carried-over learner
state. Checkpoints written by either package restore in the other. The
learners run on the CPU (``.resources(device="cpu")``).
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rllib_pair import (LOSS_TOL, assert_state, bare, carry,
                               grads_close, one_torch_thread, port_cluster,
                               transitions)
from ray_tpu.rllib import RainbowConfig as JRainbowConfig
from ray_tpu.rllib import SampleBatch as JSampleBatch
from ray_tpu.rllib.algorithms import rainbow as jrainbow
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu.rllib.policy import rainbow_policy as jrp
from ray_tpu_torch.rllib import RainbowConfig, SampleBatch
from ray_tpu_torch.rllib.algorithms import rainbow
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy import rainbow_policy as rp
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor

HIDDENS = [32, 32]
SPACES = (gym.spaces.Box(-np.inf, np.inf, (4,), np.float32),
          gym.spaces.Discrete(2))
COLUMNS = ("obs", "new_obs", "actions", "rewards", "terminateds", "weights",
           "n_step_discount")


def _t(a):
    return torch.from_numpy(np.array(a))


def _head_noise(key, batch, in_dim, out_dim):
    """``noisy_apply``'s noise under ``key``, as the JAX layer draws it."""
    k_in, k_out = jax.random.split(key)
    return (rp.factorized(_t(jax.random.normal(k_in, (batch, in_dim)))),
            rp.factorized(_t(jax.random.normal(k_out, (batch, out_dim)))))


def _policy_noise(pol, key, batch):
    """``RainbowPolicy.logits_dist``'s noise under ``key``: split into
    the advantage head's and the value head's."""
    k_adv, k_val = jax.random.split(key)
    noise = {"adv": _head_noise(k_adv, batch, pol.feat_dim,
                                pol.act_dim * pol.num_atoms)}
    if pol.dueling:
        noise["val"] = _head_noise(k_val, batch, pol.feat_dim,
                                   pol.num_atoms)
    return noise


def _loss_noise(pol, key, batch):
    """The Rainbow loss's noise under ``key`` (the online pass only)."""
    return _policy_noise(pol, jax.random.split(key, 1)[0], batch)


def _configs(noisy, **kw):
    kw = dict(noisy=noisy, lr=1e-3, model={"fcnet_hiddens": HIDDENS},
              num_atoms=21, v_min=-5.0, v_max=5.0, **kw)
    return (JRainbowConfig().training(**kw).debugging(seed=2),
            RainbowConfig().training(**kw).debugging(seed=2))


# -- the layers ------------------------------------------------------------

def test_noisy_apply_matches_jax():
    """The mu-only and the noisy pass, each row under its own noise."""
    params = jrp.noisy_init(jax.random.PRNGKey(3), 12, 7)
    x = np.random.default_rng(0).normal(size=(9, 12)).astype(np.float32)
    mine = {k: _t(v) for k, v in params.items()}
    key = jax.random.PRNGKey(4)
    for k, noise in ((None, None), (key, _head_noise(key, 9, 12, 7))):
        want = np.asarray(jrp.noisy_apply(params, jnp.asarray(x), k))
        got = rp.noisy_apply(mine, _t(x), noise).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_project_distribution_matches_jax():
    """Random rows, a terminal row, rows whose atoms land exactly on bins
    (lo == hi: the whole mass once) and rows whose atoms clip onto the
    same edge bin (their masses add)."""
    rng = np.random.default_rng(1)
    support = np.linspace(0.0, 10.0, 11).astype(np.float32)
    logits = rng.normal(size=(6, 11)).astype(np.float32)
    log_p = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    rewards = np.float32([0.7, 3.4, 1.0, 0.0, 9.5, -3.0])
    disc = np.float32([0.9, 0.99, 1.0, 1.0, 0.95, 0.5])
    dones = np.float32([0, 1, 0, 0, 0, 0])
    want = np.asarray(jrp.project_distribution(
        jnp.asarray(log_p), jnp.asarray(rewards), jnp.asarray(disc),
        jnp.asarray(dones), jnp.asarray(support), 0.0, 10.0))
    got = rp.project_distribution(_t(log_p), _t(rewards), _t(disc),
                                  _t(dones), _t(support), 0.0, 10.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    # Row 2 (r=1, gamma=1) shifts every atom onto the next bin; the top
    # two atoms share bin 10.
    np.testing.assert_allclose(got[2, 10].item(),
                               np.exp(log_p[2, 9:]).sum(), rtol=1e-6)


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "plain"])
def test_logits_dist_matches_jax(noisy):
    jcfg, cfg = _configs(noisy)
    jpol = jmake_policy(jcfg.policy_config(), *SPACES, seed=2)
    pol = make_policy(cfg.policy_config(), *SPACES, seed=2, device="cpu")
    pol.set_weights(jpol.get_weights())
    obs = np.random.default_rng(2).normal(size=(8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jpol.logits_dist(jpol.params, jnp.asarray(obs), key))
    got = pol.logits_dist(pol.params, _t(obs), _policy_noise(pol, key, 8))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


# -- the loss and the learner ---------------------------------------------

def _minibatch(n, seed):
    rng = np.random.default_rng(seed)
    mb = dict(transitions(n, "cartpole", seed))
    mb["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    mb["n_step_discount"] = rng.choice([0.99, 0.98, 0.97], n).astype(
        np.float32)
    # Rewards on the support's scale, so atoms clip at both ends.
    mb["rewards"] = (mb["rewards"] * 3.0).astype(np.float32)
    return mb


@pytest.mark.parametrize("double_q", [True, False], ids=["double", "single"])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "plain"])
def test_rainbow_loss_and_gradients_match_jax(noisy, double_q):
    """The C51 cross-entropy, its per-row values (the priorities) and its
    gradients, with PER weights and n-step discounts, from the same
    parameters and target and the noise of one key."""
    jcfg, cfg = _configs(noisy, double_q=double_q)
    jpol = jmake_policy(jcfg.policy_config(), *SPACES, seed=2)
    pol = make_policy(cfg.policy_config(), *SPACES, seed=2, device="cpu")
    pol.set_weights(jpol.get_weights())
    rng = np.random.default_rng(4)
    target = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a)).astype(
            np.float32), jpol.params)
    mb = _minibatch(64, 5)
    key = jax.random.PRNGKey(9)
    jloss = jrainbow.Rainbow._build_loss_fn(None, jpol, jcfg)
    (want, want_ce), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jpol.params, jax.tree.map(jnp.asarray, target),
        {k: jnp.asarray(v) for k, v in mb.items() if k in COLUMNS}, key)
    loss_fn = rainbow.make_rainbow_loss(pol, cfg.gamma, cfg.double_q)
    got, got_ce = loss_fn(pol.params, jax.tree.map(_t, target),
                          {k: as_tensor(v, "cpu") for k, v in mb.items()
                           if k in COLUMNS},
                          _loss_noise(pol, key, 64) if noisy else None)
    # The sigmas take no gradient without noise (JAX's are zeros).
    got_g = torch.autograd.grad(got, jax.tree_util.tree_leaves(pol.params),
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(got_ce.detach().numpy(), np.asarray(want_ce),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    grads_close(got_g, want_g)


def _jax_update(jalgo, mb, key):
    """The body of the JAX DQN loop (``DQN.training_step``) for one
    minibatch and step key: the update, its priorities, the target
    sync."""
    device_mb = {k: jnp.asarray(v) for k, v in mb.items() if k in COLUMNS}
    pol = jalgo.local_policy
    pol.params, jalgo._opt_state, loss, td = jalgo._update_jit(
        pol.params, jalgo._target_params, jalgo._opt_state, device_mb, key)
    jalgo._grad_steps += 1
    jalgo._buffer.update_priorities(mb["batch_indexes"], np.asarray(td))
    if jalgo._grad_steps % jalgo.config.target_network_update_freq == 0:
        jalgo._target_params = jalgo._soft_sync_jit(pol.params,
                                                    jalgo._target_params)
    return float(loss), np.asarray(td)


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "plain"])
def test_rainbow_updates_match_jax(noisy):
    """Six updates of both learners from the carried-over state on the
    same prioritized 3-step minibatches (the same rows sampled from both
    packages' buffers), the JAX keys' noise handed to the port: the
    losses, priorities and the whole learner state after each (a soft
    target sync every 2 steps)."""
    jcfg, cfg = _configs(noisy, train_batch_size=48, n_step=3,
                         target_network_update_freq=2, tau=0.5)
    jpol = jmake_policy(jcfg.policy_config(), *SPACES, seed=jcfg.seed)
    pol = make_policy(cfg.policy_config(), *SPACES, seed=cfg.seed,
                      device="cpu")
    jalgo = bare(jrainbow.Rainbow, jcfg, jpol)
    algo = bare(rainbow.Rainbow, cfg, pol)
    carry(jalgo, algo)
    rows = transitions(400, "cartpole", 8)
    rows["rewards"] = (rows["rewards"] * 3.0).astype(np.float32)
    jalgo._buffer.add(JSampleBatch(dict(rows)))
    algo._buffer.add(SampleBatch(dict(rows)))
    key = jax.random.PRNGKey(12)
    for _ in range(6):
        mb = algo._buffer.sample(48, beta=0.4)
        jmb = jalgo._buffer.sample(48, beta=0.4)
        for k in jmb:  # the IS weights from priorities within 1e-4
            np.testing.assert_allclose(mb[k], jmb[k], rtol=1e-5, err_msg=k)
        key, k_step = jax.random.split(key)
        want, want_td = _jax_update(jalgo, jmb, k_step)
        got, got_td = algo.learn_on_batch(
            mb, _loss_noise(pol, k_step, 48) if noisy else None)
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
        np.testing.assert_allclose(got_td, want_td, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(algo._buffer._priorities,
                                   jalgo._buffer._priorities, rtol=1e-4,
                                   atol=1e-6)
        assert_state(algo, jalgo)
    assert algo._grad_steps == jalgo._grad_steps == 6


def test_rainbow_draws_its_own_noise():
    """Without noise the learner draws it from its generator (noisy), or
    takes none (plain)."""
    for noisy in (True, False):
        _, cfg = _configs(noisy)
        algo = bare(rainbow.Rainbow, cfg, make_policy(
            cfg.policy_config(), *SPACES, seed=2, device="cpu"))
        noise = algo.draw_noise(5)
        if noisy:
            assert set(noise) == {"adv", "val"}
            assert noise["adv"][0].shape == (5, HIDDENS[-1])
            assert noise["adv"][1].shape == (5, 2 * 21)
        else:
            assert noise is None
        algo._buffer.add(SampleBatch(dict(transitions(64, "cartpole", 1))))
        loss, td = algo.learn_on_batch(algo._buffer.sample(16, beta=0.4))
        assert np.isfinite(loss) and td.shape == (16,)


# -- tests/test_rllib_rainbow.py on the port ----------------------------------

def test_noisy_layer_statistics():
    params = rp.noisy_init(torch.Generator().manual_seed(0), 16, 8)
    x = torch.ones((32, 16))
    # noise=None: deterministic mu-only pass.
    mu_out = rp.noisy_apply(params, x, None).detach()
    assert torch.allclose(mu_out, rp.noisy_apply(params, x, None))
    # Noise is zero-mean: averaging many draws approaches the mu pass.
    gen = torch.Generator().manual_seed(1)
    draws = [rp.noisy_apply(params, x, tuple(
        rp.factorized(torch.randn((32, n), generator=gen)) for n in (16, 8))
    ).detach().numpy() for _ in range(300)]
    np.testing.assert_allclose(np.mean(draws, axis=0), mu_out.numpy(),
                               atol=0.1)
    # Per-row noise: rows of one draw differ (independent samples).
    assert not np.allclose(draws[0][0], draws[0][1])


def test_c51_projection_identity_and_terminal():
    support = torch.linspace(0.0, 10.0, 11)
    uniform = torch.log(torch.full((1, 11), 1 / 11.0))
    # Terminal: all mass at the (possibly fractional) reward position.
    t = rp.project_distribution(uniform, torch.tensor([3.4]), 0.99,
                                torch.tensor([1.0]), support, 0.0, 10.0)
    np.testing.assert_allclose(t[0, 3:5].numpy(), [0.6, 0.4], atol=1e-5)
    assert float(t.sum()) == pytest.approx(1.0, abs=1e-5)
    # r=0, gamma=1, non-terminal: projection is the identity.
    t = rp.project_distribution(uniform, torch.tensor([0.0]), 1.0,
                                torch.tensor([0.0]), support, 0.0, 10.0)
    np.testing.assert_allclose(t[0].numpy(), 1 / 11.0, atol=1e-5)


def test_rainbow_policy_shapes():
    pol = rp.RainbowPolicy(gym.spaces.Box(-1, 1, (4,), np.float32),
                           gym.spaces.Discrete(3),
                           {"num_atoms": 21, "v_min": 0.0, "v_max": 50.0,
                            "noisy": True, "dueling": True,
                            "fcnet_hiddens": (32,)}, seed=0, device="cpu")
    obs = np.zeros((5, 4), np.float32)
    gen = pol.make_generator(1)
    log_p = pol.logits_dist(pol.params, _t(obs), pol.draw_noise(gen, 5))
    assert log_p.shape == (5, 3, 21)
    # log-probs normalize per action
    np.testing.assert_allclose(torch.exp(log_p).sum(-1).detach().numpy(),
                               1.0, atol=1e-5)
    a, logp, v = pol.compute_actions(obs, pol.make_generator(2))
    assert a.shape == (5,) and set(a) <= {0, 1, 2}
    # weights round-trip
    w = pol.get_weights()
    pol.set_weights(w)
    assert float(pol.q_values(pol.params, _t(obs), None).max().detach()
                 ) <= 50.0


def test_rainbow_cartpole_learns(port_cluster):
    """The tuned Rainbow regression: C51 + double + dueling + PER +
    3-step must reach the tuned stop_reward (epsilon-greedy exploration;
    see tuned_examples for why noisy is off at this scale)."""
    from ray_tpu_torch.rllib.tuned_examples import run_tuned_example
    out = run_tuned_example("cartpole-rainbow", device="cpu")
    assert out["passed"], out


# -- across the packages ---------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_the_packages(ray_start_regular,
                                                 port_cluster, tmp_path,
                                                 writer):
    """A Rainbow ``algorithm_state.pkl`` trained and saved by one package
    restores in the other: the same weights, iteration and greedy
    actions."""
    kw = dict(train_batch_size=32,
              num_steps_sampled_before_learning_starts=100,
              num_train_batches_per_iteration=4, num_atoms=21,
              model={"fcnet_hiddens": HIDDENS})
    jcfg = (JRainbowConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=128)
            .training(**kw).debugging(seed=4))
    cfg = (RainbowConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=1, rollout_fragment_length=128)
           .training(**kw).resources(device="cpu").debugging(seed=4))
    src, dst = (jcfg, cfg) if writer == "jax" else (cfg, jcfg)
    saved = src.build()
    for _ in range(2):
        saved.train()
    path = saved.save(str(tmp_path))
    restored = dst.build()
    restored.restore(path)
    assert restored.iteration == saved.iteration == 2
    for a, b in zip(jax.tree_util.tree_leaves(saved.get_weights()["params"]),
                    jax.tree_util.tree_leaves(
                        restored.get_weights()["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    obs = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    assert [restored.compute_single_action(o) for o in obs] == \
        [saved.compute_single_action(o) for o in obs]
    saved.stop()
    restored.stop()
