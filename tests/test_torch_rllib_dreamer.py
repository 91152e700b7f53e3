"""The port's Dreamer against the JAX package's, and
``tests/test_rllib_dreamer.py``'s cases on the port.

Held to the JAX package from the carried-over learner state (the world
model, the actor and the critic, and their three Adam states) and the
normals the JAX update draws from its key, split as it splits them: the
lambda-returns, the world-model loss (reconstruction, reward, the KL held
at free nats) with its gradients, the actor's and the critic's losses
over the imagined rollouts with the actor's gradients, and two whole
updates. The learners run on the CPU (``.resources(device="cpu")``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rllib_pair import (GRAD_ATOL, GRAD_RTOL, LOSS_TOL, STEP_ATOL,
                               STEP_RTOL, assert_state, bare, carry, closure,
                               one_torch_thread, port_cluster)
from ray_tpu.rllib.algorithms import dreamer as jdreamer
from ray_tpu.rllib.env.examples import PointGoalEnv as JPointGoalEnv
from ray_tpu_torch.rllib import DreamerConfig
from ray_tpu_torch.rllib.algorithms import dreamer
from ray_tpu_torch.rllib.env.examples import PointGoalEnv
from ray_tpu_torch.rllib.policy.torch_policy import named_leaves

B, T = 4, 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair():
    kw = dict(deter_dim=16, stoch_dim=4, hidden_dim=16, seq_len=T,
              imagine_horizon=4, lr=3e-3, actor_lr=2e-3, critic_lr=2e-3,
              free_nats=0.5, prefill_steps=10,
              rollout_steps_per_iteration=10)
    jcfg = jdreamer.DreamerConfig().training(**kw).debugging(seed=2)
    cfg = DreamerConfig().training(**kw).resources(
        device="cpu").debugging(seed=2)
    jcfg.batch_size = cfg.batch_size = B
    jalgo = bare(jdreamer.Dreamer, jcfg, None,
                 _env_creator=lambda c: JPointGoalEnv(c))
    algo = bare(dreamer.Dreamer, cfg, None,
                _env_creator=lambda c: PointGoalEnv(c))
    carry(jalgo, algo)
    return jalgo, algo


def _sequences(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[0, 3:] = 0.0
    return {"obs": rng.normal(size=(B, T, 1)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (B, T, 1)).astype(np.float32),
            "rewards": rng.normal(size=(B, T)).astype(np.float32),
            "mask": mask}


def _observe_noise(key, z):
    out = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (B, z))))
    return _t(np.stack(out))


def _imagine_noise(key, horizon, n, a, z):
    act, lat = [], []
    for _ in range(horizon):
        key, ka, kz = jax.random.split(key, 3)
        act.append(np.asarray(jax.random.normal(ka, (n, a))))
        lat.append(np.asarray(jax.random.normal(kz, (n, z))))
    return {"act": _t(np.stack(act)), "z": _t(np.stack(lat))}


def _update_noise(key, algo):
    """The JAX update's normals from ``key``: split into the world
    model's, the actor's and the critic's keys."""
    k1, k2, k3 = jax.random.split(key, 3)
    cfg = algo.config
    n = B * T
    return {"observe": _observe_noise(k1, cfg.stoch_dim),
            "actor": _imagine_noise(k2, cfg.imagine_horizon, n, 1,
                                    cfg.stoch_dim),
            "critic": _imagine_noise(k3, cfg.imagine_horizon, n, 1,
                                     cfg.stoch_dim)}


def _grads_close(got, want):
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_lambda_returns_match_jax():
    """The port's loop over time against the JAX scan, both discounts."""
    jalgo, algo = _pair()
    scan = closure(closure(jalgo._update_jit)["behavior_losses"])[
        "lambda_returns"]
    rng = np.random.default_rng(0)
    rew = rng.standard_normal((3, 7)).astype(np.float32)
    val = rng.standard_normal((3, 7)).astype(np.float32)
    want = np.asarray(scan(jnp.asarray(rew), jnp.asarray(val)))
    got = dreamer.lambda_returns(_t(rew), _t(val), algo.config.gamma,
                                 algo.config.lambda_)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_world_model_loss_and_gradients_match_jax():
    """The world-model loss and its parts (the KL below free nats on one
    minibatch, above on the other) and its gradients, with the JAX key's
    posterior samples."""
    jalgo, algo = _pair()
    fns = closure(jalgo._update_jit)
    for seed, scale in ((1, 1.0), (2, 6.0)):
        mb = _sequences(seed)
        mb["obs"] *= scale
        key = jax.random.PRNGKey(seed)
        (want, (rl, rwl, kl, feats)), want_g = jax.value_and_grad(
            fns["wm_loss"], has_aux=True)(
                jalgo.params, {k: jnp.asarray(v) for k, v in mb.items()},
                key)
        got, parts = algo._wm_loss(algo.params,
                                   {k: _t(v) for k, v in mb.items()},
                                   _observe_noise(key, 4))
        grads = torch.autograd.grad(got, list(named_leaves(
            algo.params).values()))
        for g, w in ((got, want), (parts["recon_loss"], rl),
                     (parts["reward_loss"], rwl), (parts["kl"], kl)):
            np.testing.assert_allclose(float(g.detach()), float(w),
                                       rtol=LOSS_TOL)
        np.testing.assert_allclose(parts["feats"].detach().numpy(),
                                   np.asarray(feats), rtol=1e-5, atol=1e-6)
        _grads_close(grads, want_g)


def test_behavior_losses_match_jax():
    """The actor's loss (minus the mean lambda-return of the imagined
    rollouts) with its gradients, and the critic's, from the same
    posterior states and the JAX key's imagination normals."""
    jalgo, algo = _pair()
    fns = closure(jalgo._update_jit)
    mb = _sequences(3)
    key = jax.random.PRNGKey(4)
    _, (_, _, _, feats) = fns["wm_loss"](
        jalgo.params, {k: jnp.asarray(v) for k, v in mb.items()}, key)
    want_a, want_c, _ = fns["behavior_losses"](
        jalgo.actor_params, jalgo.critic_params, jalgo.params, feats, key)
    want_g = jax.grad(lambda ap: fns["behavior_losses"](
        ap, jalgo.critic_params, jalgo.params, feats, key)[0])(
            jalgo.actor_params)
    noise = _imagine_noise(key, 4, B * T, 1, 4)
    starts = _t(np.asarray(feats)).reshape(B * T, -1)
    got_a, _ = algo._actor_loss(algo.actor_params, starts, noise)
    grads = torch.autograd.grad(got_a, list(named_leaves(
        algo.actor_params).values()))
    got_c, _ = algo._critic_loss(algo.critic_params, starts, noise)
    np.testing.assert_allclose(float(got_a.detach()), float(want_a),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(got_c.detach()), float(want_c),
                               rtol=LOSS_TOL)
    _grads_close(grads, want_g)


def test_dreamer_updates_match_jax():
    """Two whole updates (the world model's step, the actor's through the
    stepped model, the critic's against the stepped actor) with the JAX
    key's normals: the six metrics, then the three parameter trees and
    their Adam states."""
    jalgo, algo = _pair()
    for i in range(2):
        mb = _sequences(10 + i)
        key = jax.random.PRNGKey(20 + i)
        (jalgo.params, jalgo.actor_params, jalgo.critic_params,
         jalgo._wm_state, jalgo._actor_state, jalgo._critic_state,
         want) = jalgo._update_jit(
            jalgo.params, jalgo.actor_params, jalgo.critic_params,
            jalgo._wm_state, jalgo._actor_state, jalgo._critic_state,
            {k: jnp.asarray(v) for k, v in mb.items()}, key)
        got = algo.learn_on_batch(mb, _update_noise(key, algo))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=k)
    assert_state(algo, jalgo)


def test_filter_step_matches_jax():
    """One filtering step and action from the same recurrent state and
    normals: the posterior state and the action."""
    jalgo, algo = _pair()
    rng = np.random.default_rng(5)
    h = rng.normal(size=16).astype(np.float32)
    z = rng.normal(size=4).astype(np.float32)
    a_prev = np.asarray([0.3], np.float32)
    obs = np.asarray([1.5], np.float32)
    key = jax.random.PRNGKey(6)
    k1, k2 = jax.random.split(key)
    wh, wz = jalgo._filter_jit(jalgo.params, jnp.asarray(h[None]),
                               jnp.asarray(z[None]),
                               jnp.asarray(a_prev[None]),
                               jnp.asarray(obs[None]), k1)
    wa = jalgo._actor_sample_jit(jalgo.actor_params,
                                 jnp.concatenate([wh, wz], -1), k2)
    algo._h, algo._z, algo._a_prev = h, z, a_prev
    gh, gz, ga = algo._filter_and_act(
        obs, _t(np.asarray(jax.random.normal(k1, (1, 4)))),
        _t(np.asarray(jax.random.normal(k2, (1, 1)))))
    for g, w in ((gh, wh), (gz, wz), (ga, wa)):
        np.testing.assert_allclose(g, np.asarray(w)[0], rtol=1e-5,
                                   atol=1e-6)


# -- tests/test_rllib_dreamer.py on the port ----------------------------------

def test_dreamer_rejects_discrete_actions(port_cluster):
    with pytest.raises(ValueError, match="Box action"):
        (DreamerConfig().environment("CartPole-v1")
         .resources(device="cpu").debugging(seed=0)).build()


def test_lambda_returns_match_reference(port_cluster):
    """TD(lambda) over imagined states vs a straightforward numpy
    recursion."""
    algo = (DreamerConfig().environment(PointGoalEnv)
            .training(prefill_steps=10, rollout_steps_per_iteration=10,
                      num_train_batches_per_iteration=0)
            .resources(device="cpu").debugging(seed=0)).build()
    gamma, lam = algo.config.gamma, algo.config.lambda_
    rng = np.random.default_rng(0)
    rew = rng.standard_normal((2, 6)).astype(np.float32)
    val = rng.standard_normal((2, 6)).astype(np.float32)

    def numpy_lambda(rew, val):
        H = rew.shape[1]
        out = np.zeros_like(rew)
        out[:, H - 1] = rew[:, H - 1] + gamma * val[:, H - 1]
        for t in range(H - 2, -1, -1):
            out[:, t] = rew[:, t] + gamma * (
                (1 - lam) * val[:, t + 1] + lam * out[:, t + 1])
        return out

    got = dreamer.lambda_returns(_t(rew), _t(val), gamma, lam).numpy()
    np.testing.assert_allclose(got, numpy_lambda(rew, val), rtol=1e-5)
    algo.stop()


def test_dreamer_world_model_fits(port_cluster):
    """Reconstruction and reward prediction must improve measurably as
    the RSSM trains on replayed sequences."""
    algo = (DreamerConfig().environment(PointGoalEnv)
            .training(prefill_steps=300, rollout_steps_per_iteration=150,
                      num_train_batches_per_iteration=15, seq_len=10,
                      imagine_horizon=8, action_repeat=1)
            .resources(device="cpu").debugging(seed=0)).build()
    first = None
    for _ in range(6):
        res = algo.train()
        if first is None and "wm_loss" in res:
            first = res["wm_loss"]
    assert first is not None and res["wm_loss"] < first * 0.7, \
        (first, res.get("wm_loss"))
    assert res["recon_loss"] < 1.0
    algo.stop()


def test_dreamer_filter_state_advances(port_cluster):
    algo = (DreamerConfig().environment(PointGoalEnv)
            .training(prefill_steps=5, rollout_steps_per_iteration=5,
                      num_train_batches_per_iteration=0)
            .resources(device="cpu").debugging(seed=0)).build()
    obs, _ = algo._env.reset(seed=1)
    z_before = algo._z.copy()
    a = algo.compute_single_action(obs)
    assert a.shape == (1,)
    assert -1.0 <= float(a[0]) <= 1.0
    # The stochastic state moves on the first observation (the GRU path
    # h needs a nonzero z first — zero-bias init keeps it at 0 for one
    # step); a second step must move h too.
    assert not np.allclose(algo._z, z_before)
    algo.compute_single_action(obs)
    assert not np.allclose(algo._h, 0.0)
    algo.stop()


def test_dreamer_evaluate_isolated_from_collection(port_cluster):
    """evaluate() must not corrupt the collection episode's recurrent
    filter state or env."""
    algo = (DreamerConfig().environment(PointGoalEnv)
            .training(prefill_steps=5, rollout_steps_per_iteration=20,
                      num_train_batches_per_iteration=0)
            .resources(device="cpu").debugging(seed=0)).build()
    algo.train()
    h, z, obs = algo._h.copy(), algo._z.copy(), np.copy(algo._obs)
    env = algo._env
    out = algo.evaluate()
    assert out["episodes_this_eval"] == 3
    np.testing.assert_array_equal(algo._h, h)
    np.testing.assert_array_equal(algo._z, z)
    np.testing.assert_array_equal(algo._obs, obs)
    assert algo._env is env
    algo.stop()


@pytest.mark.slow
def test_tuned_dreamer_learns(port_cluster):
    """Latent imagination improves the policy on the fast-model task:
    random ~= -60/episode, gate -45."""
    from ray_tpu_torch.rllib.tuned_examples import run_tuned_example
    out = run_tuned_example("pointgoal-dreamer", device="cpu")
    assert out["passed"], out


def test_dreamer_checkpoint_roundtrip(port_cluster, tmp_path):
    """Saved and restored: the same world model, actor and critic, and
    the same noise-free action from the same filter state."""
    cfg = (DreamerConfig().environment(PointGoalEnv)
           .training(prefill_steps=40, rollout_steps_per_iteration=60,
                     num_train_batches_per_iteration=2, seq_len=5,
                     imagine_horizon=3, action_repeat=1)
           .resources(device="cpu").debugging(seed=0))
    cfg.batch_size = 4
    algo = cfg.build()
    algo.train()
    path = algo.save(str(tmp_path))
    algo2 = cfg.build()
    algo2.restore(path)
    for a in (algo, algo2):
        a._h = np.zeros(a._D, np.float32)
        a._z = np.zeros(a._Z, np.float32)
        a._a_prev = np.zeros(1, np.float32)
    obs = np.asarray([0.7], np.float32)
    noise = (torch.zeros((1, algo._Z)), torch.zeros((1, 1)))
    want = algo._filter_and_act(obs, *noise)
    got = algo2._filter_and_act(obs, *noise)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    algo.stop()
    algo2.stop()
