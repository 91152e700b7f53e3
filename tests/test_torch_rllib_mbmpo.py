"""The port's MBMPO against the JAX package's, and
``tests/test_rllib_mbmpo.py``'s cases on the port.

Held to the JAX package from the carried-over learner state (the policy,
the ensemble of three dynamics models, their Adam states and the meta
Adam state) on the same real transitions: the ensemble fit (the buffer's
statistics, each member's bootstrap resamples and Adam steps, the mean of
their last losses), the models' next-state predictions and their
disagreement, and one meta-update over one imagined task per model. The
learners run on the CPU (``.resources(device="cpu")``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_rllib_pair import (STEP_ATOL, STEP_RTOL, assert_state, bare,
                               carry, one_torch_thread, port_cluster)
from ray_tpu.rllib.algorithms import mbmpo as jmbmpo
from ray_tpu.rllib.env.examples import PointGoalEnv as JPointGoalEnv
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu_torch.rllib import MBMPOConfig
from ray_tpu_torch.rllib.algorithms import mbmpo
from ray_tpu_torch.rllib.env.examples import PointGoalEnv
from ray_tpu_torch.rllib.policy import make_policy


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair():
    import gymnasium as gym

    spaces = (gym.spaces.Box(-5.0, 5.0, (1,), np.float32),
              gym.spaces.Box(-1.0, 1.0, (1,), np.float32))
    kw = dict(dynamics_hiddens=(16, 16), dynamics_epochs=4,
              dynamics_batch_size=32, model={"fcnet_hiddens": [16, 16]})
    jcfg = jmbmpo.MBMPOConfig().training(**kw).debugging(seed=4)
    cfg = MBMPOConfig().training(**kw).resources(
        device="cpu").debugging(seed=4)
    jalgo = bare(jmbmpo.MBMPO, jcfg, jmake_policy(jcfg.policy_config(),
                                                  *spaces, seed=4),
                 _env_creator=lambda c: JPointGoalEnv(c))
    algo = bare(mbmpo.MBMPO, cfg, make_policy(cfg.policy_config(), *spaces,
                                              seed=4, device="cpu"),
                _env_creator=lambda c: PointGoalEnv(c))
    carry(jalgo, algo)
    rng = np.random.default_rng(7)
    s = rng.uniform(-3, 3, (200, 1)).astype(np.float32)
    a = rng.uniform(-1, 1, (200, 1)).astype(np.float32)
    ns = np.clip(s + a, -5, 5)
    for algo_ in (jalgo, algo):
        algo_._buffer_s = list(s)
        algo_._buffer_a = list(a)
        algo_._buffer_ns = list(ns)
    return jalgo, algo


def test_mbmpo_ensemble_fit_matches_jax():
    """The buffer's normalization statistics, then every member's four
    Adam steps on its own bootstrap resamples: the mean last loss, each
    model and its Adam state; then the members' next-state predictions
    and their disagreement."""
    jalgo, algo = _pair()
    want = jalgo._fit_dynamics()
    got = algo._fit_dynamics()
    assert got == pytest.approx(want, rel=STEP_RTOL)
    for k in jalgo._stats:
        np.testing.assert_array_equal(algo._stats[k], jalgo._stats[k])
    assert_state(algo, jalgo)
    rng = np.random.default_rng(8)
    s = rng.uniform(-3, 3, (6, 1)).astype(np.float32)
    a = rng.uniform(-1, 1, (6, 1)).astype(np.float32)
    stats = {k: jnp.asarray(v) for k, v in jalgo._stats.items()}
    for jp, p in zip(jalgo.dyn_params, algo.dyn_params):
        want = jalgo._dyn_forward_jit(jp, stats, jnp.asarray(s),
                                      jnp.asarray(a))
        with torch.no_grad():
            got = mbmpo.dyn_forward(p, algo._device_stats(), _t(s), _t(a))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert algo.dynamics_disagreement(s, a) == pytest.approx(
        jalgo.dynamics_disagreement(s, a), rel=1e-4)


def _imagined(seed, n=80):
    rng = np.random.default_rng(seed)
    adv = rng.normal(size=n).astype(np.float32)
    return (rng.uniform(-3, 3, (n, 1)).astype(np.float32),
            rng.normal(0, 0.8, (n, 1)).astype(np.float32),
            (adv - adv.mean()) / adv.std())


def test_mbmpo_meta_update_matches_jax():
    """One meta-update over one imagined task per model: MAML's inner
    step on the task's first batch, the outer gradient at the adapted
    parameters on its second, averaged over the three models, then the
    meta Adam step."""
    jalgo, algo = _pair()
    tasks = [(_imagined(10 + k), _imagined(20 + k)) for k in range(3)]
    meta = None
    params = jalgo.local_policy.params
    for pre, post in tasks:
        adapted = jalgo._inner_update_jit(params, *map(jnp.asarray, pre))
        g = jalgo._outer_grad_jit(adapted, *map(jnp.asarray, post))
        meta = g if meta is None else jax.tree.map(lambda x, y: x + y,
                                                   meta, g)
    meta = jax.tree.map(lambda g: g / 3, meta)
    updates, jalgo._meta_state = jalgo._meta_opt.update(
        meta, jalgo._meta_state, params)
    jalgo.local_policy.params = optax.apply_updates(params, updates)
    algo.learn_on_tasks([(tuple(map(_t, pre)), tuple(map(_t, post)))
                         for pre, post in tasks])
    assert_state(algo, jalgo, rtol=STEP_RTOL, atol=STEP_ATOL)


# -- tests/test_rllib_mbmpo.py on the port ------------------------------------

def _build(seed=0, **training):
    cfg = (MBMPOConfig().environment(PointGoalEnv).resources(device="cpu")
           .debugging(seed=seed))
    if training:
        cfg = cfg.training(**training)
    return cfg.build()


def test_requires_reward_fn_and_box(port_cluster):
    with pytest.raises(ValueError, match="reward_fn"):
        (MBMPOConfig().environment("Pendulum-v1")
         .resources(device="cpu").debugging(seed=0)).build()


def test_dynamics_ensemble_fits_and_disagrees(port_cluster):
    """Member losses fall as the ensemble trains; bootstrap resamples
    keep members distinct (nonzero prediction disagreement)."""
    algo = _build(dynamics_epochs=10)
    first = algo.train()["dynamics_loss"]
    for _ in range(3):
        last = algo.train()["dynamics_loss"]
    assert last < first, (first, last)
    s = np.zeros((4, 1), np.float32)
    a = np.full((4, 1), 0.5, np.float32)
    d = algo.dynamics_disagreement(s, a)
    assert d > 0.0
    algo.stop()


def test_imagination_uses_models_not_env(port_cluster):
    """Imagined rollouts must not advance the real env."""
    algo = _build(dynamics_epochs=5)
    algo.train()  # fills buffer + fits models
    env_pos = algo._env.pos
    env_t = algo._env._t
    obs, act, adv, ret = algo._imagine_batch(
        algo.local_policy.params, 0)
    assert obs.shape[0] == (algo.config.imagined_episodes *
                            algo.config.imagined_horizon)
    assert algo._env.pos == env_pos and algo._env._t == env_t
    assert np.isfinite(ret)
    algo.stop()


@pytest.mark.slow
def test_mbmpo_learns_from_imagination(port_cluster):
    """The model-based gate: nearly all gradient steps come from
    imagined rollouts, yet REAL env return climbs from random (~-60)
    past -25 within 15 iterations."""
    algo = _build()
    best = -1e9
    for _ in range(15):
        res = algo.train()
        r = res["episode_reward_mean"]
        if r == r:
            best = max(best, r)
    assert best > -25.0, best
    algo.stop()


def test_mbmpo_checkpoint_roundtrip(port_cluster, tmp_path):
    """Saved and restored: the same policy, models and statistics, and the
    same ensemble predictions."""
    algo = _build(dynamics_epochs=3, real_steps_per_iteration=60)
    algo.train()
    path = algo.save(str(tmp_path))
    algo2 = _build(dynamics_epochs=3, real_steps_per_iteration=60)
    algo2.restore(path)
    for a, b in zip(jax.tree_util.tree_leaves(algo.get_weights()),
                    jax.tree_util.tree_leaves(algo2.get_weights())):
        np.testing.assert_array_equal(a, b)
    s = np.linspace(-2, 2, 5, dtype=np.float32)[:, None]
    a = np.full((5, 1), 0.3, np.float32)
    assert algo2.dynamics_disagreement(s, a) == \
        algo.dynamics_disagreement(s, a)
    algo.stop()
    algo2.stop()
