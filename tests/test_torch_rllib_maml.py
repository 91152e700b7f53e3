"""The port's MAML against the JAX package's, and
``tests/test_rllib_maml.py``'s cases on the port.

Held to the JAX package from the carried-over policy and meta-Adam state,
on seeded REINFORCE batches of the hidden-goal point task's shapes: the
inner step ``p - inner_lr * g``, the first-order outer gradient taken at
the adapted parameters, and two meta-updates over three tasks (each
adapted by two inner steps). The learners run on the CPU
(``.resources(device="cpu")``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_rllib_pair import (GRAD_ATOL, GRAD_RTOL, assert_state, bare,
                               carry, one_torch_thread, port_cluster)
from ray_tpu.rllib.algorithms import maml as jmaml
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu_torch.rllib import MAMLConfig
from ray_tpu_torch.rllib.algorithms import maml
from ray_tpu_torch.rllib.env.examples import PointGoalEnv
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.torch_policy import named_leaves


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair():
    import gymnasium as gym

    spaces = (gym.spaces.Box(-5.0, 5.0, (1,), np.float32),
              gym.spaces.Box(-1.0, 1.0, (1,), np.float32))
    kw = dict(inner_lr=0.1, lr=1e-2, model={"fcnet_hiddens": [16, 16]})
    jcfg = jmaml.MAMLConfig().training(**kw).debugging(seed=2)
    cfg = MAMLConfig().training(**kw).resources(
        device="cpu").debugging(seed=2)
    jalgo = bare(jmaml.MAML, jcfg, jmake_policy(jcfg.policy_config(),
                                                *spaces, seed=2))
    algo = bare(maml.MAML, cfg, make_policy(cfg.policy_config(), *spaces,
                                            seed=2, device="cpu"))
    carry(jalgo, algo)
    return jalgo, algo


def _batch(seed, n=60):
    rng = np.random.default_rng(seed)
    adv = rng.normal(size=n).astype(np.float32)
    return (rng.uniform(-3, 3, (n, 1)).astype(np.float32),
            rng.normal(0, 0.8, (n, 1)).astype(np.float32),
            (adv - adv.mean()) / adv.std())


def _leaves_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    got = list(got.values()) if isinstance(got, dict) else got
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


def test_maml_inner_step_and_outer_gradient_match_jax():
    """The inner REINFORCE step from the meta-parameters, and the outer
    gradient at the adapted parameters (zeros for the value head)."""
    jalgo, algo = _pair()
    pre, post = _batch(1), _batch(2)
    jadapted = jalgo._inner_update_jit(jalgo.local_policy.params,
                                       *map(jnp.asarray, pre))
    adapted = algo._inner_update(algo.local_policy.params, *map(_t, pre))
    _leaves_close(named_leaves(adapted), jadapted, rtol=1e-5, atol=1e-6)
    want = jalgo._outer_grad_jit(jadapted, *map(jnp.asarray, post))
    got = maml.reinforce_grads(algo.local_policy, adapted, *map(_t, post))
    _leaves_close(got, want)
    assert all(float(g.abs().max()) == 0.0 for n, g in got.items()
               if n.startswith("vf/"))


def test_maml_meta_updates_match_jax():
    """Two meta-updates over three tasks, each adapted by two inner
    steps: the summed outer gradients divided by the task count, then
    Adam on the meta-parameters (every parameter and moment after)."""
    jalgo, algo = _pair()
    for it in range(2):
        tasks = [([_batch(100 * it + 10 * k + j) for j in range(2)],
                  _batch(100 * it + 10 * k + 5)) for k in range(3)]
        meta = None
        for pres, post in tasks:
            params = jalgo.local_policy.params
            for pre in pres:
                params = jalgo._inner_update_jit(params,
                                                 *map(jnp.asarray, pre))
            g = jalgo._outer_grad_jit(params, *map(jnp.asarray, post))
            meta = g if meta is None else jax.tree.map(
                lambda a, b: a + b, meta, g)
        meta = jax.tree.map(lambda g: g / len(tasks), meta)
        updates, jalgo._meta_state = jalgo._meta_opt.update(
            meta, jalgo._meta_state, jalgo.local_policy.params)
        jalgo.local_policy.params = optax.apply_updates(
            jalgo.local_policy.params, updates)
        algo.learn_on_tasks([([tuple(map(_t, b)) for b in pres],
                              tuple(map(_t, post))) for pres, post in tasks])
    assert_state(algo, jalgo)


# -- tests/test_rllib_maml.py on the port -------------------------------------

def _goal_sampler(rng):
    return {"goal": float(rng.uniform(-2.5, 2.5))}


def _build(seed=0, **training):
    kw = dict(task_sampler=_goal_sampler, inner_lr=0.1, lr=1e-2,
              inner_steps=1, episodes_per_inner_batch=8,
              tasks_per_iteration=5)
    kw.update(training)
    return (MAMLConfig().environment(PointGoalEnv)
            .training(**kw).resources(device="cpu")
            .debugging(seed=seed)).build()


def test_hidden_goal_stays_hidden():
    env = PointGoalEnv({"goal": 2.0})
    obs, _ = env.reset(seed=0)
    assert obs.shape == (1,)  # position only — the goal is NOT observable
    _, r, _, _, _ = env.step([0.0])
    assert r == pytest.approx(-abs(env.pos - 2.0))


def test_inner_update_moves_params(port_cluster):
    algo = _build()
    env = PointGoalEnv({"goal": 1.0})
    before = [t.detach().clone() for t in
              named_leaves(algo.local_policy.params).values()]
    adapted = algo.adapt(env, inner_steps=1)
    after = list(named_leaves(adapted).values())
    assert any(not torch.allclose(a, b.detach())
               for a, b in zip(before, after))
    # Meta-params untouched by adaptation (it clones, never mutates).
    for a, b in zip(before, named_leaves(algo.local_policy.params).values()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    algo.stop()


def _eval_post_adaptation(algo, n_tasks=8):
    """Mean post-adaptation return over fresh hidden-goal tasks."""
    rng = np.random.default_rng(123)
    outs = []
    for _ in range(n_tasks):
        env = PointGoalEnv({"goal": float(rng.uniform(-2.5, 2.5))})
        params = algo.adapt(env)
        _, _, _, ret = algo._collect(env, params, 8)
        outs.append(ret)
    return float(np.mean(outs))


@pytest.mark.slow
def test_maml_learns_to_adapt(port_cluster):
    """After meta-training, one inner step on FRESH hidden-goal tasks
    lands at a strong absolute level, and meta-training does not degrade
    the post-adaptation return."""
    algo = _build(inner_lr=0.05, lr=5e-3, inner_steps=3,
                  episodes_per_inner_batch=8, tasks_per_iteration=5)
    posts = []
    for _ in range(25):
        posts.append(algo.train()["post_adaptation_return"])
    assert np.mean(posts[-5:]) > np.mean(posts[:5]) - 15.0, posts
    meta_score = _eval_post_adaptation(algo)
    assert meta_score > -65.0, meta_score
    algo.stop()


def test_maml_checkpoint_roundtrip(port_cluster, tmp_path):
    """Saved and restored after a meta-iteration: the same weights, and the
    same adapted parameters from the same batch."""
    algo = _build(tasks_per_iteration=2, episodes_per_inner_batch=2)
    algo.train()
    path = algo.save(str(tmp_path))
    algo2 = _build(tasks_per_iteration=2, episodes_per_inner_batch=2)
    algo2.restore(path)
    for a, b in zip(named_leaves(algo.get_weights()).values(),
                    named_leaves(algo2.get_weights()).values()):
        np.testing.assert_array_equal(a, b)
    batch = tuple(map(_t, _batch(9)))
    for a, b in zip(named_leaves(algo._inner_update(
            algo.local_policy.params, *batch)).values(),
            named_leaves(algo2._inner_update(
                algo2.local_policy.params, *batch)).values()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    algo.stop()
    algo2.stop()
