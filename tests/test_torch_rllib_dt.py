"""The port's Decision Transformer against the JAX package's, and
``tests/test_rllib_dt.py``'s cases on the port.

Held to the JAX package from the carried-over parameters and Adam state,
on episodes written by the JAX package's ``JsonWriter``: the same context
windows drawn from the same numpy seed (left-padded where an episode is
shorter than the context), the action predictions on such a padded batch
(pre-LN blocks, the causal and padding mask filled with -1e9, GELU's tanh
form), the loss and its gradients, and three Adam steps, for a discrete
(cross-entropy) and a Box (MSE on tanh) action space. The learners run on
the CPU (``.resources(device="cpu")``).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_rllib_pair import (GRAD_ATOL, GRAD_RTOL, LOSS_TOL, assert_state,
                               bare, carry, closure, one_torch_thread,
                               port_cluster, transitions)
from ray_tpu.rllib.algorithms import dt as jdt
from ray_tpu.rllib.offline import JsonWriter as JJsonWriter
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu.rllib.policy.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch.rllib import DTConfig, SampleBatch
from ray_tpu_torch.rllib.algorithms import dt
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.torch_policy import named_leaves

KINDS = ["cartpole", "pendulum"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(tmp_path, kind):
    import gymnasium as gym

    path = str(tmp_path / "exp")
    writer = JJsonWriter(path)
    for i in range(3):
        writer.write(JSampleBatch(dict(transitions(120, kind, 40 + i))))
    writer.close()
    if kind == "cartpole":
        spaces = (gym.spaces.Box(-np.inf, np.inf, (4,), np.float32),
                  gym.spaces.Discrete(2))
    else:
        spaces = (gym.spaces.Box(-np.inf, np.inf, (3,), np.float32),
                  gym.spaces.Box(-2.0, 2.0, (1,), np.float32))
    kw = dict(lr=3e-3, context_len=6, embed_dim=16, n_layers=2, n_heads=2,
              max_ep_len=64, train_batch_size=8)
    jcfg = jdt.DTConfig().training(**kw).offline_data(
        input_=path).debugging(seed=3)
    cfg = DTConfig().training(**kw).offline_data(input_=path).resources(
        device="cpu").debugging(seed=3)
    jalgo = bare(jdt.DT, jcfg, jmake_policy(jcfg.policy_config(), *spaces,
                                            seed=3))
    algo = bare(dt.DT, cfg, make_policy(cfg.policy_config(), *spaces,
                                        seed=3, device="cpu"))
    carry(jalgo, algo)
    return jalgo, algo


def _minibatches(jalgo, algo):
    """The next context windows of both, which must be equal."""
    want = jalgo._sample_minibatch(jalgo.config)
    got = algo._sample_minibatch(algo.config)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    return got, want


@pytest.mark.parametrize("kind", KINDS)
def test_dt_predictions_loss_and_gradients_match_jax(tmp_path, kind):
    """A padded batch of context windows: the same windows, the action
    predictions at every observation token, the masked loss and its
    gradients."""
    jalgo, algo = _pair(tmp_path, kind)
    mb, jmb = _minibatches(jalgo, algo)
    assert (mb["mask"] == 0).any()  # some windows are left-padded
    args = ("rtg", "obs", "act_in", "timesteps", "mask")
    want = jalgo._forward_jit(jalgo.params, *(jmb[k] for k in args))
    with torch.no_grad():
        got = algo._forward(algo.params, *(_t(mb[k]) for k in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    loss_fn = closure(jalgo._update_jit)["loss_fn"]
    want, want_g = jax.value_and_grad(loss_fn)(jalgo.params, jmb)
    got, _ = algo._loss(algo.params, {k: _t(v) for k, v in mb.items()})
    grads = torch.autograd.grad(got, list(named_leaves(
        algo.params).values()))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_dt_updates_match_jax(tmp_path, kind):
    """Three Adam steps on the same windows: each loss, then every
    parameter and moment."""
    jalgo, algo = _pair(tmp_path, kind)
    for _ in range(3):
        mb, jmb = _minibatches(jalgo, algo)
        jalgo.params, jalgo._opt_state, want = jalgo._update_jit(
            jalgo.params, jalgo._opt_state, jmb)
        got = algo.learn_on_batch(mb)
        np.testing.assert_allclose(got, float(want), rtol=1e-4)
    assert_state(algo, jalgo)


# -- tests/test_rllib_dt.py on the port ---------------------------------------

def _write_cartpole_dataset(path: str, heuristic_eps=20, random_eps=20,
                            seed=0):
    """Mixed-quality logged data, written by the port's JsonWriter: a
    pole-angle heuristic (~170/episode) and uniform random
    (~20/episode)."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.offline import JsonWriter
    w = JsonWriter(path)
    env = gym.make("CartPole-v1")
    rng = np.random.default_rng(seed)
    returns = []
    for e, kind in enumerate(["h"] * heuristic_eps + ["r"] * random_eps):
        obs, _ = env.reset(seed=e)
        rows = {"obs": [], "actions": [], "rewards": [],
                "terminateds": [], "truncateds": [], "eps_id": []}
        done, total, t = False, 0.0, 0
        while not done and t < 200:
            if kind == "h" and rng.random() >= 0.1:
                a = 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0
            else:
                a = int(rng.integers(2))
            nxt, r, term, trunc, _ = env.step(a)
            rows["obs"].append(np.asarray(obs, np.float32))
            rows["actions"].append(a)
            rows["rewards"].append(float(r))
            rows["terminateds"].append(float(term))
            rows["truncateds"].append(float(trunc))
            rows["eps_id"].append(e)
            obs, total = nxt, total + r
            done = term or trunc
            t += 1
        returns.append(total)
        w.write(SampleBatch({k: np.asarray(v) for k, v in rows.items()}))
    w.close()
    return returns


def test_dt_requires_offline_input():
    with pytest.raises(ValueError, match="offline-only"):
        DTConfig().environment("CartPole-v1").build()


def test_dt_returns_to_go_slicing(tmp_path, port_cluster):
    """Episodes are sliced on eps_id and rtg[t] = sum of future rewards."""
    _write_cartpole_dataset(str(tmp_path), heuristic_eps=2, random_eps=2)
    algo = (DTConfig().environment("CartPole-v1")
            .offline_data(input_=str(tmp_path))
            .training(num_train_batches_per_iteration=1,
                      train_batch_size=4)
            .resources(device="cpu").debugging(seed=0)).build()
    assert len(algo._episodes) == 4
    for ep in algo._episodes:
        r = np.ones(len(ep["obs"]), np.float32)  # CartPole: +1/step
        want = np.cumsum(r[::-1])[::-1]
        np.testing.assert_allclose(ep["rtg"], want)
    assert algo._dataset_max_return == max(
        len(ep["obs"]) for ep in algo._episodes)


def test_dt_causal_mask_blocks_own_action(tmp_path, port_cluster):
    """The action predicted at o_t must not change when a_t (its own
    token, later in the interleave) changes — only earlier tokens and
    later predictions may."""
    _write_cartpole_dataset(str(tmp_path), heuristic_eps=2, random_eps=2)
    algo = (DTConfig().environment("CartPole-v1")
            .offline_data(input_=str(tmp_path))
            .training(context_len=4, train_batch_size=2,
                      num_train_batches_per_iteration=1)
            .resources(device="cpu").debugging(seed=0)).build()
    K = 4
    rtg = torch.ones((1, K, 1))
    obs = _t(np.random.default_rng(0).standard_normal(
        (1, K, 4)).astype(np.float32))
    ts = torch.arange(K, dtype=torch.int32)[None]
    mask = torch.ones((1, K))
    act_a = np.zeros((1, K, 2), np.float32)
    act_b = act_a.copy()
    act_b[0, 2] = [0.0, 1.0]  # flip a_2 only
    with torch.no_grad():
        pa = algo._forward(algo.params, rtg, obs, _t(act_a), ts,
                           mask).numpy()
        pb = algo._forward(algo.params, rtg, obs, _t(act_b), ts,
                           mask).numpy()
    # Predictions at t <= 2 unchanged (a_2 is not visible to them)...
    np.testing.assert_allclose(pa[0, :3], pb[0, :3], atol=1e-5)
    # ...and the t=3 prediction DOES see a_2.
    assert np.abs(pa[0, 3] - pb[0, 3]).max() > 1e-6


@pytest.mark.slow
def test_dt_return_conditioning_learns(tmp_path, port_cluster):
    """The DT inference gate: conditioning on a high return extracts the
    good behavior from mixed-quality data; conditioning low tracks the
    low target. Random CartPole ~= 20."""
    import gymnasium as gym

    _write_cartpole_dataset(str(tmp_path))
    algo = (DTConfig().environment("CartPole-v1")
            .offline_data(input_=str(tmp_path))
            .training(lr=1e-3, train_batch_size=64, context_len=20,
                      num_train_batches_per_iteration=50)
            .resources(device="cpu").debugging(seed=0)).build()
    for _ in range(5):
        res = algo.train()
    assert res["loss"] < 0.45
    env = gym.make("CartPole-v1")
    high = algo.evaluate_env(env, target_return=200.0, episodes=3,
                             seed=100)
    low = algo.evaluate_env(env, target_return=20.0, episodes=3,
                            seed=100)
    assert high > 100.0, (high, low)
    assert high > low + 50.0, (high, low)


def test_dt_checkpoint_roundtrip(tmp_path, port_cluster):
    """Saved and restored: the same weights, and the same return-
    conditioned episode returns."""
    import gymnasium as gym

    _write_cartpole_dataset(str(tmp_path / "data"), heuristic_eps=2,
                            random_eps=2)
    cfg = (DTConfig().environment("CartPole-v1")
           .offline_data(input_=str(tmp_path / "data"))
           .training(context_len=5, train_batch_size=8, embed_dim=16,
                     num_train_batches_per_iteration=2)
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build()
    algo.train()
    path = algo.save(str(tmp_path / "ckpt"))
    algo2 = cfg.build()
    algo2.restore(path)
    for a, b in zip(jax.tree_util.tree_leaves(algo.get_weights()),
                    jax.tree_util.tree_leaves(algo2.get_weights())):
        np.testing.assert_array_equal(a, b)
    env = gym.make("CartPole-v1")
    assert algo2.evaluate_env(env, 100.0, episodes=2, seed=7) == \
        algo.evaluate_env(env, 100.0, episodes=2, seed=7)
