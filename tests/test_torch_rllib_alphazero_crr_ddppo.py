"""The port's AlphaZero, CRR and DDPPO against the JAX package's, and
``tests/test_rllib_alphazero_crr_ddppo.py``'s cases on the port.

Held to the JAX package from the same inputs (numpy seeds) and the
carried-over learner state: AlphaZero's priors and value, its leaf
evaluation and an exploit-mode search, and three updates; CRR's critic
and actor losses and their gradients (binary weights over a categorical
policy, exponential ones over a gaussian policy whose expectation samples
are the JAX key's ``fold_in`` draws) and three whole updates; DDPPO's
flat gradient vector in ``jax.tree.flatten``'s order, and one iteration of
two workers that learn on fixed batches and all-reduce their gradients
through each package's collective group. The learners run on the CPU
(``.resources(device="cpu")``); built without a device, each of the
slice's eight learners asks for the card and raises without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_rllib_pair import (GRAD_ATOL, GRAD_RTOL, LOSS_TOL, STEP_ATOL,
                               STEP_RTOL, assert_state, bare, carry, closure,
                               one_torch_thread, port_cluster, transitions)
from ray_tpu.rllib import DDPPOConfig as JDDPPOConfig
from ray_tpu.rllib.algorithms import alpha_zero as jalpha_zero
from ray_tpu.rllib.algorithms import crr as jcrr
from ray_tpu.rllib.algorithms import ddppo as jddppo
from ray_tpu.rllib.env.examples import ClonableCartPole as JClonableCartPole
from ray_tpu.rllib.offline import JsonWriter as JJsonWriter
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu.rllib.policy.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch.rllib import (AlphaZeroConfig, CRRConfig, DDPPOConfig,
                                 SampleBatch)
from ray_tpu_torch.rllib.algorithms import alpha_zero, crr, ddppo
from ray_tpu_torch.rllib.algorithms.learner_state import flat_leaves
from ray_tpu_torch.rllib.env.examples import ClonableCartPole
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.torch_policy import named_leaves


def _t(a):
    return torch.from_numpy(np.array(a))


# -- AlphaZero against the JAX package ----------------------------------------

def _az_pair():
    kw = dict(lr=3e-3, model={"fcnet_hiddens": [32, 32]}, num_simulations=8)
    jcfg = jalpha_zero.AlphaZeroConfig().training(**kw).debugging(seed=4)
    cfg = AlphaZeroConfig().training(**kw).resources(
        device="cpu").debugging(seed=4)
    jalgo = bare(jalpha_zero.AlphaZero, jcfg, None,
                 _env_creator=lambda c: JClonableCartPole(c))
    algo = bare(alpha_zero.AlphaZero, cfg, None,
                _env_creator=lambda c: ClonableCartPole(c))
    carry(jalgo, algo)
    return jalgo, algo


def _az_rows(n, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, 2), np.float32)
    mask[rng.random(n) < 0.2, 0] = 0.0
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "tree_policy": rng.dirichlet([1.0, 1.0], n).astype(np.float32),
            "mask": mask,
            "z": rng.choice([-1.0, 1.0], (n, 1)).astype(np.float32)}


def test_alphazero_priors_value_and_updates_match_jax():
    """The network's logits and value, the leaf evaluation's priors, and
    three Adam steps (the policy and value losses of each, then every
    parameter and moment) from the carried-over state."""
    jalgo, algo = _az_pair()
    obs = np.random.default_rng(1).normal(size=(16, 4)).astype(np.float32)
    wl, wv = jalgo._pv_jit(jalgo.params, jnp.asarray(obs))
    with torch.no_grad():
        gl, gv = alpha_zero.priors_and_value(algo.params, _t(obs))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-6)
    mask = np.asarray([1.0, 0.0], np.float32)
    for m in (None, mask):
        want_p, want_v = jalgo._evaluate(obs[3], m)
        got_p, got_v = algo._evaluate(obs[3], m)
        np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-7)
        assert got_v == pytest.approx(want_v, rel=1e-6, abs=1e-7)
    for i in range(3):
        mb = _az_rows(32, 10 + i)
        jmb = {k: jnp.asarray(v) for k, v in mb.items()}
        jmb["z"] = jmb["z"][:, 0]
        (jalgo.params, jalgo._opt_state, pl, vl) = jalgo._update_jit(
            jalgo.params, jalgo._opt_state, jmb)
        got = algo.learn_on_batch(SampleBatch(mb))
        np.testing.assert_allclose(got["policy_loss"], float(pl),
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(got["value_loss"], float(vl),
                                   rtol=LOSS_TOL)
    assert_state(algo, jalgo)


def test_alphazero_search_matches_jax():
    """An exploit-mode search from the same environment state: the same
    visit-count policy, and the environment restored in both."""
    jalgo, algo = _az_pair()
    obs, _ = jalgo._env.reset(seed=3)
    algo._env.reset(seed=3)
    want_pi, _ = jalgo._search(obs, explore=False)
    got_pi, _ = algo._search(obs, explore=False)
    np.testing.assert_array_equal(got_pi, want_pi)
    np.testing.assert_array_equal(algo._env.get_state()[0],
                                  jalgo._env.get_state()[0])


# -- CRR against the JAX package ----------------------------------------------

def _crr_pair(tmp_path, kind, weight_type):
    import gymnasium as gym

    path = str(tmp_path / "exp")
    writer = JJsonWriter(path)
    for i in range(3):
        writer.write(JSampleBatch(dict(transitions(96, kind, 30 + i))))
    writer.close()
    if kind == "cartpole":
        spaces = (gym.spaces.Box(-np.inf, np.inf, (4,), np.float32),
                  gym.spaces.Discrete(2))
    else:
        spaces = (gym.spaces.Box(-np.inf, np.inf, (3,), np.float32),
                  gym.spaces.Box(-2.0, 2.0, (1,), np.float32))
    kw = dict(lr=1e-3, critic_lr=2e-3, tau=0.1, weight_type=weight_type,
              beta=0.5, n_action_samples=3, train_batch_size=48,
              model={"fcnet_hiddens": [32, 32]})
    jcfg = jcrr.CRRConfig().training(**kw).offline_data(
        input_=path).debugging(seed=6)
    cfg = CRRConfig().training(**kw).offline_data(input_=path).resources(
        device="cpu").debugging(seed=6)
    jalgo = bare(jcrr.CRR, jcfg, jmake_policy(jcfg.policy_config(), *spaces,
                                              seed=6))
    algo = bare(crr.CRR, cfg, make_policy(cfg.policy_config(), *spaces,
                                          seed=6, device="cpu"))
    carry(jalgo, algo)
    return jalgo, algo


def _crr_mb(batch):
    """The JAX update's minibatch, as its training_step builds it."""
    return {k: jnp.asarray(np.asarray(batch[k], np.float32)
                           if k != "actions" else np.asarray(batch[k]))
            for k in ("obs", "actions", "rewards", "new_obs",
                      "terminateds")}


def _crr_noise(key, algo, batch):
    """The JAX update's expectation samples from ``key``: split into the
    critic's and the actor's keys, each folded in per sample."""
    if algo.local_policy.discrete:
        return None
    shape = (batch, algo.local_policy.act_dim)
    out = {}
    for name, k in zip(("critic", "actor"), jax.random.split(key)):
        out[name] = _t(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(k, i), shape))
            for i in range(algo.config.n_action_samples)]))
    return out


CRR_CASES = [("cartpole", "binary"), ("pendulum", "exp")]


@pytest.mark.parametrize("kind,weight_type", CRR_CASES,
                         ids=[f"{k}-{w}" for k, w in CRR_CASES])
def test_crr_losses_and_gradients_match_jax(tmp_path, kind, weight_type):
    """The critic's TD loss and the weighted actor loss (with its mean
    weight), and their gradients, from the same state and minibatch."""
    jalgo, algo = _crr_pair(tmp_path, kind, weight_type)
    mb = jalgo._reader.next_batch(48)
    jmb = _crr_mb(mb)
    tmb = {k: _t(np.asarray(v)) for k, v in jmb.items()}
    key = jax.random.PRNGKey(8)
    k1, k2 = jax.random.split(key)
    noise = _crr_noise(key, algo, 48)
    fns = closure(jalgo._update_jit)
    want, want_g = jax.value_and_grad(fns["critic_loss"])(
        jalgo._q_params, jalgo._q_target, jalgo.local_policy.params, jmb,
        k1)
    got, _ = algo._critic_loss(algo._q_params, tmb, noise)
    grads = torch.autograd.grad(got, list(named_leaves(
        algo._q_params).values()))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    (want, w_mean), want_g = jax.value_and_grad(
        fns["actor_loss"], has_aux=True)(jalgo.local_policy.params,
                                         jalgo._q_params, jmb, k2)
    got, aux = algo._actor_loss(algo.local_policy.params, tmb, noise)
    leaves = named_leaves(algo.local_policy.params)
    grads = torch.autograd.grad(got, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL, atol=1e-7)
    np.testing.assert_allclose(float(aux["weight_mean"]), float(w_mean),
                               rtol=LOSS_TOL)
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("kind,weight_type", CRR_CASES,
                         ids=[f"{k}-{w}" for k, w in CRR_CASES])
def test_crr_updates_match_jax(tmp_path, kind, weight_type):
    """Three whole updates (the critic's step, the actor's against the
    stepped critic, the target's polyak step) from the JAX key chain's
    noise: the metrics, then both networks, the target and both Adam
    states."""
    jalgo, algo = _crr_pair(tmp_path, kind, weight_type)
    key = jax.random.PRNGKey(13)
    for _ in range(3):
        mb = jalgo._reader.next_batch(48)
        key, sub = jax.random.split(key)
        (params, jalgo._q_params, jalgo._q_target, jalgo._actor_state,
         jalgo._critic_state, want) = jalgo._update_jit(
            jalgo.local_policy.params, jalgo._q_params, jalgo._q_target,
            jalgo._actor_state, jalgo._critic_state, _crr_mb(mb), sub)
        jalgo.local_policy.params = params
        got = algo.learn_on_batch(mb, _crr_noise(sub, algo, 48))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=k)
    assert_state(algo, jalgo)


# -- DDPPO against the JAX package --------------------------------------------

def test_ddppo_flat_matches_jax_tree_flatten():
    """The flat vector lays the leaves out as ``jax.tree.flatten`` does
    (dict keys sorted, whatever their insertion order), and comes back as
    the tree it was."""
    rng = np.random.default_rng(0)
    tree = {"vf": [{"w": rng.normal(size=(3, 2)), "b": rng.normal(size=2)}],
            "pi": [{"w": rng.normal(size=(3, 4)), "b": rng.normal(size=4)}],
            "log_std": rng.normal(size=4), "count": np.float32(2.0)}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    want, want_shapes, _ = jddppo._flat(jax.tree.map(jnp.asarray, tree))
    got, shapes, template = ddppo._flat(jax.tree.map(_t, tree))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert shapes == [tuple(s) for s in want_shapes]
    back = ddppo._unflat(got, shapes, template)
    assert list(back) == list(tree)
    for a, b in zip(flat_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def _gae_rows(n, seed):
    rng = np.random.default_rng(seed)
    return {SampleBatch.OBS: rng.normal(size=(n, 4)).astype(np.float32),
            SampleBatch.ACTIONS: rng.integers(0, 2, n),
            SampleBatch.ACTION_LOGP: rng.normal(-0.7, 0.1, n).astype(
                np.float32),
            SampleBatch.ADVANTAGES: rng.normal(1.0, 2.0, n).astype(
                np.float32),
            SampleBatch.VALUE_TARGETS: rng.normal(size=n).astype(
                np.float32)}


def _jax_learn_on(worker, cfg, iteration, batches):
    """The JAX worker's learning on its fixed batch of ``batches``."""
    worker.sample = lambda _n: batches[worker.worker_index - 1]
    return jddppo._worker_learn(worker, cfg, iteration)


def test_ddppo_allreduced_step_matches_jax(ray_start_regular, port_cluster):
    """One iteration of two workers from the same weights, each on its own
    fixed batch (2 epochs of 2 minibatches), their gradients all-reduced
    per minibatch through each package's collective group: each worker's
    weights match the JAX workers', and the two workers are bit-equal in
    each package."""
    kw = dict(lr=3e-3, num_sgd_iter=2, sgd_minibatch_size=64,
              steps_per_worker=128)
    jalgo = (JDDPPOConfig().environment("CartPole-v1")
             .rollouts(num_rollout_workers=2).training(**kw)
             .debugging(seed=0)).build()
    algo = (DDPPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2).training(**kw)
            .resources(device="cpu").debugging(seed=0)).build()
    try:
        algo.set_weights(jalgo.get_weights())
        rows = [_gae_rows(128, 5), _gae_rows(128, 6)]
        jalgo._reset_epoch += 1
        jalgo.workers.sync_weights(ray_tpu.put(jalgo.get_weights()))
        cfg = {"lr": 3e-3, "clip_param": 0.2, "vf_loss_coeff": 0.5,
               "entropy_coeff": 0.0, "num_sgd_iter": 2,
               "sgd_minibatch_size": 64, "steps_per_worker": 128,
               "group_name": jalgo._group_name, "world_size": 2,
               "reset_epoch": jalgo._reset_epoch}
        jbatches = [JSampleBatch(dict(r)) for r in rows]
        want = ray_tpu.get([w.apply.remote(_jax_learn_on, cfg, 0, jbatches)
                            for w in jalgo.workers.remote_workers])
        got = algo.learn_on_batches([SampleBatch(dict(r)) for r in rows])
        assert got["loss"] == pytest.approx(
            np.mean([r["loss"] for r in want]), rel=STEP_RTOL)
        jw = [ray_tpu.get(w.get_weights.remote())
              for w in jalgo.workers.remote_workers]
        pw = [ray_tpu_torch.get(w.get_weights.remote())
              for w in algo.workers.remote_workers]
        for a, b in zip(flat_leaves(pw[0]), flat_leaves(pw[1])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(flat_leaves(pw[0]), jax.tree_util.tree_leaves(jw[0])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
        for a, b in zip(flat_leaves(algo.get_weights()), flat_leaves(pw[0])):
            np.testing.assert_array_equal(a, b)
    finally:
        jalgo.stop()
        algo.stop()


# -- tests/test_rllib_alphazero_crr_ddppo.py on the port ----------------------

def test_clonable_cartpole_state_roundtrip():
    env = ClonableCartPole()
    obs, _ = env.reset(seed=0)
    assert set(obs) == {"obs", "action_mask"}
    saved = env.get_state()
    traj = [env.step(1)[0]["obs"] for _ in range(5)]
    env.set_state(saved)
    replay = [env.step(1)[0]["obs"] for _ in range(5)]
    # Deterministic env: restored state replays the exact trajectory.
    np.testing.assert_allclose(np.stack(traj), np.stack(replay))
    env.close()


def test_alphazero_requires_clonable_env(port_cluster):
    with pytest.raises(ValueError, match="get_state"):
        (AlphaZeroConfig().environment("CartPole-v1")
         .resources(device="cpu").debugging(seed=0)).build()


def test_alphazero_mcts_search_restores_env(port_cluster):
    """Simulations step the real env; after compute_action the env state
    must be exactly what it was."""
    algo = (AlphaZeroConfig().environment(ClonableCartPole)
            .training(num_simulations=10).resources(device="cpu")
            .debugging(seed=0)).build()
    obs, _ = algo._env.reset(seed=3)
    before = algo._env.get_state()
    a = algo.compute_action(obs)
    after = algo._env.get_state()
    assert a in (0, 1)
    np.testing.assert_allclose(before[0], after[0])
    assert before[1] == after[1]
    algo.stop()


def test_ranked_rewards_thresholding(port_cluster):
    algo = (AlphaZeroConfig().environment(ClonableCartPole)
            .training(ranked_rewards_percentile=50,
                      ranked_rewards_buffer=10)
            .resources(device="cpu").debugging(seed=0)).build()
    for r in [10.0, 20.0, 30.0, 40.0]:
        algo._ranked_reward(r)
    assert algo._ranked_reward(100.0) == 1.0   # above the median
    assert algo._ranked_reward(5.0) == -1.0    # below it
    algo.stop()


@pytest.mark.slow
def test_tuned_alphazero_learns(port_cluster):
    from ray_tpu_torch.rllib.tuned_examples import run_tuned_example
    out = run_tuned_example("cartpole-alphazero", device="cpu")
    assert out["passed"], out


def _write_dataset(path, episodes=50, seed=0):
    """Half heuristic, half random CartPole episodes, written by the
    port's JsonWriter."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.offline import JsonWriter
    w = JsonWriter(path)
    env = gym.make("CartPole-v1")
    rng = np.random.default_rng(seed)
    for e in range(episodes):
        kind = "h" if e < episodes // 2 else "r"
        obs, _ = env.reset(seed=e)
        rows = {k: [] for k in ("obs", "actions", "rewards", "new_obs",
                                "terminateds", "truncateds", "eps_id")}
        done, t = False, 0
        while not done and t < 200:
            if kind == "h" and rng.random() >= 0.1:
                a = 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0
            else:
                a = int(rng.integers(2))
            nxt, r, term, trunc, _ = env.step(a)
            for k, v in (("obs", np.asarray(obs, np.float32)),
                         ("actions", a), ("rewards", float(r)),
                         ("new_obs", np.asarray(nxt, np.float32)),
                         ("terminateds", float(term)),
                         ("truncateds", float(trunc)), ("eps_id", e)):
                rows[k].append(v)
            obs, done, t = nxt, term or trunc, t + 1
        w.write(SampleBatch({k: np.asarray(v) for k, v in rows.items()}))
    w.close()


def test_crr_requires_offline_input():
    with pytest.raises(ValueError, match="offline-only"):
        CRRConfig().environment("CartPole-v1").build()
    with pytest.raises(ValueError, match="weight_type"):
        cfg = CRRConfig().environment("CartPole-v1").offline_data(
            input_="/tmp/x")
        cfg.weight_type = "huber"
        cfg.build()


def test_crr_advantage_weights_binary(tmp_path, port_cluster):
    """Binary CRR weights are exactly 1[A>0] — between 0 and 1 in mean,
    and the losses stay finite through updates."""
    _write_dataset(str(tmp_path), episodes=8)
    algo = (CRRConfig().environment("CartPole-v1")
            .offline_data(input_=str(tmp_path))
            .training(num_train_batches_per_iteration=4)
            .resources(device="cpu").debugging(seed=0)).build()
    res = algo.train()
    assert 0.0 <= res["weight_mean"] <= 1.0
    assert np.isfinite(res["critic_loss"])
    assert np.isfinite(res["actor_loss"])


@pytest.mark.slow
def test_crr_learns_from_mixed_data(tmp_path, port_cluster):
    """Gate: a good CartPole policy (eval >= 150) out of half-random
    logged data within the budget."""
    _write_dataset(str(tmp_path))
    algo = (CRRConfig().environment("CartPole-v1")
            .offline_data(input_=str(tmp_path))
            .resources(device="cpu").debugging(seed=0)).build()
    best = 0.0
    for i in range(40):
        algo.train()
        if i % 10 == 9:
            best = max(best,
                       algo.evaluate()["episode_reward_mean"])
            if best >= 150.0:
                break
    assert best >= 150.0, best


def test_ddppo_requires_multiple_workers(port_cluster):
    with pytest.raises(ValueError, match="decentralized"):
        (DDPPOConfig().environment("CartPole-v1")
         .rollouts(num_rollout_workers=1).resources(device="cpu")
         .debugging(seed=0)).build()


def test_ddppo_flat_roundtrip():
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(4), torch.zeros(())]}
    vec, shapes, treedef = ddppo._flat(tree)
    assert vec.shape == (11,)
    back = ddppo._unflat(vec, shapes, treedef)
    for x, y in zip(flat_leaves(tree), flat_leaves(back)):
        np.testing.assert_allclose(x.numpy(), y.numpy())


def test_ddppo_workers_stay_bit_synchronized(port_cluster):
    """The DDPPO invariant: identical init + identical averaged
    gradients -> identical parameters on every worker, with no central
    learner shipping weights."""
    algo = (DDPPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2)
            .training(num_sgd_iter=2, sgd_minibatch_size=128)
            .resources(device="cpu").debugging(seed=0)).build()
    algo.train()
    algo.train()
    w = [ray_tpu_torch.get(wk.get_weights.remote())
         for wk in algo.workers.remote_workers]
    for a, b in zip(flat_leaves(w[0]), flat_leaves(w[1])):
        np.testing.assert_allclose(a, b, atol=1e-7)
    algo.stop()


@pytest.mark.slow
def test_tuned_ddppo_learns(port_cluster):
    from ray_tpu_torch.rllib.tuned_examples import run_tuned_example
    out = run_tuned_example("cartpole-ddppo", device="cpu")
    assert out["passed"], out


def test_alphazero_evaluate_uses_mcts(port_cluster):
    """evaluate() must run exploit-mode MCTS on the dict-obs env (the
    base policy path fits neither)."""
    algo = (AlphaZeroConfig().environment(ClonableCartPole)
            .training(num_simulations=5, max_episode_steps=30)
            .resources(device="cpu").debugging(seed=0)).build()
    out = algo.evaluate()
    assert out["episodes_this_eval"] == 3
    assert out["episode_reward_mean"] > 0.0
    algo.stop()


def test_alphazero_budget_exhausted_episode_scores(port_cluster):
    """An episode outliving max_episode_steps must rank by its ACTUAL
    accumulated score, not 0 (sparse envs pay only at termination)."""
    algo = (AlphaZeroConfig().environment(ClonableCartPole)
            .training(num_simulations=2, max_episode_steps=3,
                      episodes_per_iteration=1,
                      num_train_batches_per_iteration=0)
            .resources(device="cpu").debugging(seed=0)).build()
    res = algo.train()
    # CartPole survives >= 3 steps from reset: the 3-step budget ends
    # the episode, and the recorded return equals the running score.
    assert res["episode_reward_mean"] == pytest.approx(3.0)
    algo.stop()


def test_ddppo_restore_reaches_workers(port_cluster, tmp_path):
    """set_weights/restore on the driver must re-broadcast to the
    decentralized learners instead of being overwritten by worker 0."""
    cfg = (DDPPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=2)
           .training(num_sgd_iter=1, sgd_minibatch_size=128)
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build()
    algo.train()
    path = algo.save(str(tmp_path))
    saved = flat_leaves(algo.get_weights())
    algo.train()  # drift past the checkpoint
    algo.restore(path)
    algo.train()  # must train FROM the restored weights
    w0 = ray_tpu_torch.get(
        algo.workers.remote_workers[0].get_weights.remote())
    for a, b in zip(flat_leaves(algo.get_weights()), flat_leaves(w0)):
        np.testing.assert_allclose(a, b, atol=1e-7)
    assert any(not np.allclose(a, b)
               for a, b in zip(saved, flat_leaves(algo.get_weights())))
    algo.stop()


# -- across the packages ------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_alphazero_checkpoints_restore_across_the_packages(
        ray_start_regular, port_cluster, tmp_path, writer):
    """An AlphaZero ``algorithm_state.pkl`` trained and saved by one
    package restores in the other: the same weights, the same priors and
    value of every seeded observation."""
    kw = dict(num_simulations=4, max_episode_steps=20,
              episodes_per_iteration=8, train_batch_size=32,
              num_train_batches_per_iteration=2)
    jcfg = (jalpha_zero.AlphaZeroConfig().environment(JClonableCartPole)
            .training(**kw).debugging(seed=1))
    cfg = (AlphaZeroConfig().environment(ClonableCartPole).training(**kw)
           .resources(device="cpu").debugging(seed=1))
    src, dst = (jcfg, cfg) if writer == "jax" else (cfg, jcfg)
    saved = src.build()
    saved.train()
    path = saved.save(str(tmp_path))
    restored = dst.build()
    restored.restore(path)
    for a, b in zip(jax.tree_util.tree_leaves(saved.get_weights()),
                    jax.tree_util.tree_leaves(restored.get_weights())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    obs = np.random.default_rng(2).normal(size=(4, 4)).astype(np.float32)
    for vec in obs:
        want_p, want_v = saved._evaluate(vec, None)
        got_p, got_v = restored._evaluate(vec, None)
        np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-7)
        assert got_v == pytest.approx(want_v, rel=1e-6, abs=1e-7)
    saved.stop()
    restored.stop()


# -- the eight learners of this slice on the card ------------------------------

NEW_LEARNERS = ["AlphaStar", "AlphaZero", "CRR", "DDPPO", "Dreamer", "DT",
                "MAML", "MBMPO"]


@pytest.mark.parametrize("name", NEW_LEARNERS)
def test_the_learners_default_to_the_card(port_cluster, monkeypatch,
                                          tmp_path, name):
    """Built without a device, each learner asks for the CUDA card and,
    without one, raises rather than fall back to the CPU; so does the
    setup of one with parameters of its own (AlphaStar, AlphaZero,
    Dreamer), which builds them on ``config.device``."""
    import ray_tpu_torch.rllib as rllib
    from ray_tpu_torch.rllib.env.examples import (PointGoalEnv,
                                                  TwoPlayerRepeatedRPS)
    env = {"AlphaStar": TwoPlayerRepeatedRPS, "AlphaZero": ClonableCartPole,
           "Dreamer": PointGoalEnv, "MAML": PointGoalEnv,
           "MBMPO": PointGoalEnv}.get(name, "CartPole-v1")
    config = getattr(rllib, f"{name}Config")().environment(env)
    assert config.device is None
    if name in ("CRR", "DT"):
        config.offline_data(input_=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.build()
    if name in ("AlphaStar", "AlphaZero", "Dreamer"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bare(config.algo_class, config, None,
                 _env_creator=config.env_creator())
