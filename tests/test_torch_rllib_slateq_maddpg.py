"""The port's SlateQ and MADDPG against the JAX package's, and
``tests/test_rllib_slateq_maddpg.py``'s cases on the port.

Held to the JAX package from the same inputs (numpy seeds) and the
carried-over learner state (SlateQ's optimizer state in the layout of
optax's ``multi_transform`` of two Adams at different learning rates):
SlateQ's decomposed slate values over every slate, its choice-model
cross-entropy plus clicked-item TD loss and gradients, and two whole
``training_step``s (the same epsilon-greedy slates and RecSim rollouts
from the same seeds, the updates through both Adams, the hard target
sync); MADDPG's two whole ``training_step``s with 2 agents (the same
noisy joint rollouts, each agent's critic stepped before its actor, which
then steps against that critic, and the targets moved by ``(1 - tau) * t
+ tau * p``). Checkpoints written by either package restore in the
other. The learners run on the CPU (``.resources(device="cpu")``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rllib_pair import (GRAD_ATOL, GRAD_RTOL, LOSS_TOL, assert_state,
                               bare, carry, closure, one_torch_thread,
                               port_cluster)
from ray_tpu.rllib import MADDPGConfig as JMADDPGConfig
from ray_tpu.rllib import SlateQConfig as JSlateQConfig
from ray_tpu.rllib.algorithms import maddpg as jmaddpg
from ray_tpu.rllib.algorithms import slateq as jslateq
from ray_tpu.rllib.env.examples import CooperativeNavEnv as JCooperativeNav
from ray_tpu.rllib.env.recsim import RecSimEnv as JRecSimEnv
from ray_tpu_torch.rllib import MADDPGConfig, SlateQConfig
from ray_tpu_torch.rllib.algorithms import maddpg, slateq
from ray_tpu_torch.rllib.env.examples import CooperativeNavEnv
from ray_tpu_torch.rllib.env.recsim import RecSimEnv
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor, named_leaves


def _t(a):
    return torch.from_numpy(np.array(a))


def _steps_match(jalgo, algo, steps=2, tol=1e-4):
    for _ in range(steps):
        want, got = jalgo.training_step(), algo.training_step()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                       err_msg=k)
        assert_state(algo, jalgo)


# -- SlateQ ----------------------------------------------------------------

def _slateq_pair():
    kw = dict(lr=1e-3, lr_choice_model=3e-3,
              fcnet_hiddens_per_candidate=(16, 8),
              rollout_steps_per_iteration=40,
              num_steps_sampled_before_learning_starts=32,
              train_batch_size=16, num_train_batches_per_iteration=5,
              target_network_update_freq=4, epsilon_timesteps=60)
    jcfg = (JSlateQConfig().environment(JRecSimEnv, env_config={"seed": 0})
            .training(**kw).debugging(seed=2))
    cfg = (SlateQConfig().environment(RecSimEnv, env_config={"seed": 0})
           .training(**kw).resources(device="cpu").debugging(seed=2))
    jalgo = bare(jslateq.SlateQ, jcfg, None,
                 _env_creator=lambda c: JRecSimEnv(c))
    algo = bare(slateq.SlateQ, cfg, None,
                _env_creator=lambda c: RecSimEnv(c))
    carry(jalgo, algo)
    return jalgo, algo


def _slate_rows(algo, n, seed):
    """A seeded replay minibatch in SlateQ's columns: clicks at every
    slate position and the null option (k), terminal rows among them."""
    rng = np.random.default_rng(seed)
    user = rng.dirichlet(np.full(algo.T, 0.5), n).astype(np.float32)
    docs = rng.random((n, algo.C, algo.doc_dim)).astype(np.float32)
    return {"user": user, "docs": docs,
            "slate": np.stack([rng.choice(algo.C, algo.k, replace=False)
                               for _ in range(n)]).astype(np.int32),
            "pick": rng.integers(0, algo.k + 1, (n, 1)).astype(np.int32),
            "rewards": rng.random((n, 1)).astype(np.float32),
            "dones": (rng.random((n, 1)) < 0.2).astype(np.float32),
            "next_user": rng.dirichlet(np.full(algo.T, 0.5), n).astype(
                np.float32),
            "next_docs": rng.random((n, algo.C, algo.doc_dim)).astype(
                np.float32)}


def test_slateq_slate_values_loss_and_gradients_match_jax():
    """The decomposed value of all 120 slates; the loss, its two parts and
    its gradients from the same parameters and target."""
    jalgo, algo = _slateq_pair()
    # A target apart from the parameters.
    rng = np.random.default_rng(3)
    jalgo._target = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            0, 0.05, np.shape(a)).astype(np.float32)), jalgo._target)
    carry(jalgo, algo)
    mb = _slate_rows(algo, 24, 4)
    want = np.asarray(jalgo._slate_values_jit(
        jalgo.params, jnp.asarray(mb["user"]), jnp.asarray(mb["docs"])))
    got = algo.slate_values(algo.params, _t(mb["user"]), _t(mb["docs"]))
    assert got.shape == (24, len(algo.slates)) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    jloss = closure(jalgo._update_jit)["loss_fn"]
    (wl, (wq, wc)), wg = jax.value_and_grad(jloss, has_aux=True)(
        jalgo.params, jalgo._target,
        {k: jnp.asarray(v) for k, v in mb.items()})
    gl, parts = algo._loss(algo.params, {k: as_tensor(v, "cpu")
                                         for k, v in mb.items()})
    leaves = list(named_leaves(algo.params).values())
    gg = torch.autograd.grad(gl, leaves)
    for g, w in ((gl, wl), (parts["q_loss"], wq),
                 (parts["choice_loss"], wc)):
        np.testing.assert_allclose(float(g.detach()), float(w),
                                   rtol=LOSS_TOL)
    for g, w in zip(gg, jax.tree_util.tree_leaves(wg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_slateq_training_steps_match_jax():
    """Two whole ``training_step``s: the same slates and clicks, ten
    updates through the two Adams of ``multi_transform`` (their states in
    optax's layout), a hard target sync every 4."""
    jalgo, algo = _slateq_pair()
    _steps_match(jalgo, algo)
    assert algo._grad_steps == jalgo._grad_steps == 10
    state = algo._opt_state
    assert int(state["q"][0]["count"]) == int(state["choice"][0]["count"]) \
        == 10


# -- MADDPG ----------------------------------------------------------------

def test_maddpg_training_steps_match_jax():
    """Two whole ``training_step``s with 2 agents: the same noisy joint
    actions and navigation rollouts, eight updates (each agent's critic,
    then its actor against the stepped critic; the targets by ``(1 - tau)
    * t + tau * p``), the losses and every parameter, target and Adam
    state."""
    kw = dict(actor_lr=1e-3, critic_lr=3e-3, tau=0.1,
              model={"fcnet_hiddens": [16]}, rollout_steps_per_iteration=40,
              num_steps_sampled_before_learning_starts=32,
              train_batch_size=16, num_train_batches_per_iteration=4,
              noise_timesteps=60)
    env_config = {"seed": 0, "n_agents": 2}
    jcfg = (JMADDPGConfig().environment(JCooperativeNav,
                                        env_config=env_config)
            .training(**kw).debugging(seed=5))
    cfg = (MADDPGConfig().environment(CooperativeNavEnv,
                                      env_config=env_config)
           .training(**kw).resources(device="cpu").debugging(seed=5))
    jalgo = bare(jmaddpg.MADDPG, jcfg, None,
                 _env_creator=lambda c: JCooperativeNav(c))
    algo = bare(maddpg.MADDPG, cfg, None,
                _env_creator=lambda c: CooperativeNavEnv(c))
    carry(jalgo, algo)
    _steps_match(jalgo, algo)
    assert [int(s[0]["count"]) for s in algo._a_states + algo._c_states] \
        == [8] * 4


# -- tests/test_rllib_slateq_maddpg.py on the port -------------------------

def test_recsim_choice_model_ground_truth():
    env = RecSimEnv({"seed": 0})
    env.reset(seed=0)
    slate = np.asarray([0, 1, 2])
    p = env.choice_probs(slate)
    assert p.shape == (env.slate_size + 1,)
    np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-6)
    # Conditional logit: the no-click option has constant score; an item
    # aligned with the user's interest gets a higher click prob.
    user, docs = env.split_obs(env._obs())
    scores = env.choice_beta * (docs[slate, :-1] @ user)
    order = np.argsort(scores)
    assert p[order[-1]] >= p[order[0]]


def test_recsim_action_space_contract():
    """MultiDiscrete slates: generic consumers can sample() (duplicates
    legal — the logit runs over the slate as presented); malformed
    slates raise."""
    env = RecSimEnv({"seed": 0})
    env.reset(seed=0)
    import gymnasium as gym
    assert isinstance(env.action_space, gym.spaces.MultiDiscrete)
    env.action_space.seed(0)
    env.step(env.action_space.sample())
    env.step([0, 0, 1])          # duplicate doc: allowed
    with pytest.raises(ValueError):
        env.step([0, 1])         # wrong slate size
    with pytest.raises(ValueError):
        env.step([0, 1, 99])     # out of range


def _slateq():
    return (SlateQConfig()
            .environment(RecSimEnv, env_config={"seed": 0})
            .resources(device="cpu")
            .debugging(seed=0)).build()


def test_slateq_decomposition_matches_manual(port_cluster):
    """Q(s, A) must equal sum_i P(click i|A) * Q_item(s, i) with the
    choice model's softmax over slate scores + the null logit."""
    from ray_tpu_torch.rllib.models.catalog import mlp_apply
    algo = _slateq()
    obs, _ = RecSimEnv({"seed": 5}).reset(seed=5)
    user, docs = algo._env.split_obs(np.asarray(obs, np.float32))
    with torch.no_grad():
        vals = algo.slate_values(algo.params, _t(user[None]),
                                 _t(docs[None]))[0].numpy()
    assert vals.shape == (len(algo.slates),)

    # Manual recompute for one slate.
    s = algo.slates[7]
    x = _t(np.concatenate([np.tile(user, (algo.k, 1)), docs[s]], -1))
    with torch.no_grad():
        q = mlp_apply(algo.params["q"], x)[:, 0].numpy()
        v = mlp_apply(algo.params["choice"], x)[:, 0].numpy()
    logits = np.concatenate([v, [algo.no_click_score]])
    e = np.exp(logits - logits.max())
    p = (e / e.sum())[:-1]
    np.testing.assert_allclose(vals[7], (p * q).sum(), rtol=1e-4)
    algo.stop()


def test_slateq_greedy_slate_is_valid(port_cluster):
    algo = _slateq()
    obs, _ = RecSimEnv({"seed": 3}).reset(seed=3)
    slate = algo.compute_slate(obs, 0.0)
    assert len(slate) == algo.k
    assert len(set(slate.tolist())) == algo.k
    assert all(0 <= d < algo.C for d in slate)
    algo.stop()


def _small(cfg):
    return cfg.training(rollout_steps_per_iteration=60,
                        num_steps_sampled_before_learning_starts=50,
                        num_train_batches_per_iteration=4)


def test_slateq_checkpoint_roundtrip(port_cluster, tmp_path):
    cfg = _small(SlateQConfig()
                 .environment(RecSimEnv, env_config={"seed": 0})
                 .resources(device="cpu")
                 .debugging(seed=0))
    algo = cfg.build()
    algo.train()
    path = algo.save(str(tmp_path))
    obs, _ = RecSimEnv({"seed": 9}).reset(seed=9)
    want = algo.compute_slate(obs, 0.0)
    algo.stop()
    algo2 = cfg.build()
    algo2.restore(path)
    got = algo2.compute_slate(obs, 0.0)
    np.testing.assert_array_equal(want, got)
    algo2.stop()


@pytest.mark.slow
def test_tuned_slateq_learns(port_cluster):
    """Learning gate: beat random slates (~14.1/episode) by a clear
    margin on the clickbait-knobbed RecSim env."""
    from ray_tpu_torch.rllib.tuned_examples import run_tuned_example
    out = run_tuned_example("recsim-slateq", device="cpu")
    assert out["passed"], out


def test_cooperative_nav_env_contract():
    env = CooperativeNavEnv({"seed": 0})
    obs, _ = env.reset(seed=0)
    assert set(obs) == {"a0", "a1"}
    acts = {a: np.zeros(2, np.float32) for a in obs}
    obs2, rewards, terms, truncs, _ = env.step(acts)
    # Shared team reward, equally split.
    assert rewards["a0"] == rewards["a1"]
    assert rewards["a0"] <= 0.0
    assert not terms["__all__"]
    for _ in range(env.horizon - 1):
        _, _, terms, _, _ = env.step(acts)
    assert terms["__all__"]


def _maddpg():
    return (MADDPGConfig()
            .environment(CooperativeNavEnv, env_config={"seed": 0})
            .resources(device="cpu")
            .debugging(seed=0)).build()


def test_maddpg_centralized_critic_shapes(port_cluster):
    algo = _maddpg()
    # Decentralized execution: per-agent actors map own obs -> own act.
    acts = algo.compute_actions(algo._obs, noise=0.0)
    for i, aid in enumerate(algo.agent_ids):
        assert acts[aid].shape == (algo.act_dims[i],)
        assert np.all(acts[aid] >= algo._act_lo[i] - 1e-6)
        assert np.all(acts[aid] <= algo._act_hi[i] + 1e-6)
    # Centralized training: critic input = joint obs ++ joint acts.
    joint = sum(algo.obs_dims) + sum(algo.act_dims)
    assert algo.params["critics"][0][0]["w"].shape[0] == joint
    algo.stop()


def test_maddpg_exploration_noise_decays(port_cluster):
    algo = _maddpg()
    s0 = algo._noise()
    algo._timesteps_total = algo.config.noise_timesteps
    assert algo._noise() == pytest.approx(algo.config.noise_final)
    assert s0 == pytest.approx(algo.config.noise_initial)
    algo.stop()


def test_maddpg_checkpoint_roundtrip(port_cluster, tmp_path):
    cfg = _small(MADDPGConfig()
                 .environment(CooperativeNavEnv, env_config={"seed": 0})
                 .resources(device="cpu")
                 .debugging(seed=0))
    algo = cfg.build()
    algo.train()
    path = algo.save(str(tmp_path))
    obs = algo._obs
    want = algo.compute_actions(obs, noise=0.0)
    algo.stop()
    algo2 = cfg.build()
    algo2.restore(path)
    got = algo2.compute_actions(obs, noise=0.0)
    for aid in want:
        np.testing.assert_allclose(want[aid], got[aid], atol=1e-5)
    algo2.stop()


@pytest.mark.slow
def test_tuned_maddpg_learns(port_cluster):
    """Learning gate: random joint policy ~= -66/episode on cooperative
    navigation; the centralized critics must lift the team past -45."""
    from ray_tpu_torch.rllib.tuned_examples import run_tuned_example
    out = run_tuned_example("spread-maddpg", device="cpu")
    assert out["passed"], out


# -- across the packages ---------------------------------------------------

def _greedy(algo, name):
    if name == "slateq":
        return [algo.compute_slate(RecSimEnv({"seed": s}).reset(seed=s)[0],
                                   0.0).tolist() for s in range(4)]
    obs = CooperativeNavEnv({"seed": 0}).reset(seed=3)[0]
    return algo.compute_actions(obs, noise=0.0)


@pytest.mark.parametrize("name", ["slateq", "maddpg"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_the_packages(ray_start_regular,
                                                 port_cluster, tmp_path,
                                                 name, writer):
    """A SlateQ or MADDPG ``algorithm_state.pkl`` trained and saved by one
    package restores in the other: the same weights and targets, the
    same greedy slates or actions."""
    if name == "slateq":
        jcfg = JSlateQConfig().environment(JRecSimEnv,
                                           env_config={"seed": 0})
        cfg = SlateQConfig().environment(RecSimEnv, env_config={"seed": 0})
    else:
        jcfg = JMADDPGConfig().environment(JCooperativeNav,
                                           env_config={"seed": 0})
        cfg = MADDPGConfig().environment(CooperativeNavEnv,
                                         env_config={"seed": 0})
    jcfg = _small(jcfg).debugging(seed=1)
    cfg = _small(cfg).resources(device="cpu").debugging(seed=1)
    src, dst = (jcfg, cfg) if writer == "jax" else (cfg, jcfg)
    saved = src.build()
    saved.train()
    path = saved.save(str(tmp_path))
    restored = dst.build()
    restored.restore(path)
    for a, b in zip(jax.tree_util.tree_leaves(saved.get_weights()),
                    jax.tree_util.tree_leaves(restored.get_weights())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want, got = _greedy(saved, name), _greedy(restored, name)
    if name == "slateq":
        assert got == want
    else:
        for aid in want:
            np.testing.assert_allclose(got[aid], want[aid], atol=1e-5)
    saved.stop()
    restored.stop()
