"""The port's replay-based learners against the JAX package's.

The replay buffers (copied) sample bit for bit as the JAX package's. DQN,
SAC, CQL and TD3 are held to the JAX package from the same state: the JAX
learner's parameters, targets, temperature and optax states carried over
by ``load_learner_state``, the same minibatch, and the noise the JAX
update draws from its key, drawn here from that key and handed to the
port's update as tensors. Held so: each loss and its gradients (the JAX
losses are the closures of the JAX algorithm's jitted update); DQN's
whole ``training_step`` from offline JSON (n-step rows, prioritized
replay, its priorities and soft target sync); SAC's three optimizers and
targets over several updates; TD3 on and off a policy-delay step; CQL's
penalty. Then ``tests/test_rllib.py``'s cases of these algorithms on the
port (held to the reference's own bars; the registry's lines wait for
``algorithms/registry.py``), and DQN and SAC checkpoints written by either
package restored in the other with the same greedy or mean action. The
learners run on the CPU (``.resources(device="cpu")``).
"""

import glob

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_rllib_pair import (GRAD_ATOL, GRAD_RTOL, LOSS_TOL, assert_state,
                               bare, carry, closure, grads_close,
                               one_torch_thread, port_cluster)
from _torch_rllib_pair import transitions as _transitions
from ray_tpu.rllib import DQNConfig as JDQNConfig
from ray_tpu.rllib import JsonWriter as JJsonWriter
from ray_tpu.rllib import SACConfig as JSACConfig
from ray_tpu.rllib import SampleBatch as JSampleBatch
from ray_tpu.rllib import TD3Config as JTD3Config
from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.algorithms import td3 as jtd3
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu.rllib.utils import replay_buffers as jreplay
from ray_tpu_torch.rllib import (CQLConfig, DQNConfig, PrioritizedReplayBuffer,
                                 ReplayBuffer, SACConfig, SampleBatch,
                                 TD3Config)
from ray_tpu_torch.rllib.algorithms import cql, dqn, sac, td3
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor
from ray_tpu_torch.rllib.utils.replay_buffers import n_step_transform

HIDDENS = [32, 32]


# -- the harness -----------------------------------------------------------

def _pair(jcls, cls, jcfg, cfg, obs_space, act_space, env=None):
    """The JAX algorithm and the port's, bare, the port's learner state
    carried over from the JAX one's."""
    creator = None if env is None else (lambda _c: gym.make(env))
    jpol = jmake_policy(jcfg.policy_config(), obs_space, act_space,
                        seed=jcfg.seed)
    pol = make_policy(cfg.policy_config(), obs_space, act_space,
                      seed=cfg.seed, device="cpu")
    jalgo = bare(jcls, jcfg, jpol, _env_creator=creator)
    algo = bare(cls, cfg, pol, _env_creator=creator)
    carry(jalgo, algo)
    return jalgo, algo


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _spaces(kind):
    if kind == "cartpole":
        return (gym.spaces.Box(-np.inf, np.inf, (4,), np.float32),
                gym.spaces.Discrete(2))
    return (gym.spaces.Box(-np.inf, np.inf, (3,), np.float32),
            gym.spaces.Box(-2.0, 2.0, (1,), np.float32))


def _write_offline(path, kind, seed, fragments=4, rows=96):
    """Offline JSON written by the JAX package's ``JsonWriter``."""
    writer = JJsonWriter(str(path))
    for i in range(fragments):
        writer.write(JSampleBatch(dict(_transitions(rows, kind,
                                                    seed + i))))
    writer.close()
    return str(path)


def _fill(jalgo, algo, batch):
    jalgo._buffer.add(JSampleBatch(dict(batch)))
    algo._buffer.add(SampleBatch(dict(batch)))


def _device_mb(mb):
    return {k: jnp.asarray(v) for k, v in mb.items()
            if k in ("obs", "new_obs", "actions", "rewards", "terminateds",
                     "weights", "n_step_discount")}


def _sac_noise(key, batch, act_dim, n_ood=None):
    """The noise the JAX SAC (and CQL) update draws from ``key``, split
    as it splits it: update -> (critic, actor); critic -> (target,
    penalty); penalty -> (rand, cur, next), each of the last two split
    into ``n_ood`` keys."""
    k1, k2 = jax.random.split(key)
    k_target, k_penalty = jax.random.split(k1)
    shape = (batch, act_dim)
    noise = {"target": jax.random.normal(k_target, shape),
             "actor": jax.random.normal(k2, shape)}
    if n_ood:
        k_rand, k_cur, k_next = jax.random.split(k_penalty, 3)
        noise["rand"] = jax.random.uniform(k_rand, (n_ood,) + shape)
        for name, k in (("cur", k_cur), ("next", k_next)):
            noise[name] = jnp.stack([jax.random.normal(kk, shape)
                                     for kk in jax.random.split(k, n_ood)])
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


# -- the replay buffers ------------------------------------------------------

def test_replay_buffers_sample_bit_equal():
    """The same rows in both packages' buffers of one seed: uniform and
    prioritized samples, weights and indexes bit for bit, also after a
    priority update and a ring overwrite."""
    batch = _transitions(300, "cartpole", 0)
    for cls, jcls, kw in ((ReplayBuffer, jreplay.ReplayBuffer, {}),
                          (PrioritizedReplayBuffer,
                           jreplay.PrioritizedReplayBuffer, {"beta": 0.5})):
        mine, ref = cls(capacity=256, seed=7), jcls(capacity=256, seed=7)
        mine.add(SampleBatch(dict(batch)))
        ref.add(JSampleBatch(dict(batch)))
        for _ in range(3):
            got, want = mine.sample(32, **kw), ref.sample(32, **kw)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
            if kw:
                pri = np.random.default_rng(1).normal(size=32)
                mine.update_priorities(got["batch_indexes"], pri)
                ref.update_priorities(want["batch_indexes"], pri)


def test_n_step_transform_is_bit_equal():
    batch = _transitions(200, "cartpole", 3)
    got = n_step_transform(SampleBatch(dict(batch)), 3, 0.97)
    want = jreplay.n_step_transform(JSampleBatch(dict(batch)), 3, 0.97)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- DQN ---------------------------------------------------------------------

@pytest.mark.parametrize("dueling,double_q", [(False, True), (True, True),
                                              (True, False)],
                         ids=["double", "dueling-double", "dueling-single"])
def test_dqn_loss_and_gradients_match_jax(dueling, double_q):
    """The Huber TD loss, its TD errors and gradients, with PER weights
    and n-step discounts, from the same parameters and target."""
    kw = dict(dueling=dueling, double_q=double_q,
              model={"fcnet_hiddens": HIDDENS})
    jcfg = JDQNConfig().training(**kw).debugging(seed=2)
    cfg = DQNConfig().training(**kw).debugging(seed=2)
    spaces = _spaces("cartpole")
    jpol = jmake_policy(jcfg.policy_config(), *spaces, seed=2)
    pol = make_policy(cfg.policy_config(), *spaces, seed=2, device="cpu")
    pol.set_weights(jpol.get_weights())
    rng = np.random.default_rng(4)
    target = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, np.shape(a)).astype(
            np.float32), jpol.params)
    mb = dict(_transitions(64, "cartpole", 5))
    mb["weights"] = rng.uniform(0.2, 1.0, 64).astype(np.float32)
    mb["n_step_discount"] = rng.choice([0.99, 0.98, 0.97], 64).astype(
        np.float32)
    jloss = jdqn.DQN._build_loss_fn(None, jpol, jcfg)
    (want, want_td), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jpol.params, jax.tree.map(jnp.asarray, target), _device_mb(mb),
        jax.random.PRNGKey(0))
    loss_fn = dqn.make_dqn_loss(pol, cfg.gamma, cfg.double_q)
    got, got_td = loss_fn(pol.params, _tensors(target),
                          {k: as_tensor(v, "cpu")
                           for k, v in _device_keys(mb).items()})
    got_g = torch.autograd.grad(got, _leaves(pol.params))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(got_td.detach().numpy(), np.asarray(want_td),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    grads_close(got_g, want_g)


def _tensors(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _device_keys(mb):
    return {k: v for k, v in mb.items()
            if k in ("obs", "new_obs", "actions", "rewards", "terminateds",
                     "weights", "n_step_discount")}


@pytest.mark.parametrize("prioritized", [True, False], ids=["per", "uniform"])
def test_dqn_training_step_matches_jax(tmp_path, prioritized):
    """Two whole offline ``training_step``s of DQN in both packages from
    the same carried-over state: the JSON batches through 3-step returns
    into the buffer, 8 minibatches an iteration with their priorities, a
    soft target sync every 3 gradient steps (tau 0.5); the results, the
    priorities and the whole learner state after each."""
    path = _write_offline(tmp_path / "exp", "cartpole", 11)
    kw = dict(train_batch_size=32, num_steps_sampled_before_learning_starts=64,
              num_train_batches_per_iteration=8, target_network_update_freq=3,
              tau=0.5, n_step=3, dueling=True, prioritized_replay=prioritized,
              lr=1e-3, model={"fcnet_hiddens": HIDDENS})
    jcfg = (JDQNConfig().training(**kw).offline_data(input_=path)
            .debugging(seed=6))
    cfg = (DQNConfig().training(**kw).offline_data(input_=path)
           .debugging(seed=6))
    jalgo, algo = _pair(jdqn.DQN, dqn.DQN, jcfg, cfg, *_spaces("cartpole"))
    for _ in range(2):
        want, got = jalgo.training_step(), algo.training_step()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL,
                                       err_msg=k)
        if prioritized:
            np.testing.assert_allclose(algo._buffer._priorities,
                                       jalgo._buffer._priorities,
                                       rtol=1e-4, atol=1e-6)
        assert_state(algo, jalgo)
    assert algo._grad_steps == jalgo._grad_steps == 16
    assert algo.get_weights()["epsilon"] == jalgo.get_weights()["epsilon"]


# -- SAC and CQL -----------------------------------------------------------

# XLA's CPU tanh is off by up to 4 ulp where torch's is off by half of one
# (measured on this host over 1e5 normal draws of scale 3). On a saturated
# row of the squashed Gaussian (|pre_tanh| beyond ~4) the log-probability's
# correction log(1 - a^2 + 1e-6) turns that into differences up to ~1e-1,
# and Adam into steps of lr. The tests of whole updates therefore start
# from the JAX learner's state with its actor head scaled by HEAD_SCALE,
# which keeps |pre_tanh| below ~3; the loss test keeps the unscaled state
# and bounds each row by the two tanhs' measured errors.
HEAD_SCALE = 0.25


def _sac_pair(tmp_path=None, cls=None, head_scale=None, **kw):
    kw = dict(train_batch_size=48, lr=1e-3, critic_lr=2e-3, alpha_lr=3e-3,
              tau=0.05, model={"fcnet_hiddens": HIDDENS}, **kw)
    if cls is None:
        jcfg = JSACConfig().training(**kw).debugging(seed=3)
        cfg = SACConfig().training(**kw).debugging(seed=3)
        jcls, pcls = jsac.SAC, sac.SAC
    else:
        path = _write_offline(tmp_path / "exp", "pendulum", 21)
        jcfg = (jcql.CQLConfig().training(**kw).offline_data(input_=path)
                .debugging(seed=3))
        cfg = (CQLConfig().training(**kw).offline_data(input_=path)
               .debugging(seed=3))
        jcls, pcls = jcql.CQL, cql.CQL
    jalgo, algo = _pair(jcls, pcls, jcfg, cfg, *_spaces("pendulum"),
                        env="Pendulum-v1")
    if head_scale is not None:
        head = jalgo.local_policy.params["head"]
        jalgo.local_policy.params["head"] = [
            {k: v * head_scale for k, v in layer.items()} for layer in head]
        carry(jalgo, algo)
    if cls is None:
        _fill(jalgo, algo, _transitions(256, "pendulum", 9))
    return jalgo, algo


def _sac_mb(algo, jalgo, n):
    mb, jmb = algo._buffer.sample(n), jalgo._buffer.sample(n)
    for k in jmb:
        np.testing.assert_array_equal(mb[k], jmb[k])
    return mb


def test_sac_losses_and_gradients_match_jax():
    """The critic, actor and temperature losses of the JAX update's
    closures against the port's, with the noise of one key."""
    jalgo, algo = _sac_pair()
    mb = _sac_mb(algo, jalgo, 48)
    fns = closure(jalgo._update_jit)
    key = jax.random.PRNGKey(5)
    noise = _sac_noise(key, 48, 1)
    k1, k2 = jax.random.split(key)
    jmb, tmb = _device_mb(mb), {k: as_tensor(v, "cpu")
                                for k, v in _device_keys(mb).items()}
    want, want_g = jax.value_and_grad(fns["critic_loss"])(
        jalgo._q_params, jalgo._q_target, jalgo.local_policy.params,
        jalgo._log_alpha, jmb, k1)
    got, _ = algo._critic_loss(algo._q_params, tmb, noise)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    grads_close(torch.autograd.grad(got, _leaves(algo._q_params)), want_g)
    (want, want_logp), want_g = jax.value_and_grad(
        fns["actor_loss"], has_aux=True)(
            jalgo.local_policy.params, jalgo._q_params, jalgo._log_alpha,
            jmb, k2)
    got, aux = algo._actor_loss(algo.local_policy.params, tmb, noise)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    # Both gradients and log-probabilities go through a = tanh(pre) and
    # 1 - a^2 (HEAD_SCALE's note): on a saturated row 1 - a^2 carries a
    # relative error of 2|a| da / (1 - a^2), so each row's log-probability
    # and share of the gradient are held to PR 17's bounds plus that error,
    # with da the two tanhs' measured errors here.
    pol = algo.local_policy
    mu, log_std = pol.dist_params(pol.params, tmb["obs"])
    pre = mu + torch.exp(log_std) * noise["actor"]
    pre_np = pre.detach().numpy()
    exact = np.tanh(pre_np.astype(np.float64))
    da = (np.abs(np.asarray(jnp.tanh(pre_np)) - exact)
          + np.abs(np.tanh(pre_np) - exact))
    a = pre_np.astype(np.float64)
    a = np.tanh(a)
    rel = 2 * np.abs(a) * da / (1 - a ** 2 + 1e-6)  # [B, A]
    gap = np.abs(aux["logp"].detach().numpy() - np.asarray(want_logp))
    bound = LOSS_TOL * (1 + np.abs(np.asarray(want_logp))) + rel.sum(-1)
    assert (gap <= bound).all(), (gap - bound).max()
    leaves = _leaves(pol.params)
    x = pre.detach().requires_grad_()
    a_t = torch.tanh(x)
    logp = (-0.5 * (noise["actor"] ** 2 + 2 * log_std.detach()
                    + np.log(2 * np.pi))).sum(-1) - torch.log(
                        1 - a_t ** 2 + 1e-6).sum(-1)
    act = pol.scale(a_t)
    q = torch.minimum(sac.q_apply(algo._q_params["q1"], tmb["obs"], act),
                      sac.q_apply(algo._q_params["q2"], tmb["obs"], act))
    alpha = torch.exp(algo._log_alpha).detach()
    dl_dpre = torch.autograd.grad((alpha * logp - q).mean(), x)[0].numpy()
    slack = [np.zeros(t.shape, np.float32) for t in leaves]
    for r, j in zip(*np.nonzero(rel * np.abs(dl_dpre) > 1e-12)):
        for acc, g in zip(slack, torch.autograd.grad(
                pre[r, j], leaves, retain_graph=True, allow_unused=True,
                materialize_grads=True)):
            acc += rel[r, j] * abs(dl_dpre[r, j]) * np.abs(g.numpy())
    for g, w, extra in zip(torch.autograd.grad(got, leaves),
                           _leaves(want_g), slack):
        g, w = g.numpy(), np.asarray(w)
        assert (np.abs(g - w) <= GRAD_ATOL + GRAD_RTOL * np.abs(w)
                + extra).all(), np.abs(g - w).max()


def test_sac_updates_match_jax():
    """Four updates through ``_train_on_buffer`` in both packages, the
    port's noise drawn from the JAX algorithm's key chain: the metrics of
    the last and the actor, critics, targets, ``log_alpha`` and the three
    Adam states after each."""
    jalgo, algo = _sac_pair(head_scale=HEAD_SCALE)
    key = [jalgo._key]

    def jax_noise(batch):
        key[0], sub = jax.random.split(key[0])
        return _sac_noise(sub, batch, algo.local_policy.act_dim)

    algo.draw_noise = jax_noise
    for _ in range(2):
        want = jalgo._train_on_buffer(2)
        got = algo._train_on_buffer(2)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=LOSS_TOL, err_msg=k)
        assert_state(algo, jalgo)


def test_cql_penalty_and_update_match_jax(tmp_path):
    """CQL's conservative penalty (uniform and policy proposals at s and
    s', logsumexp over 3n) and its gradient, and two whole CQL updates,
    from the JAX key's noise."""
    jalgo, algo = _sac_pair(tmp_path, cls="cql", head_scale=HEAD_SCALE,
                            min_q_weight=5.0, num_ood_actions=3)
    assert algo._dataset_size == jalgo._dataset_size == 384
    mb = _sac_mb(algo, jalgo, 48)
    fns = closure(closure(jalgo._update_jit)["critic_loss"])
    key = jax.random.PRNGKey(8)
    k_penalty = jax.random.split(jax.random.split(key)[0])[1]
    noise = _sac_noise(key, 48, 1, n_ood=3)
    jmb = _device_mb(mb)
    want, want_g = jax.value_and_grad(
        lambda q: jalgo._conservative_penalty(
            fns["q_apply"], q, jalgo.local_policy.params, jmb, k_penalty))(
                jalgo._q_params)
    tmb = {k: as_tensor(v, "cpu") for k, v in _device_keys(mb).items()}
    got = algo._conservative_penalty(algo._q_params,
                                     algo.local_policy.params, tmb, noise)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    grads_close(torch.autograd.grad(got, _leaves(algo._q_params)), want_g)

    for i in range(2):
        sub = jax.random.PRNGKey(20 + i)
        mb = _sac_mb(algo, jalgo, 48)
        out = jalgo._update_jit(
            jalgo.local_policy.params, jalgo._q_params, jalgo._q_target,
            jalgo._log_alpha, jalgo._actor_state, jalgo._critic_state,
            jalgo._alpha_state, _device_mb(mb), sub)
        (jalgo.local_policy.params, jalgo._q_params, jalgo._q_target,
         jalgo._log_alpha, jalgo._actor_state, jalgo._critic_state,
         jalgo._alpha_state, want) = out
        got = algo.learn_on_batch(mb, _sac_noise(sub, 48, 1, n_ood=3))
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4,
                                       atol=LOSS_TOL, err_msg=k)
        assert_state(algo, jalgo)


# -- TD3 ---------------------------------------------------------------------

def test_td3_losses_and_updates_match_jax():
    """TD3 with 3-step rows and prioritized replay: the critic loss (with
    target smoothing noise from the JAX key), its TD errors and
    gradients, the actor loss; then four updates across two policy-delay
    steps and two steps off them: losses, priorities and the whole state."""
    kw = dict(train_batch_size=48, lr=1e-3, critic_lr=2e-3, tau=0.05,
              policy_delay=2, prioritized_replay=True, n_step=3,
              model={"fcnet_hiddens": HIDDENS})
    jcfg = JTD3Config().training(**kw).debugging(seed=4)
    cfg = TD3Config().training(**kw).debugging(seed=4)
    jalgo, algo = _pair(jtd3.TD3, td3.TD3, jcfg, cfg, *_spaces("pendulum"),
                        env="Pendulum-v1")
    batch = _transitions(256, "pendulum", 13)
    _fill(jalgo, algo, n_step_transform(batch, 3, cfg.gamma))
    fns = closure(jalgo._update_jit)
    mb = jalgo._buffer.sample(48, beta=0.4)
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (48, 1))))
    jmb = _device_mb(mb)
    tmb = {k: as_tensor(v, "cpu") for k, v in _device_keys(mb).items()}
    (want, want_td), want_g = jax.value_and_grad(
        fns["critic_loss"], has_aux=True)(
            jalgo._q_params, jalgo._q_target, jalgo._actor_target, jmb, key)
    got, aux = algo._critic_loss(algo._q_params, tmb, noise)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(aux["td"].detach().numpy(),
                               np.asarray(want_td), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    grads_close(torch.autograd.grad(got, _leaves(algo._q_params)), want_g)
    want, want_g = jax.value_and_grad(fns["actor_loss"])(
        jalgo.local_policy.params, jalgo._q_params, jmb)
    got, _ = algo._actor_loss(algo.local_policy.params, tmb)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    grads_close(torch.autograd.grad(got, _leaves(algo.local_policy.params)),
                 want_g)

    algo._buffer.sample(48, beta=0.4)  # the sample above, on the port's
    for i in range(4):
        mb, jmb_np = (algo._buffer.sample(48, beta=0.4),
                      jalgo._buffer.sample(48, beta=0.4))
        np.testing.assert_array_equal(mb["batch_indexes"],
                                      jmb_np["batch_indexes"])
        sub = jax.random.PRNGKey(40 + i)
        jalgo._updates += 1
        do_actor = jnp.bool_(jalgo._updates % jcfg.policy_delay == 0)
        (jalgo.local_policy.params, jalgo._actor_target, jalgo._q_params,
         jalgo._q_target, jalgo._actor_state, jalgo._critic_state, td,
         want) = jalgo._update_jit(
            jalgo.local_policy.params, jalgo._actor_target, jalgo._q_params,
            jalgo._q_target, jalgo._actor_state, jalgo._critic_state,
            _device_mb(jmb_np), sub, do_actor)
        jalgo._buffer.update_priorities(jmb_np["batch_indexes"],
                                        np.asarray(td))
        got = algo.learn_on_batch(mb, torch.from_numpy(
            np.array(jax.random.normal(sub, (48, 1)))))
        assert (got["actor_loss"] != 0.0) == bool(do_actor)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4,
                                       atol=LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(got["td"], np.asarray(td), rtol=1e-4,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(algo._buffer._priorities,
                                   jalgo._buffer._priorities, rtol=1e-4,
                                   atol=1e-6)
        assert_state(algo, jalgo)


# -- tests/test_rllib.py's cases on the port -------------------------------

def test_replay_buffers():
    rb = ReplayBuffer(capacity=10, seed=0)
    rb.add(SampleBatch({"obs": np.arange(15), "r": np.arange(15.0)}))
    assert len(rb) == 10
    s = rb.sample(4)
    assert len(s) == 4
    prb = PrioritizedReplayBuffer(capacity=10, seed=0)
    prb.add(SampleBatch({"obs": np.arange(10), "r": np.arange(10.0)}))
    s = prb.sample(4, beta=0.4)
    assert "weights" in s and "batch_indexes" in s
    prb.update_priorities(s["batch_indexes"], np.ones(4) * 5)


def test_dqn_cartpole_smoke(port_cluster):
    config = (DQNConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=1, rollout_fragment_length=200)
              .training(train_batch_size=32,
                        num_steps_sampled_before_learning_starts=200,
                        num_train_batches_per_iteration=8,
                        target_network_update_freq=16,
                        epsilon_timesteps=1000)
              .resources(device="cpu")
              .debugging(seed=3))
    algo = config.build()
    losses = []
    for _ in range(4):
        res = algo.train()
        if np.isfinite(res["loss"]):
            losses.append(res["loss"])
    assert losses and all(np.isfinite(l) for l in losses)
    assert res["replay_buffer_size"] >= 600
    assert res["gradient_steps_total"] > 0
    assert res["epsilon"] < 1.0  # schedule annealing
    # greedy action is a valid CartPole action
    a = algo.compute_single_action(np.zeros(4, np.float32))
    assert a in (0, 1)
    # checkpoint roundtrip keeps behavior
    path = algo.save()
    algo2 = (DQNConfig().environment("CartPole-v1")
             .rollouts(num_rollout_workers=1).resources(device="cpu")
             .build())
    algo2.restore(path)
    assert algo2.compute_single_action(np.zeros(4, np.float32)) == a
    algo.stop()
    algo2.stop()


def test_dqn_prioritized_replay(port_cluster):
    config = (DQNConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=1, rollout_fragment_length=150)
              .training(prioritized_replay=True, train_batch_size=32,
                        num_steps_sampled_before_learning_starts=100,
                        num_train_batches_per_iteration=4)
              .resources(device="cpu")
              .debugging(seed=5))
    algo = config.build()
    res = algo.train()
    assert np.isfinite(res["loss"])
    algo.stop()


def test_sac_pendulum_smoke(port_cluster):
    config = (SACConfig()
              .environment("Pendulum-v1")
              .rollouts(num_rollout_workers=1, rollout_fragment_length=200)
              .training(train_batch_size=64,
                        num_steps_sampled_before_learning_starts=100,
                        num_train_batches_per_iteration=4)
              .resources(device="cpu")
              .debugging(seed=11))
    algo = config.build()
    for _ in range(2):
        res = algo.train()
    for key in ("critic_loss", "actor_loss", "alpha_loss", "alpha"):
        assert np.isfinite(res[key]), (key, res)
    # mean action inside bounds
    a = algo.compute_single_action(np.zeros(3, np.float32))
    assert (-2.0 <= np.asarray(a)).all() and (np.asarray(a) <= 2.0).all()
    algo.stop()


def test_dqn_offline_input(port_cluster, tmp_path):
    """DQN trains from JSON offline data written by rollout workers."""
    out_dir = str(tmp_path / "offline")
    gen = (DQNConfig()
           .environment("CartPole-v1")
           .rollouts(num_rollout_workers=1, rollout_fragment_length=300)
           .offline_data(output=out_dir)
           .resources(device="cpu")
           .debugging(seed=4)).build()
    gen.train()
    gen.stop()
    assert glob.glob(out_dir + "/*.json")
    offline = (DQNConfig()
               .environment("CartPole-v1")
               .rollouts(num_rollout_workers=1)
               .offline_data(input_=out_dir)
               .training(train_batch_size=32,
                         num_steps_sampled_before_learning_starts=64,
                         num_train_batches_per_iteration=4)
               .resources(device="cpu")
               .debugging(seed=6)).build()
    res = offline.train()
    assert np.isfinite(res["loss"])
    offline.stop()


def test_td3_pendulum_smoke(port_cluster):
    config = (TD3Config()
              .environment("Pendulum-v1")
              .rollouts(num_rollout_workers=1, rollout_fragment_length=200)
              .training(train_batch_size=64,
                        num_steps_sampled_before_learning_starts=100,
                        num_train_batches_per_iteration=8)
              .resources(device="cpu")
              .debugging(seed=21))
    algo = config.build()
    for _ in range(2):
        res = algo.train()
    assert np.isfinite(res["critic_loss"])
    assert np.isfinite(res["actor_loss"])
    a = algo.compute_single_action(np.zeros(3, np.float32))
    assert (-2.0 <= np.asarray(a)).all() and (np.asarray(a) <= 2.0).all()
    algo.stop()


def test_ddpg_pendulum_smoke(port_cluster):
    from ray_tpu_torch.rllib import DDPGConfig
    config = (DDPGConfig()
              .environment("Pendulum-v1")
              .rollouts(num_rollout_workers=1, rollout_fragment_length=200)
              .training(train_batch_size=64,
                        num_steps_sampled_before_learning_starts=100,
                        num_train_batches_per_iteration=8)
              .resources(device="cpu")
              .debugging(seed=22))
    assert config.policy_delay == 1 and config.target_noise == 0.0
    algo = config.build()
    for _ in range(2):
        res = algo.train()
    assert np.isfinite(res["critic_loss"])
    # actor updates every step (policy_delay=1) => loss nonzero
    assert res["actor_loss"] != 0.0
    algo.stop()


def test_simpleq_cartpole_smoke(port_cluster):
    from ray_tpu_torch.rllib import SimpleQConfig
    config = (SimpleQConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=1, rollout_fragment_length=200)
              .training(train_batch_size=32,
                        num_steps_sampled_before_learning_starts=100,
                        num_train_batches_per_iteration=4,
                        target_network_update_freq=8)
              .resources(device="cpu")
              .debugging(seed=23))
    assert config.double_q is False
    algo = config.build()
    for _ in range(2):
        res = algo.train()
    assert np.isfinite(res["loss"])
    algo.stop()


def test_cql_pendulum_offline(port_cluster, tmp_path):
    out_dir = str(tmp_path / "exp")
    gen = (SACConfig()
           .environment("Pendulum-v1")
           .rollouts(num_rollout_workers=1, rollout_fragment_length=500)
           .offline_data(output=out_dir)
           .resources(device="cpu")
           .debugging(seed=3)).build()
    gen.train()
    gen.stop()
    cql_algo = (CQLConfig()
                .environment("Pendulum-v1")
                .offline_data(input_=out_dir)
                .training(train_batch_size=64, min_q_weight=5.0,
                          num_ood_actions=2,
                          num_train_batches_per_iteration=4)
                .resources(device="cpu")
                .debugging(seed=4)).build()
    for _ in range(2):
        res = cql_algo.train()
    assert np.isfinite(res["critic_loss"])
    assert np.isfinite(res["actor_loss"])
    assert res["dataset_size"] >= 500
    # action in bounds
    a = cql_algo.compute_single_action(np.zeros(3, np.float32))
    assert (-2.0 <= np.asarray(a)).all() and (np.asarray(a) <= 2.0).all()
    cql_algo.stop()
    with pytest.raises(ValueError):
        (CQLConfig().environment("Pendulum-v1")).build()


def test_n_step_transform():
    batch = SampleBatch({
        SampleBatch.REWARDS: np.asarray([1.0, 1.0, 1.0, 5.0],
                                        np.float32),
        SampleBatch.TERMINATEDS: np.asarray([0.0, 0.0, 1.0, 0.0],
                                            np.float32),
        SampleBatch.TRUNCATEDS: np.zeros(4, np.float32),
        SampleBatch.EPS_ID: np.asarray([0, 0, 0, 1]),
        SampleBatch.NEXT_OBS: np.arange(4.0)[:, None],
    })
    out = n_step_transform(batch, n=3, gamma=0.5)
    # t=0: 1 + .5*1 + .25*1 (stops at terminal t=2), new_obs=2, term=1
    np.testing.assert_allclose(out[SampleBatch.REWARDS],
                               [1.75, 1.5, 1.0, 5.0])
    np.testing.assert_allclose(out[SampleBatch.TERMINATEDS],
                               [1, 1, 1, 0])
    np.testing.assert_allclose(out[SampleBatch.NEXT_OBS][:, 0],
                               [2, 2, 2, 3])  # never crosses eps seam
    # per-row bootstrap discount gamma^k for the k steps actually covered
    np.testing.assert_allclose(out["n_step_discount"],
                               [0.125, 0.25, 0.5, 0.5])


def test_dueling_dqn_smoke(port_cluster):
    config = (DQNConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=1, rollout_fragment_length=200)
              .training(train_batch_size=32, dueling=True, n_step=2,
                        num_steps_sampled_before_learning_starts=100,
                        num_train_batches_per_iteration=4)
              .resources(device="cpu")
              .debugging(seed=31))
    algo = config.build()
    # dueling params really have the two streams
    assert "value_head" in algo.local_policy.params
    assert "adv_head" in algo.local_policy.params
    for _ in range(2):
        res = algo.train()
    assert np.isfinite(res["loss"])
    a = algo.compute_single_action(np.zeros(4, np.float32))
    assert a in (0, 1)
    algo.stop()


def test_apex_dqn_per_worker_epsilons(port_cluster):
    from ray_tpu_torch.rllib import ApexDQNConfig
    config = (ApexDQNConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=3, rollout_fragment_length=100)
              .training(train_batch_size=32,
                        num_steps_sampled_before_learning_starts=150,
                        num_train_batches_per_iteration=4)
              .resources(device="cpu")
              .debugging(seed=33))
    algo = config.build()
    res = algo.train()
    # The exploration ladder: every worker keeps a distinct FIXED epsilon
    # (visible in QPolicy.get_weights) despite central weight broadcasts.
    weights = ray_tpu_torch.get([w.get_weights.remote()
                                 for w in algo.workers.remote_workers])
    # QPolicy.get_weights returns {"params", "epsilon"}
    eps = sorted(w["epsilon"] for w in weights)
    assert len(set(round(e, 6) for e in eps)) == 3, eps
    assert eps[0] < 0.01 and eps[-1] == pytest.approx(0.4)
    for _ in range(2):
        res = algo.train()
    assert np.isfinite(res["loss"])
    assert res["replay_buffer_size"] > 0
    algo.stop()


# -- across the packages ---------------------------------------------------

@pytest.mark.parametrize("algo_name", ["dqn", "sac"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_the_packages(ray_start_regular,
                                                 port_cluster, tmp_path,
                                                 algo_name, writer):
    """A DQN or SAC ``algorithm_state.pkl`` trained and saved by one
    package restores in the other: the same iteration and greedy (DQN)
    or mean (SAC) actions."""
    if algo_name == "dqn":
        env, obs_dim = "CartPole-v1", 4
        kw = dict(train_batch_size=32,
                  num_steps_sampled_before_learning_starts=100,
                  num_train_batches_per_iteration=4,
                  model={"fcnet_hiddens": HIDDENS})
        jcfg, cfg = JDQNConfig(), DQNConfig()
    else:
        env, obs_dim = "Pendulum-v1", 3
        kw = dict(train_batch_size=32,
                  num_steps_sampled_before_learning_starts=100,
                  num_train_batches_per_iteration=2,
                  model={"fcnet_hiddens": HIDDENS})
        jcfg, cfg = JSACConfig(), SACConfig()
    jcfg = (jcfg.environment(env).rollouts(num_rollout_workers=1,
                                           rollout_fragment_length=128)
            .training(**kw).debugging(seed=4))
    cfg = (cfg.environment(env).rollouts(num_rollout_workers=1,
                                         rollout_fragment_length=128)
           .training(**kw).resources(device="cpu").debugging(seed=4))
    src, dst = ((jcfg, cfg) if writer == "jax" else (cfg, jcfg))
    saved = src.build()
    for _ in range(2):
        saved.train()
    path = saved.save(str(tmp_path))
    restored = dst.build()
    restored.restore(path)
    assert restored.iteration == saved.iteration == 2
    obs = np.random.default_rng(0).normal(size=(6, obs_dim)).astype(
        np.float32)
    for o in obs:
        a, b = (restored.compute_single_action(o),
                saved.compute_single_action(o))
        if algo_name == "dqn":
            assert a == b
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    saved.stop()
    restored.stop()


# -- the learners' device ----------------------------------------------------

@pytest.mark.parametrize("name", [
    "DQN", "SimpleQ", "ApexDQN", "SAC", "CQL", "TD3", "DDPG", "A2C", "A3C",
    "PG", "Impala", "APPO", "BC", "MARWIL", "ES", "ARS", "Rainbow", "R2D2",
    "QMix", "MADDPG", "SlateQ"])
def test_the_learners_default_to_the_card(port_cluster, monkeypatch,
                                          tmp_path, name):
    """Built without a device, every learner asks for the CUDA card and,
    without one, raises rather than fall back to the CPU; so does the
    setup of a learner with parameters of its own (QMix, MADDPG,
    SlateQ), which it builds on ``config.device``."""
    import ray_tpu_torch.rllib as rllib
    from ray_tpu_torch.rllib.env.examples import (CoordinationGameEnv,
                                                  CooperativeNavEnv)
    from ray_tpu_torch.rllib.env.recsim import RecSimEnv
    env = {"SAC": "Pendulum-v1", "CQL": "Pendulum-v1", "TD3": "Pendulum-v1",
           "DDPG": "Pendulum-v1", "QMix": CoordinationGameEnv,
           "MADDPG": CooperativeNavEnv, "SlateQ": RecSimEnv}.get(
               name, "CartPole-v1")
    config = getattr(rllib, f"{name}Config")().environment(env)
    assert config.device is None
    algo_class = config.algo_class
    if not algo_class._owns_params:
        config.offline_data(input_=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.build()
    if algo_class._owns_params:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bare(algo_class, config, None,
                 _env_creator=config.env_creator())
