"""The port's on-policy, offline and evolution learners against the JAX
package's.

A2C (with A3C's update), PG, IMPALA and APPO (V-trace), BC and MARWIL, ES
and ARS, each held to the JAX package from the same state (the JAX
learner's parameters and optax state carried over by
``load_learner_state``) and the same batch: the losses and gradients
(the JAX losses are the closures of the JAX algorithm's jitted update), a
whole ``training_step`` (fed by a fixed batch in place of the rollout
workers, or by offline JSON written by the JAX package's ``JsonWriter``),
``vtrace``, ``compute_vtrace_targets`` and ``discounted_returns``, ES's
flat parameter order against ``ravel_pytree``, and one ES and ARS
iteration's theta (their evaluators roll out the same seeded episodes in
both packages). Then ``tests/test_rllib.py``'s cases of these algorithms
on the port, held to the reference's own bars (the registry's lines wait
for ``algorithms/registry.py``), and the file's general cases (sample
batches, the config, the catalog's CNN, the connectors, offline JSON),
and clipping by a Box read by its attributes. The learners run on the
CPU (``.resources(device="cpu")``).
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from _torch_rllib_pair import (LOSS_TOL, STEP_RTOL, assert_state, bare,
                               carry, closure, grads_close, one_torch_thread,
                               port_cluster)
from ray_tpu.rllib import A2CConfig as JA2CConfig
from ray_tpu.rllib import APPOConfig as JAPPOConfig
from ray_tpu.rllib import ARSConfig as JARSConfig
from ray_tpu.rllib import BCConfig as JBCConfig
from ray_tpu.rllib import ESConfig as JESConfig
from ray_tpu.rllib import ImpalaConfig as JImpalaConfig
from ray_tpu.rllib import JsonWriter as JJsonWriter
from ray_tpu.rllib import MARWILConfig as JMARWILConfig
from ray_tpu.rllib import PGConfig as JPGConfig
from ray_tpu.rllib import SampleBatch as JSampleBatch
from ray_tpu.rllib.algorithms import a2c as ja2c
from ray_tpu.rllib.algorithms import appo as jappo
from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.algorithms import pg as jpg
from ray_tpu.rllib.policy import make_policy as jmake_policy
from ray_tpu_torch.rllib import (A2CConfig, APPOConfig, ARSConfig, BCConfig,
                                 ESConfig, ImpalaConfig, MARWILConfig,
                                 PGConfig, PPOConfig, SampleBatch)
from ray_tpu_torch.rllib.algorithms import a2c, appo, bc, impala, marwil, pg
from ray_tpu_torch.rllib.algorithms.es import ravel
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.torch_policy import as_tensor

# V-trace's and the returns' host arithmetic from the two packages'
# log-probabilities and values (each within fp32 summation order).
VTRACE_TOL = 1e-6

HIDDENS = (32, 32)


# -- the harness -----------------------------------------------------------

class _Workers:
    """A WorkerSet that hands out copies of one fixed batch."""

    def __init__(self, batch, cls):
        self._batch, self._cls = batch, cls

    def sync_weights(self, _ref):
        pass

    def num_workers(self):
        return 2

    def sample(self, _steps):
        return self._cls({k: np.array(v) for k, v in self._batch.items()})


def _spaces(discrete=True):
    obs = gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)
    act = (gym.spaces.Discrete(2) if discrete
           else gym.spaces.Box(-1, 1, (2,), np.float32))
    return obs, act


def _pair(jcls, cls, jcfg, cfg, batch=None, discrete=True):
    """The JAX algorithm and the port's, bare, fed by the same fixed batch,
    the port's learner state carried over from the JAX one's."""
    spaces = _spaces(discrete)
    jpol = jmake_policy(jcfg.policy_config(), *spaces, seed=jcfg.seed)
    pol = make_policy(cfg.policy_config(), *spaces, seed=cfg.seed,
                      device="cpu")
    jalgo = bare(jcls, jcfg, jpol, iteration=3, workers=(
        None if batch is None else _Workers(batch, JSampleBatch)))
    algo = bare(cls, cfg, pol, iteration=3, workers=(
        None if batch is None else _Workers(batch, SampleBatch)))
    carry(jalgo, algo)
    return jalgo, algo


def _assert_results(got, want, rtol=LOSS_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=rtol,
                                   atol=LOSS_TOL, err_msg=k)


def _rollout(n, seed, discrete=True):
    """A GAE-complete rollout batch of ``n`` seeded rows: episodes of 5-60
    steps, some cut by truncation, the tail unterminated."""
    rng = np.random.default_rng(seed)
    ends = np.zeros(n, bool)
    t = 0
    while t < n:
        t += int(rng.integers(5, 60))
        if t < n:
            ends[t - 1] = True
    term = ends & (rng.random(n) < 0.7)
    return {
        SampleBatch.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        SampleBatch.NEXT_OBS: rng.normal(size=(n, 4)).astype(np.float32),
        SampleBatch.ACTIONS: (rng.integers(0, 2, n) if discrete
                              else rng.normal(size=(n, 2)).astype(
                                  np.float32)),
        SampleBatch.REWARDS: np.ones(n, np.float32),
        SampleBatch.TERMINATEDS: term.astype(np.float32),
        SampleBatch.TRUNCATEDS: (ends & ~term).astype(np.float32),
        SampleBatch.EPS_ID: np.concatenate([[0], np.cumsum(ends)[:-1]]),
        SampleBatch.ACTION_LOGP: rng.normal(-0.7, 0.2, n).astype(np.float32),
        SampleBatch.VF_PREDS: rng.normal(size=n).astype(np.float32),
        SampleBatch.ADVANTAGES: rng.normal(1.0, 2.0, n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: rng.normal(size=n).astype(np.float32),
    }


# -- the host arithmetic -----------------------------------------------------

def test_discounted_returns_are_bit_equal():
    batch = _rollout(300, 1)
    values = np.random.default_rng(2).normal(size=300).astype(np.float32)
    for boot in (None, values):
        got = pg.discounted_returns(SampleBatch(dict(batch)), 0.97, boot)
        want = jpg.discounted_returns(JSampleBatch(dict(batch)), 0.97, boot)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_vtrace_is_bit_equal():
    rng = np.random.default_rng(3)
    args = [rng.normal(-0.7, 0.3, 40).astype(np.float32) for _ in range(2)]
    args += [rng.normal(size=40).astype(np.float32) for _ in range(2)]
    for clips in ((1.0, 1.0), (0.8, 1.2)):
        got = impala.vtrace(*args, 0.4, 0.95, *clips)
        want = jimpala.vtrace(*args, 0.4, 0.95, *clips)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "box"])
def test_compute_vtrace_targets_match_jax(discrete):
    """The targets against each package's current policy, fragment by
    fragment, with the truncation bootstrap."""
    config = {"fcnet_hiddens": HIDDENS}
    jpol = jmake_policy(config, *_spaces(discrete), seed=4)
    pol = make_policy(config, *_spaces(discrete), seed=4, device="cpu")
    pol.set_weights(jpol.get_weights())
    batch = _rollout(200, 5, discrete)
    got = impala.compute_vtrace_targets(pol, SampleBatch(dict(batch)),
                                        0.99, 1.0, 1.0)
    want = jimpala.compute_vtrace_targets(jpol, JSampleBatch(dict(batch)),
                                          0.99, 1.0, 1.0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL)


# -- the learners ----------------------------------------------------------

_ON_POLICY = {
    "a2c": (ja2c.A2C, JA2CConfig, a2c.A2C, A2CConfig, {"grad_clip": 0.5}),
    "a2c-noclip": (ja2c.A2C, JA2CConfig, a2c.A2C, A2CConfig, {}),
    "pg": (jpg.PG, JPGConfig, pg.PG, PGConfig, {}),
    "impala": (jimpala.Impala, JImpalaConfig, impala.Impala, ImpalaConfig,
               {"vtrace_rho_clip": 0.9}),
    "appo": (jappo.APPO, JAPPOConfig, appo.APPO, APPOConfig,
             {"sgd_minibatch_size": 96, "num_sgd_iter": 2}),
}


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "box"])
@pytest.mark.parametrize("name", sorted(_ON_POLICY))
def test_on_policy_training_steps_match_jax(ray_start_regular, port_cluster,
                                            name, discrete):
    """Three whole ``training_step``s from the same state and batch: the
    metrics and the learner state (parameters and optax state) after
    each. A2C's once with its global-norm clip active (0.5) and once not;
    A3C applies the same update to each worker's batch."""
    jcls, jcfg_cls, cls, cfg_cls, extra = _ON_POLICY[name]
    kw = dict(lr=3e-3, train_batch_size=288,
              model={"fcnet_hiddens": list(HIDDENS)}, **extra)
    jcfg = jcfg_cls().training(**kw).debugging(seed=6)
    cfg = cfg_cls().training(**kw).debugging(seed=6)
    batch = _rollout(288, 7, discrete)
    jalgo, algo = _pair(jcls, cls, jcfg, cfg, batch, discrete)
    for _ in range(3):
        _assert_results(algo.training_step(), jalgo.training_step())
        assert_state(algo, jalgo)


@pytest.mark.parametrize("name", ["a2c", "impala", "appo"])
def test_on_policy_losses_and_gradients_match_jax(name):
    """Each loss of the JAX update's closure and its gradients, on a
    staged minibatch."""
    jcls, jcfg_cls, cls, cfg_cls, extra = _ON_POLICY[name]
    kw = dict(model={"fcnet_hiddens": list(HIDDENS)}, **extra)
    jalgo, algo = _pair(jcls, cls, jcfg_cls().training(**kw).debugging(
        seed=8), cfg_cls().training(**kw).debugging(seed=8))
    rng = np.random.default_rng(9)
    mb = {"obs": rng.normal(size=(64, 4)).astype(np.float32),
          "actions": rng.integers(0, 2, 64)}
    for k in ("advantages", "value_targets", "vs", "pg_advantages"):
        mb[k] = rng.normal(size=64).astype(np.float32)
    mb["behavior_logp"] = rng.normal(-0.7, 0.1, 64).astype(np.float32)
    jloss = closure(jalgo._update_jit)["loss_fn"]
    (want, want_m), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jalgo.local_policy.params, {k: jnp.asarray(v) for k, v in mb.items()})
    got, got_m = algo._loss_fn(algo.local_policy.params,
                               {k: as_tensor(v, "cpu")
                                for k, v in mb.items()})
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_TOL)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k].detach()), float(want_m[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    grads_close(torch.autograd.grad(
        got, jax.tree_util.tree_leaves(algo.local_policy.params)), want_g)


def _write_offline(path, seed, fragments=5, rows=120):
    """Offline JSON written by the JAX package's ``JsonWriter``."""
    writer = JJsonWriter(str(path))
    for i in range(fragments):
        writer.write(JSampleBatch(_rollout(rows, seed + i)))
    writer.close()
    return str(path)


@pytest.mark.parametrize("name", ["bc", "marwil"])
def test_offline_training_steps_match_jax(tmp_path, name):
    """BC and MARWIL trained by the port from JSON written by the JAX
    package's ``JsonWriter``: three whole ``training_step``s against the
    JAX package's from the same state (MARWIL's returns bootstrapped by
    each package's value head, its running norm), the loss falling."""
    path = _write_offline(tmp_path / "exp", 20)
    kw = dict(lr=5e-3, train_batch_size=64,
              num_train_batches_per_iteration=4,
              model={"fcnet_hiddens": list(HIDDENS)})
    if name == "bc":
        jcls, cls, jcfg, cfg = (jbc.BC, bc.BC, JBCConfig(), BCConfig())
    else:
        jcls, cls = jmarwil.MARWIL, marwil.MARWIL
        jcfg, cfg = JMARWILConfig(), MARWILConfig()
        kw["beta"] = 1.0
    jcfg = jcfg.training(**kw).offline_data(input_=path).debugging(seed=9)
    cfg = cfg.training(**kw).offline_data(input_=path).debugging(seed=9)
    jalgo, algo = _pair(jcls, cls, jcfg, cfg)
    losses = []
    for _ in range(3):
        got, want = algo.training_step(), jalgo.training_step()
        _assert_results(got, want, rtol=1e-4)
        assert_state(algo, jalgo)
        losses.append(got["loss"])
    assert losses[-1] < losses[0], losses


# -- ES and ARS ---------------------------------------------------------------

def test_ravel_is_ravel_pytrees_order():
    """The flat vector of a policy tree (with a gaussian head's log_std
    among its leaves) and its inverse equal ``ravel_pytree``'s."""
    jpol = jmake_policy({"fcnet_hiddens": (8, 5)}, *_spaces(False), seed=1)
    pol = make_policy({"fcnet_hiddens": (8, 5)}, *_spaces(False), seed=1,
                      device="cpu")
    pol.set_weights(jpol.get_weights())
    want, junravel = ravel_pytree(jpol.params)
    got, unravel = ravel(pol.params)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vec = np.arange(got.numel(), dtype=np.float32)
    for a, b in zip(jax.tree_util.tree_leaves(unravel(torch.from_numpy(vec))),
                    jax.tree_util.tree_leaves(junravel(jnp.asarray(vec)))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["es", "ars"])
def test_es_iterations_match_jax(ray_start_regular, port_cluster, name):
    """Two iterations of ES (and ARS) in both packages from the same theta
    and Adam state: the evaluators roll out the same seeded CartPole
    episodes (the same noise table, rows and returns) and theta steps
    alike."""
    kw = dict(noise_stdev=0.1, stepsize=0.1, num_rollout_pairs_per_worker=3,
              episode_horizon=60, model={"fcnet_hiddens": [16]})
    if name == "ars":
        kw["deltas_used"] = 4
    jcfg = ((JARSConfig() if name == "ars" else JESConfig())
            .environment("CartPole-v1").rollouts(num_rollout_workers=2)
            .training(**kw).debugging(seed=5))
    cfg = ((ARSConfig() if name == "ars" else ESConfig())
           .environment("CartPole-v1").rollouts(num_rollout_workers=2)
           .training(**kw).resources(device="cpu").debugging(seed=5))
    jalgo, algo = jcfg.build(), cfg.build()
    carry(jalgo, algo)
    for _ in range(2):
        got, want = algo.train(), jalgo.train()
        for k in ("episode_reward_mean", "episode_len_mean",
                  "episodes_total", "grad_norm", "update_ratio"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(algo._theta.numpy(), jalgo._theta,
                                   rtol=STEP_RTOL, atol=1e-6)
        assert_state(algo, jalgo, atol=1e-6)
    assert (algo.compute_single_action(np.zeros(4, np.float32))
            == jalgo.compute_single_action(np.zeros(4, np.float32)))
    algo.stop()
    jalgo.stop()


# -- tests/test_rllib.py's cases on the port -------------------------------

def test_a2c_cartpole_smoke(port_cluster):
    config = (A2CConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2)
              .training(train_batch_size=512)
              .resources(device="cpu")
              .debugging(seed=1))
    algo = config.build()
    for _ in range(3):
        res = algo.train()
    assert np.isfinite(res["total_loss"])
    assert res["timesteps_total"] >= 3 * 512
    algo.stop()


def test_impala_cartpole_smoke(port_cluster):
    config = (ImpalaConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2)
              .training(train_batch_size=512)
              .resources(device="cpu")
              .debugging(seed=2))
    algo = config.build()
    for _ in range(3):
        res = algo.train()
    assert np.isfinite(res["total_loss"])
    algo.stop()


def test_vtrace_reduces_to_gae_like_targets():
    """On-policy (ratios=1, no clipping active), V-trace vs equals the
    lambda=1 return."""
    rewards = np.asarray([1.0, 1.0, 1.0], np.float32)
    values = np.asarray([0.5, 0.5, 0.5], np.float32)
    logp = np.zeros(3, np.float32)
    vs, adv = impala.vtrace(logp, logp, rewards, values, bootstrap=0.0,
                            gamma=0.9)
    # vs[t] = r_t + gamma * vs[t+1] (rho=c=1 on-policy, TD(1))
    expected_vs2 = 1.0
    expected_vs1 = 1.0 + 0.9 * expected_vs2
    expected_vs0 = 1.0 + 0.9 * expected_vs1
    np.testing.assert_allclose(vs, [expected_vs0, expected_vs1,
                                    expected_vs2], rtol=1e-5)


def test_bc_learns_from_offline_data(port_cluster, tmp_path):
    """BC imitates logged behavior: PPO rollouts -> JSON -> BC training
    (the offline-RL pipeline end to end)."""
    out_dir = str(tmp_path / "exp")
    gen = (PPOConfig()
           .environment("CartPole-v1")
           .rollouts(num_rollout_workers=1, rollout_fragment_length=400)
           .offline_data(output=out_dir)
           .resources(device="cpu")
           .debugging(seed=8)).build()
    gen.train()
    gen.stop()
    bc_algo = (BCConfig()
               .environment("CartPole-v1")
               .offline_data(input_=out_dir)
               .training(lr=5e-3, num_train_batches_per_iteration=10)
               .resources(device="cpu")
               .debugging(seed=9)).build()
    first = bc_algo.train()["loss"]
    for _ in range(4):
        last = bc_algo.train()["loss"]
    assert np.isfinite(last) and last < first, (first, last)
    # greedy eval still runs (policy is a normal actor-critic)
    ev = bc_algo.evaluate()
    assert np.isfinite(ev["episode_reward_mean"])
    bc_algo.stop()
    # BC without input_ is a config error
    with pytest.raises(ValueError):
        (BCConfig().environment("CartPole-v1")).build()


def test_appo_cartpole_smoke(port_cluster):
    config = (APPOConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2)
              .training(train_batch_size=512, lr=2e-3)
              .resources(device="cpu")
              .debugging(seed=13))
    algo = config.build()
    for _ in range(3):
        res = algo.train()
    assert np.isfinite(res["total_loss"])
    algo.stop()


def test_pg_cartpole_learns(port_cluster):
    config = (PGConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2)
              .training(lr=4e-3, train_batch_size=1024)
              .resources(device="cpu")
              .debugging(seed=11))
    algo = config.build()
    results = [algo.train() for _ in range(12)]
    first = results[0]["episode_reward_mean"]
    last = results[-1]["episode_reward_mean"]
    assert np.isfinite(results[-1]["policy_loss"])
    assert last > 1.5 * first, f"no learning: {first:.1f} -> {last:.1f}"
    algo.stop()


def test_pg_discounted_returns():
    batch = SampleBatch({
        SampleBatch.REWARDS: [1.0, 1.0, 1.0, 2.0],
        SampleBatch.TERMINATEDS: [0.0, 0.0, 1.0, 1.0],
    })
    out = pg.discounted_returns(batch, gamma=0.5)
    # Episode 1: [1 + .5*(1 + .5*1), 1 + .5*1, 1]; episode 2: [2].
    np.testing.assert_allclose(out, [1.75, 1.5, 1.0, 2.0])


def test_a3c_cartpole_smoke(port_cluster):
    from ray_tpu_torch.rllib import A3CConfig
    config = (A3CConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2)
              .training(train_batch_size=512)
              .resources(device="cpu")
              .debugging(seed=12))
    algo = config.build()
    for _ in range(3):
        res = algo.train()
    assert np.isfinite(res["total_loss"])
    # one async gradient application per worker per step
    assert res["async_grad_updates"] == 2
    algo.stop()


def test_marwil_learns_from_offline_data(port_cluster, tmp_path):
    out_dir = str(tmp_path / "exp")
    gen = (PPOConfig()
           .environment("CartPole-v1")
           .rollouts(num_rollout_workers=1, rollout_fragment_length=400)
           .offline_data(output=out_dir)
           .resources(device="cpu")
           .debugging(seed=8)).build()
    gen.train()
    gen.stop()
    algo = (MARWILConfig()
            .environment("CartPole-v1")
            .offline_data(input_=out_dir)
            .training(lr=5e-3, beta=1.0,
                      num_train_batches_per_iteration=10)
            .resources(device="cpu")
            .debugging(seed=9)).build()
    first = algo.train()["policy_loss"]
    for _ in range(4):
        res = algo.train()
    assert np.isfinite(res["policy_loss"]) and np.isfinite(res["vf_loss"])
    assert res["policy_loss"] < first
    assert res["adv_sq_norm"] > 0
    algo.stop()
    with pytest.raises(ValueError):
        (MARWILConfig().environment("CartPole-v1")).build()


def test_es_cartpole_learns(port_cluster):
    config = (ESConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2)
              .training(noise_stdev=0.1, stepsize=0.1,
                        num_rollout_pairs_per_worker=8,
                        episode_horizon=200,
                        model={"fcnet_hiddens": [16]})
              .resources(device="cpu")
              .debugging(seed=5))
    algo = config.build()
    results = [algo.train() for _ in range(8)]
    first = results[0]["episode_reward_mean"]
    best = max(r["episode_reward_mean"] for r in results)
    assert np.isfinite(best)
    assert results[-1]["episodes_total"] == 8 * 2 * 8 * 2
    assert best > first, f"no improvement: first={first} best={best}"
    # deterministic eval action is valid
    a = algo.compute_single_action(np.zeros(4, np.float32))
    assert a in (0, 1)
    algo.stop()


def test_ars_cartpole_smoke(port_cluster):
    config = (ARSConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=2)
              .training(noise_stdev=0.1, stepsize=0.1,
                        num_rollout_pairs_per_worker=6, deltas_used=4,
                        episode_horizon=200,
                        model={"fcnet_hiddens": [16]})
              .resources(device="cpu")
              .debugging(seed=6))
    algo = config.build()
    results = [algo.train() for _ in range(6)]
    best = max(r["episode_reward_mean"] for r in results)
    assert np.isfinite(best)
    assert best > results[0]["episode_reward_mean"]
    algo.stop()


# -- tests/test_rllib.py's other cases, on the port --------------------------

def test_sample_batch_ops():
    b1 = SampleBatch({"obs": np.arange(4), "eps_id": [0, 0, 1, 1]})
    b2 = SampleBatch({"obs": np.arange(4, 6), "eps_id": [2, 2]})
    cat = SampleBatch.concat_samples([b1, b2])
    assert len(cat) == 6
    eps = cat.split_by_episode()
    assert [len(e) for e in eps] == [2, 2, 2]
    mbs = list(cat.minibatches(3, seed=0))
    assert all(len(m) == 3 for m in mbs)


def test_ppo_config_fluent():
    config = (PPOConfig()
              .environment("CartPole-v1")
              .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
              .training(lr=1e-3, train_batch_size=128, clip_param=0.3,
                        model={"fcnet_hiddens": [32, 32]})
              .debugging(seed=42))
    assert config.clip_param == 0.3
    assert config.fcnet_hiddens == (32, 32)
    d = config.to_dict()
    assert d["lr"] == 1e-3


def test_model_catalog_cnn():
    from ray_tpu_torch.rllib import ModelCatalog
    space = gym.spaces.Box(0, 255, shape=(32, 32, 3), dtype=np.uint8)
    init, apply, feat_dim = ModelCatalog.get_encoder(
        space, {"conv_filters": [[8, 4, 2], [16, 3, 2]],
                "post_fcnet_dim": 64})
    params = init(torch.Generator().manual_seed(0), "cpu")
    obs = np.zeros((5, 32, 32, 3), np.float32)
    out = apply(params, torch.from_numpy(obs))
    assert out.shape == (5, 64) and feat_dim == 64


def test_connectors_meanstd_and_clip():
    from ray_tpu_torch.rllib.connectors import get_connectors
    obs_space = gym.spaces.Box(-1, 1, shape=(4,), dtype=np.float32)
    act_space = gym.spaces.Box(-2, 2, shape=(1,), dtype=np.float32)
    obs_conn, act_conn = get_connectors(
        {"observation_filter": "MeanStdFilter", "clip_actions": True},
        obs_space, act_space)
    for i in range(50):
        out = obs_conn(np.full(4, float(i)))
    assert np.isfinite(out).all() and np.abs(out).max() <= 10.0
    assert act_conn(np.asarray([5.0]))[0] == 2.0
    # filter state round-trips
    state = obs_conn.get_state()
    obs_conn2, _ = get_connectors(
        {"observation_filter": "MeanStdFilter"}, obs_space, act_space)
    obs_conn2.set_state(state)
    np.testing.assert_allclose(obs_conn2(np.full(4, 50.0)),
                               obs_conn(np.full(4, 50.0)), rtol=1e-5)


def test_offline_json_roundtrip(tmp_path):
    from ray_tpu_torch.rllib import JsonReader, JsonWriter
    writer = JsonWriter(str(tmp_path))
    b1 = SampleBatch({"obs": np.random.randn(10, 4).astype(np.float32),
                      "actions": np.arange(10)})
    writer.write(b1)
    writer.close()
    reader = JsonReader(str(tmp_path))
    out = reader.next()
    np.testing.assert_array_equal(out["obs"], b1["obs"])
    np.testing.assert_array_equal(out["actions"], b1["actions"])
    # cycles forever
    out2 = reader.next()
    assert len(out2) == 10


def test_clip_actions_needs_no_gymnasium():
    """A Box read by its attributes (the card's machine has no gymnasium)
    clips actions as gymnasium's Box does; a Discrete space gets no clip."""
    import types

    from ray_tpu_torch.rllib.connectors import get_connectors
    box = types.SimpleNamespace(shape=(1,), low=np.full(1, -2.0, np.float32),
                                high=np.full(1, 2.0, np.float32))
    obs = types.SimpleNamespace(shape=(3,))
    _, act_conn = get_connectors({"clip_actions": True}, obs, box)
    np.testing.assert_array_equal(act_conn(np.asarray([5.0, -7.0])[:1]),
                                  [2.0])
    _, act_conn = get_connectors({"clip_actions": True}, obs,
                                 types.SimpleNamespace(n=2, shape=()))
    assert not act_conn.connectors
