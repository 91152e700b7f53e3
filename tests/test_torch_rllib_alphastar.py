"""The port's AlphaStar against the JAX package's, and
``tests/test_rllib_alphastar.py``'s cases on the port.

Held to the JAX package from the carried-over learner state (each of the
three learning policies and its PPO Adam state, keyed by policy id, as
``learner_state`` lays out a dict of optimizer states): each learner's
minibatch SGD on the same GAE-complete batch of repeated
rock-paper-scissors rows, and PFSP's opponent weights. The learners run on
the CPU (``.resources(device="cpu")``).
"""

import jax
import numpy as np
import pytest

import ray_tpu_torch
from _torch_rllib_pair import STEP_ATOL, STEP_RTOL, bare, one_torch_thread
from ray_tpu.rllib.algorithms import alpha_star as jalpha_star
from ray_tpu.rllib.env.examples import TwoPlayerRepeatedRPS as JRPS
from ray_tpu_torch.rllib import AlphaStar, AlphaStarConfig, SampleBatch
from ray_tpu_torch.rllib.algorithms import alpha_star
from ray_tpu_torch.rllib.algorithms.learner_state import (learner_state,
                                                          load_learner_state)
from ray_tpu_torch.rllib.env.examples import TwoPlayerRepeatedRPS
from ray_tpu_torch.rllib.policy.torch_policy import compute_gae


def _jax_state(jalgo):
    return {"params": {pid: jax.tree.map(np.asarray, p.params)
                       for pid, p in jalgo.learning.items()},
            "_opt_states": jax.tree.map(np.asarray, jalgo._opt_states)}


def _pair():
    kw = dict(train_batch_size=256, num_sgd_iter=3, sgd_minibatch_size=32,
              lr=5e-3, model={"fcnet_hiddens": [16, 16]})
    jcfg = (jalpha_star.AlphaStarConfig().training(**kw)
            .environment(env_config={"rounds": 8}).debugging(seed=1))
    cfg = (AlphaStarConfig().training(**kw).environment(
        env_config={"rounds": 8}).resources(device="cpu").debugging(seed=1))
    jalgo = bare(jalpha_star.AlphaStar, jcfg, None,
                 _env_creator=lambda c: JRPS(c))
    algo = bare(alpha_star.AlphaStar, cfg, None,
                _env_creator=lambda c: TwoPlayerRepeatedRPS(c))
    load_learner_state(algo, _jax_state(jalgo))
    return jalgo, algo


def _league_batch(seed, n=96):
    """Rows shaped as a learner's match transitions, GAE-complete."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((n, 6), np.float32)
    obs[np.arange(n), rng.integers(0, 3, n)] = 1.0
    obs[np.arange(n), 3 + rng.integers(0, 3, n)] = 1.0
    ends = np.arange(n) % 8 == 7
    batch = SampleBatch({
        SampleBatch.OBS: obs,
        SampleBatch.ACTIONS: rng.integers(0, 3, n),
        SampleBatch.REWARDS: rng.choice([-1.0, 0.0, 1.0], n).astype(
            np.float32),
        SampleBatch.TERMINATEDS: ends.astype(np.float32),
        SampleBatch.ACTION_LOGP: np.log(rng.uniform(0.2, 0.5, n)).astype(
            np.float32),
        SampleBatch.VF_PREDS: rng.normal(0, 0.5, n).astype(np.float32)})
    return compute_gae(batch, 0.99, 0.95, 0.0)


def test_alphastar_learner_updates_match_jax():
    """Each of the three learners' PPO minibatch SGD (3 epochs of 3
    minibatches) on the same batch: the last metrics, then every
    learner's parameters and Adam state by policy id."""
    jalgo, algo = _pair()
    for i, pid in enumerate(sorted(algo.learning)):
        batch = _league_batch(5 + i)
        jalgo._opt_states[pid], want = jalgo._sgd(
            jalgo.learning[pid], jalgo._updates[pid],
            jalgo._opt_states[pid], batch, jalgo.config)
        got = algo.learn_on_batch(pid, batch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=k)
    got, want = learner_state(algo), _jax_state(jalgo)
    assert set(got) == set(want)
    for name in want:
        a, b = jax.tree_util.tree_leaves(got[name]), \
            jax.tree_util.tree_leaves(want[name])
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=name)


def test_alphastar_matchmaking_matches_jax():
    """From the same win rates and numpy seed, PFSP and the opponent
    choice of every learner pick the same opponents."""
    jalgo, algo = _pair()
    for a in (jalgo, algo):
        a.league["main_v1"] = a.league["main_v0"]
        a.win_rates.update({("main", "main_v0"): 0.9,
                            ("main", "main_v1"): 0.2,
                            ("league_exploiter_0", "main_v1"): 0.6})
    picks = [[a._pick_opponent(pid) for _ in range(40)
              for pid in sorted(a.learning)] for a in (jalgo, algo)]
    assert picks[0] == picks[1]


# -- tests/test_rllib_alphastar.py on the port --------------------------------

@pytest.fixture
def ray_session():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def _build(**league_kw):
    config = (AlphaStarConfig()
              .environment(TwoPlayerRepeatedRPS,
                           env_config={"rounds": 8})
              .training(train_batch_size=256, num_sgd_iter=4,
                        sgd_minibatch_size=64, lr=5e-3,
                        model={"fcnet_hiddens": [32, 32]})
              .league(matches_per_iteration=12, **league_kw)
              .resources(device="cpu")
              .debugging(seed=0))
    return config.build()


def test_league_structure_and_matchmaking(ray_session):
    algo: AlphaStar = _build()
    assert set(algo.learning) == {"main", "main_exploiter_0",
                                  "league_exploiter_0"}
    assert list(algo.league) == ["main_v0"]
    result = algo.train()
    assert result["league_size"] >= 1
    assert "main/mean_score" in result
    assert "main_exploiter_0/mean_score" in result
    # PFSP prefers opponents the learner LOSES to.
    algo.win_rates[("main", "main_v0")] = 0.9   # easy
    algo.win_rates[("main", "main_v1")] = 0.1   # hard
    algo.league["main_v1"] = algo.league["main_v0"]
    picks = [algo._pfsp_pick("main", ["main_v0", "main_v1"])
             for _ in range(200)]
    assert picks.count("main_v1") > picks.count("main_v0") * 3
    algo.stop()


def test_main_learns_to_exploit_frozen_snapshot(ray_session):
    """The learning main must reliably beat the frozen initial snapshot
    after a few league iterations (counter-play against a fixed,
    biased opponent is learnable in repeated RPS)."""
    algo: AlphaStar = _build(
        win_rate_threshold_for_new_snapshot=0.65)
    before = algo.win_rate_vs("main_v0", episodes=30)
    best = 0.0
    for _ in range(12):
        algo.train()
        rate = algo.win_rate_vs("main_v0", episodes=30)
        best = max(best, rate)
        if best >= 0.6:
            break
    assert best >= 0.6, (before, best)
    algo.stop()


def test_snapshots_join_league_and_exploiters_reset(ray_session):
    algo: AlphaStar = _build(
        win_rate_threshold_for_new_snapshot=0.55)
    grew = False
    for _ in range(15):
        result = algo.train()
        if result["league_size"] > 1:
            grew = True
            break
    assert grew, "league never grew beyond the initial snapshot"
    names = set(algo.league)
    assert "main_v0" in names and len(names) >= 2
    algo.stop()


def test_league_state_checkpoint_roundtrip(ray_session, tmp_path):
    algo: AlphaStar = _build()
    algo.train()
    algo.win_rates[("main", "main_v0")] = 0.77
    path = algo.save(str(tmp_path))
    algo2: AlphaStar = _build()
    algo2.restore(path)
    assert algo2.win_rates[("main", "main_v0")] == 0.77
    assert set(algo2.league) == set(algo.league)
    w1 = algo.learning["main"].get_weights()
    w2 = algo2.learning["main"].get_weights()
    for a, b in zip(jax.tree_util.tree_leaves(w1),
                    jax.tree_util.tree_leaves(w2)):
        np.testing.assert_allclose(a, b)
    algo.stop()
    algo2.stop()
