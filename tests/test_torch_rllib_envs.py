"""``chip_smoke.py``'s environments without gymnasium against gymnasium's.

The card's machine has no gymnasium, so ``chip_smoke.py`` trains RLlib's
learners there on ``_CartPole`` and ``_Pendulum``: CartPole-v1 and
Pendulum-v1 in numpy, their spaces read by attributes. Loaded by path,
each is held to ``gymnasium.make`` of its environment over seeded
episodes: the observations, rewards, terminations and truncations of
every step bit for bit, the reset seeds passed on the first reset only
(as the rollout workers pass them), a later reset continuing the first's
random stream, with random actions (Pendulum's as float32 and float64
arrays, the two dtypes its callers hand it). 5r's ``_ClonableCartPole``,
``_PointGoal`` and ``_RepeatedRPS`` are held the same way to the copies
of env/examples.py (over gymnasium's unwrapped CartPole for the first).
"""

import importlib.util
import pathlib

import gymnasium as gym
import numpy as np
import pytest

_CHIP_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_envs",
                                                  _CHIP_SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _episodes(env, actions, seed, episodes):
    """Each step's (obs, reward, terminated, truncated) over ``episodes``
    episodes, reset with ``seed`` once and unseeded after."""
    out = []
    obs, _ = env.reset(seed=seed)
    out.append((obs, 0.0, False, False))
    done = 0
    for a in actions:
        obs, reward, term, trunc, _ = env.step(a)
        out.append((obs, reward, term, trunc))
        if term or trunc:
            done += 1
            if done == episodes:
                break
            obs, _ = env.reset()
            out.append((obs, 0.0, False, False))
    assert done == episodes
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (o1, r1, t1, u1), (o2, r2, t2, u2) in zip(got, want):
        assert o1.dtype == o2.dtype == np.float32
        np.testing.assert_array_equal(o1, o2)
        assert float(r1) == float(r2)
        assert bool(t1) == bool(t2) and bool(u1) == bool(u2)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_cartpole_matches_gymnasium(chip_smoke, seed):
    rng = np.random.default_rng(seed)
    actions = rng.integers(0, 2, 4000)
    got = _episodes(chip_smoke._CartPole(), actions, seed, 5)
    want = _episodes(gym.make("CartPole-v1"), actions, seed, 5)
    _assert_same(got, want)
    space = chip_smoke._CartPole().action_space
    assert space.n == 2 and space.shape == ()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_pendulum_matches_gymnasium(chip_smoke, seed, dtype):
    rng = np.random.default_rng(seed)
    # Torques beyond the bounds too: the environment clips them.
    actions = rng.uniform(-3.0, 3.0, (600, 1)).astype(dtype)
    got = _episodes(chip_smoke._Pendulum(), actions, seed, 3)
    want = _episodes(gym.make("Pendulum-v1"), actions, seed, 3)
    _assert_same(got, want)
    assert [len(got)] == [3 * 201]
    env, ref = chip_smoke._Pendulum(), gym.make("Pendulum-v1")
    for name in ("observation_space", "action_space"):
        mine, theirs = getattr(env, name), getattr(ref, name)
        assert tuple(mine.shape) == tuple(theirs.shape)
        np.testing.assert_array_equal(mine.low, theirs.low)
        np.testing.assert_array_equal(mine.high, theirs.high)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_clonable_cartpole_matches_the_copy(chip_smoke, seed):
    """``_ClonableCartPole`` against env/examples.py's ClonableCartPole
    over gymnasium's unwrapped CartPole, bit for bit: every step's
    observation and mask, the score paid at termination, the steps past a
    termination, and a state saved at step 5 and restored at step 60."""
    from ray_tpu_torch.rllib.env.examples import ClonableCartPole
    actions = np.random.default_rng(seed).integers(0, 2, 400)
    envs = [chip_smoke._ClonableCartPole(), ClonableCartPole()]
    outs = [[], []]
    for k, env in enumerate(envs):
        obs, _ = env.reset(seed=seed)
        outs[k].append(obs)
        for i, a in enumerate(actions):
            if i == 5:
                saved = env.get_state()
            if i == 60:
                env.set_state(saved)
            obs, r, term, trunc, _ = env.step(a)
            outs[k].append((obs, r, term, trunc, env.episode_score()))
    for got, want in zip(*outs):
        if isinstance(got, dict):
            assert set(got) == set(want) == {"obs", "action_mask"}
            for key in got:
                assert got[key].dtype == want[key].dtype == np.float32
                np.testing.assert_array_equal(got[key], want[key])
            continue
        (g_obs, *g_rest), (w_obs, *w_rest) = got, want
        for key in g_obs:
            np.testing.assert_array_equal(g_obs[key], w_obs[key])
        assert [float(x) for x in g_rest] == [float(x) for x in w_rest]
    got_state, want_state = envs[0].get_state(), envs[1].get_state()
    np.testing.assert_array_equal(got_state[0], want_state[0])
    assert got_state[1:] == want_state[1:]
    assert envs[0].action_space.n == 2
    assert envs[0].observation_space.spaces["obs"].shape == (4,)


def test_point_goal_and_rps_match_the_copies(chip_smoke):
    """``_PointGoal`` (a hidden goal, seeded resets, the reward function)
    and ``_RepeatedRPS`` against env/examples.py's PointGoalEnv and
    TwoPlayerRepeatedRPS, step for step; their spaces' attributes
    against gymnasium's."""
    from ray_tpu_torch.rllib.env.examples import (PointGoalEnv,
                                                  TwoPlayerRepeatedRPS)
    rng = np.random.default_rng(3)
    for config in ({}, {"goal": 1.7, "horizon": 12, "seed": 4}):
        envs = [chip_smoke._PointGoal(config), PointGoalEnv(config)]
        actions = rng.uniform(-2, 2, (80, 1)).astype(np.float32)
        outs = []
        for env in envs:
            out = [env.reset(seed=5)[0]]
            for a in actions:
                obs, r, term, trunc, _ = env.step(a)
                out.append((obs, r, term, trunc, env.reward_fn(obs, a, obs)))
                if trunc:
                    out.append(env.reset()[0])
            outs.append(out)
        assert len(outs[0]) == len(outs[1])
        for got, want in zip(*outs):
            if isinstance(got, np.ndarray):
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_array_equal(got[0], want[0])
                assert [float(x) for x in got[1:]] == \
                    [float(x) for x in want[1:]]
        for name in ("observation_space", "action_space"):
            mine, theirs = getattr(envs[0], name), getattr(envs[1], name)
            assert tuple(mine.shape) == tuple(theirs.shape)
            np.testing.assert_array_equal(mine.low, theirs.low)
            np.testing.assert_array_equal(mine.high, theirs.high)
        sample = envs[0].action_space.sample()
        assert sample.dtype == np.float32 and sample.shape == (1,)
        assert -1.0 <= float(sample[0]) <= 1.0
    envs = [chip_smoke._RepeatedRPS({"rounds": 5}),
            TwoPlayerRepeatedRPS({"rounds": 5})]
    moves = rng.integers(0, 3, (12, 2))
    outs = []
    for env in envs:
        out = [env.reset()[0]]
        for a0, a1 in moves:
            obs, rewards, terms, truncs, _ = env.step({"p0": a0, "p1": a1})
            out.append((obs, rewards, terms, truncs))
            if terms["__all__"]:
                out.append(env.reset()[0])
        outs.append(out)
    for got, want in zip(*outs):
        if isinstance(got, dict):
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])
    assert envs[0].agent_ids == envs[1].agent_ids
    assert envs[0].action_space.n == envs[1].action_space.n == 3
    assert tuple(envs[0].observation_space.shape) == \
        tuple(envs[1].observation_space.shape)
