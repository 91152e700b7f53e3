"""``chip_smoke.py``'s environments without gymnasium against gymnasium's.

The card's machine has no gymnasium, so ``chip_smoke.py`` trains RLlib's
learners there on ``_CartPole`` and ``_Pendulum``: CartPole-v1 and
Pendulum-v1 in numpy, their spaces read by attributes. Loaded by path,
each is held to ``gymnasium.make`` of its environment over seeded
episodes: the observations, rewards, terminations and truncations of
every step bit for bit, the reset seeds passed on the first reset only
(as the rollout workers pass them), a later reset continuing the first's
random stream, with random actions (Pendulum's as float32 and float64
arrays, the two dtypes its callers hand it).
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
