"""The harness of the RLlib parity tests (``tests/test_torch_rllib_q.py``,
``tests/test_torch_rllib_pg.py``, ``tests/test_torch_rllib_rainbow.py``,
``tests/test_torch_rllib_r2d2_qmix.py``,
``tests/test_torch_rllib_slateq_maddpg.py``): a JAX algorithm and the
port's built bare, the port's learner state carried over from the JAX
one's, and the two held to each other.

An algorithm is built bare (``object.__new__`` and ``setup``): no runtime,
no rollout workers, its learner policy and what the caller gives it. The
JAX losses are read from the closures of the JAX algorithm's jitted update
(:func:`closure`).
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import SampleBatch
from ray_tpu_torch.rllib.algorithms.learner_state import (learner_state,
                                                          load_learner_state)

# The loss and its gradients from the same state: fp32 summation order
# (PR 17's bounds).
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# The state after a few Adam steps (Adam divides by |g|).
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The learners' small products on one thread (the other test
    processes on the host would make torch's pool wait at its
    barriers). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_cluster():
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


def bare(cls, config, policy, **attrs):
    """An algorithm of either package without its runtime: its learner
    policy, the attributes ``attrs`` (an env creator, a WorkerSet) and
    ``setup``."""
    algo = object.__new__(cls)
    algo.config = config
    algo.local_policy = policy
    algo.iteration = 0
    algo._timesteps_total = 0
    algo.is_multi_agent = False
    for name, value in attrs.items():
        setattr(algo, name, value)
    algo.setup(config)
    return algo


def jax_params(jalgo, algo):
    """The JAX learner's parameters: its policy's, or its own where the
    port's algorithm learns its own (``_owns_params``)."""
    return jalgo.params if algo._owns_params else jalgo.local_policy.params


def jax_state(jalgo, algo):
    """The JAX learner's state under the names the port's algorithm
    declares, as numpy trees (``learner_state``'s layout)."""
    state = {"params": jax.tree.map(np.asarray, jax_params(jalgo, algo))}
    for name in (*algo._learner_trees, *algo._learner_opts,
                 *algo._learner_values):
        state[name] = jax.tree.map(np.asarray, getattr(jalgo, name))
    return state


def carry(jalgo, algo):
    """The port's learner resumed from the JAX one's state."""
    load_learner_state(algo, jax_state(jalgo, algo))


def assert_state(algo, jalgo, rtol=STEP_RTOL, atol=STEP_ATOL):
    """Every tree of the port's learner state against the JAX one's
    attribute, leaf by leaf (``jax.tree_util``'s order on both)."""
    for name, got in learner_state(algo).items():
        want = (jax_params(jalgo, algo) if name == "params"
                else getattr(jalgo, name))
        got_l = jax.tree_util.tree_leaves(got)
        want_l = jax.tree_util.tree_leaves(want)
        assert len(got_l) == len(want_l), name
        for a, b in zip(got_l, want_l):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=rtol, atol=atol, err_msg=name)


def closure(fn):
    """The free variables of a function of the JAX algorithm (of its
    jitted update: the losses)."""
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def grads_close(got, want):
    """The port's gradients (tensors) against a JAX gradient tree."""
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def transitions(n, kind, seed):
    """A replay batch of ``n`` seeded rows shaped as CartPole's or
    Pendulum's: episodes of 5-40 steps, each ended by a termination or a
    truncation."""
    rng = np.random.default_rng(seed)
    obs_dim = 4 if kind == "cartpole" else 3
    ends = np.zeros(n, bool)
    t = 0
    while t < n:
        t += int(rng.integers(5, 40))
        if t <= n:
            ends[t - 1] = True
    term = ends & (rng.random(n) < 0.6)
    trunc = ends & ~term
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        SampleBatch.NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(
            np.float32),
        SampleBatch.ACTIONS: (rng.integers(0, 2, n) if kind == "cartpole"
                              else rng.uniform(-2, 2, (n, 1)).astype(
                                  np.float32)),
        SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
        SampleBatch.TERMINATEDS: term.astype(np.float32),
        SampleBatch.TRUNCATEDS: trunc.astype(np.float32),
        SampleBatch.EPS_ID: np.concatenate([[0], np.cumsum(ends)[:-1]]),
    })
