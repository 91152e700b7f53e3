"""The harness of the RLlib parity tests (``tests/test_torch_rllib_q.py``,
``tests/test_torch_rllib_pg.py``): a JAX algorithm and the port's built
bare, the port's learner state carried over from the JAX one's, and the
two held to each other.

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


def jax_state(jalgo, algo):
    """The JAX learner's state under the names the port's algorithm
    declares, as numpy trees (``learner_state``'s layout)."""
    state = {"params": jax.tree.map(np.asarray, jalgo.local_policy.params)}
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
        want = (jalgo.local_policy.params if name == "params"
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
