"""Helpers of the model zoo's parity tests (``tests/test_torch_diffusion.py``,
``test_torch_vit.py``, ``test_torch_bert.py``, ``test_torch_t5.py``).

Parameters are drawn with numpy from a fixed seed into the tree that the
JAX package's ``init`` returns (its shapes and dtypes, from
``jax.eval_shape``: no compile), every leaf random, norm scales and biases
included; the port's model is built from them with ``from_jax_params``.
Leaves are named by their dotted path in the JAX tree (list indices
included), which are the keys of the port's ``leaf_groups``.
"""

import zlib

import jax
import numpy as np
import optax
import torch

from ray_tpu_torch.models import _params
from ray_tpu_torch.parallel import optim

# 3 Adam steps from the same weights and batches (tests/test_torch_llama.py's
# bounds): the losses to summation order; each leaf's parameters to 1e-3 of
# the norm of its change, a wrong gradient or step changes it by O(1).
# Adam divides each element's step by its gradient's RMS (+ eps 1e-8), so
# an element whose gradient came within SMALL_GRAD of 0 at some step takes
# a step set by the gradients' summation-order noise (~4e-8 on t5-tiny):
# those elements are held apart, each to the most Adam moves one, the
# learning rate per step.
STEP_RTOL = 1e-5
UPDATE_RTOL = 1e-3
SMALL_GRAD = 1e-6

_PARAMS = {}


def flatten(tree, prefix=""):
    """``{dotted path: leaf}`` of a tree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, val in items:
        if isinstance(val, (dict, list)):
            out.update(flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _is_scale(name):
    leaf = name.rsplit(".", 1)[-1]
    return leaf.endswith(("scale", "_s", "_ln")) or leaf.startswith("ln")


def jax_params(module, preset, stacks=("layers", "encoder", "decoder"),
               **overrides):
    """A numpy tree shaped as ``module.init``'s (cached): weights N(0,
    1/fan_in) over all but their last axis (and the leading layer axis of
    a leaf under ``stacks``), norm scales 1 + N(0, 0.1²), biases N(0,
    0.1²)."""
    key = (module.__name__, preset, tuple(sorted(overrides.items())))
    if key not in _PARAMS:
        cfg = module.config(preset, **overrides)
        shapes = flatten(jax.eval_shape(lambda k: module.init(cfg, k),
                                        jax.random.PRNGKey(0)))
        rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
        leaves = {}
        for name, leaf in shapes.items():
            core = leaf.shape[1:] if name.split(".")[0] in stacks \
                else leaf.shape
            x = rng.standard_normal(leaf.shape)
            if len(core) > 1:
                x = x / np.sqrt(np.prod(core[:-1]))
            else:
                x = x * 0.1 + _is_scale(name)
            leaves[name] = x.astype(leaf.dtype)
        _PARAMS[key] = _params.nest({n: [n] for n in leaves},
                                    lambda n, _: leaves[n])
    return _PARAMS[key]


def assert_round_trip(params, model):
    back = flatten(_params.to_jax_params(model))
    want = flatten(params)
    assert sorted(back) == sorted(want) == sorted(
        _params.leaf_groups(model))
    for name, arr in want.items():
        assert back[name].dtype == arr.dtype, name
        assert np.array_equal(back[name], arr), name


def _grad(p):
    """A parameter's gradient; zeros where the loss does not reach it, as
    ``jax.grad`` gives."""
    return np.zeros(p.shape, np.float32) if p.grad is None else \
        p.grad.numpy()


def grads_by_leaf(model):
    """The port's gradients as the JAX leaves (stacked leaves stacked)."""
    named = dict(model.named_parameters())
    return {leaf: np.stack([_grad(named[n]) for n in names])
            if _params.stacked(leaf, names) else _grad(named[names[0]])
            for leaf, names in _params.leaf_groups(model).items()}


def assert_grads_match(model, ref_grads, tol):
    want = flatten(jax.tree_util.tree_map(np.asarray, ref_grads))
    got = grads_by_leaf(model)
    assert sorted(want) == sorted(got)
    for leaf, arr in want.items():
        np.testing.assert_allclose(got[leaf], arr, atol=tol, rtol=tol,
                                   err_msg=leaf)


def jax_value_and_grad(loss):
    """``jax.value_and_grad(loss(params, batch))`` jitted, under "highest"
    matmul precision; a test file makes one and shares it between its
    gradient and Adam tests, so that the model's backward compiles once."""
    grad = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def run(params, batch):
        with jax.default_matmul_precision("highest"):
            return grad(params, batch)
    return run


def assert_adam_steps_match(value_and_grad, port_loss, params0, model,
                            batches, lr=1e-3):
    """``len(batches)`` steps of ``optax.adam(lr)`` over
    ``value_and_grad(params, batch)`` (from :func:`jax_value_and_grad`)
    against the port's ``optim.adamw`` at weight decay 0 over
    ``port_loss(model, batch)`` (a 0-d tensor), from the same weights
    ``params0``."""
    opt = optax.adam(lr)

    @jax.jit
    def update(params, state, grads):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    params, state, ref_losses, small = params0, opt.init(params0), [], {}
    for batch in batches:
        (loss, _), grads = value_and_grad(params, batch)
        params, state = update(params, state, grads)
        ref_losses.append(float(loss))
        for leaf, g in flatten(grads).items():
            small[leaf] = small.get(leaf, False) | (
                np.abs(np.asarray(g)) < SMALL_GRAD)
    ref = flatten(jax.tree_util.tree_map(np.asarray, params))

    named = dict(model.named_parameters())
    topt = optim.adamw(lambda count: torch.tensor(lr, dtype=torch.float32),
                       weight_decay=0.0)
    tstate = topt.init(named, _params.leaf_groups(model))
    losses = []
    for batch in batches:
        loss = port_loss(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(named.values(), grads)]
        with torch.no_grad():
            updates, tstate = topt.update(dict(zip(named, grads)), tstate,
                                          named)
            optim.apply_updates(named, updates)
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, ref_losses, rtol=STEP_RTOL)
    got, p0 = flatten(_params.to_jax_params(model)), flatten(params0)
    for leaf, want in ref.items():
        diff = got[leaf] - want
        still = want == p0[leaf]  # e.g. a leaf the loss does not reach
        assert np.all(diff[still] == 0), leaf
        keep = ~small[leaf]
        assert np.all(np.abs(diff[~keep]) <= lr * len(batches)), leaf
        if keep.any():
            moved = np.linalg.norm((want - p0[leaf])[keep])
            err = np.linalg.norm(diff[keep]) / moved
            assert err <= UPDATE_RTOL, (leaf, err)


def assert_specs_match(port, ref, stacks=()):
    """``port`` (the port's ``param_specs``) is ``ref`` (the JAX package's)
    leaf for leaf, a stacked leaf's less its leading (None) layer entry."""
    port, ref = flatten(port), flatten(ref)
    assert sorted(port) == sorted(ref)
    for name, spec in ref.items():
        if name.split(".")[0] in stacks:
            assert spec[0] is None, name
            spec = tuple(spec)[1:]
        assert tuple(port[name]) == tuple(spec), name
