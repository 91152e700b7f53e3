"""An RLlib algorithm's learner state, in the JAX package's layout.

``Algorithm.save`` stores only the policy's weights, in both packages. The
value-based and actor-critic learners keep the rest on the algorithm
object: DQN its target network and Adam state, SAC its twin critics,
their targets, the temperature ``log_alpha`` and three Adam states, TD3
its critics, both targets and two Adam states, the on-policy learners
their optimizer state, ES its flat parameter vector. Each algorithm names
these attributes, with the JAX algorithm's names, in ``_learner_trees``
(parameter trees), ``_learner_opts`` (optimizer states, each with the
parameters it steps) and ``_learner_values`` (counters and scalars).
``"params"`` is the policy's parameters, or the algorithm's own where it
learns without a policy (QMix, MADDPG, SlateQ, AlphaZero, Dreamer, DT,
AlphaStar: ``_owns_params``). The
parameters of an optimizer state are an attribute, or a path into one
("params/actors"); a list of states steps the list of trees at that path,
one each (MADDPG's per-agent Adams, MBMPO's ensemble); a dict of states
steps the dict of trees at that path, one per key (AlphaStar's learners,
whose parameters are a dict by policy id); a dict ``{label: path}`` is one
``optax.multi_transform`` state over the labelled subtrees (SlateQ's two
Adams), held as a dict of states by label.

:func:`learner_state` returns them as numpy trees laid out as the JAX
algorithm holds them (optax's layout for optimizer states,
``parallel.optim.to_optax_state``), and :func:`load_learner_state` copies
such a tree in: ``jax.tree.map(np.asarray, getattr(jax_algo, name))`` for
each name, and the JAX policy's parameters under ``"params"``, resume the
JAX learner in the port (and the other way round).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.policy.torch_policy import (named_leaves, to_numpy,
                                                     tree_map)


def target_copy(tree: Any) -> Any:
    """A target network: a copy of ``tree`` that takes no gradients."""
    return tree_map(lambda t: t.detach().clone(), tree)


def polyak(params: Any, target: Any, tau: float) -> None:
    """``target <- tau * params + (1 - tau) * target``, in place."""
    with torch.no_grad():
        for p, t in zip(named_leaves(params).values(),
                        named_leaves(target).values()):
            t.copy_(tau * p + (1 - tau) * t)


def _dotted(state: Any) -> Any:
    """An optimizer state (``init_optimizer``'s, its moments keyed by
    path, "pi/0/w") with its moments keyed by the dotted JAX path
    ("pi.0.w") that ``parallel.optim``'s optax layout nests by; the same
    tensors."""
    if isinstance(state, tuple):
        return tuple(_dotted(s) for s in state)
    return {k: ({n.replace("/", "."): t for n, t in v.items()}
                if k in ("mu", "nu") else v) for k, v in state.items()}


def _groups(params: Any) -> Dict[str, list]:
    """Each leaf of ``params`` a JAX leaf of its own, by its dotted path
    (a bare leaf is the key "")."""
    return {name.replace("/", "."): [name.replace("/", ".")]
            for name in named_leaves(params)}


def _params(algo, path: str) -> Any:
    """The parameters at ``path``: an attribute ("params" the learned
    parameters), then keys or list indices into it."""
    name, *keys = path.split("/")
    if name != "params":
        node = getattr(algo, name)
    elif algo._owns_params:
        node = algo.params
    else:
        node = algo.local_policy.params
    for key in keys:
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


def _optax(state: Any, params: Any) -> Any:
    return optim.to_optax_state(_dotted(state), _groups(params))


def _opt_state(algo, name: str, of) -> Any:
    """The optimizer state ``name`` in optax's layout, its tensors the
    state's own (not copies)."""
    state = getattr(algo, name)
    if isinstance(of, dict):
        # optax.multi_transform: each label's state masks the other
        # labels' subtrees out of its moments (no leaves there).
        return {"inner_states": {
            label: (_optax(state[label], {label: _params(algo, path)}),)
            for label, path in sorted(of.items())}}
    params = _params(algo, of)
    if isinstance(state, list):
        return [_optax(s, p) for s, p in zip(state, params)]
    if isinstance(state, dict):  # one optimizer state (a chain's tuple) a key
        return {k: _optax(state[k], params[k]) for k in sorted(state)}
    return _optax(state, params)


def flat_leaves(tree: Any) -> list:
    """The leaves of a tree in ``jax.tree_util``'s order: dict keys
    sorted, lists and tuples (named ones too) in order; an empty tuple
    (optax's ``EmptyState``, ``MaskedNode``) has none."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat_leaves(v)]
    return [tree]


def _copy_leaves(dst: Any, src: Any, where: str) -> None:
    """Each leaf of ``src`` into the tensor at its place in ``dst``, in
    leaf order; shapes and dtypes must match exactly."""
    dst, src = flat_leaves(dst), flat_leaves(src)
    if len(dst) != len(src):
        raise ValueError(f"{where}: {len(src)} leaves for {len(dst)}")
    with torch.no_grad():
        for i, (t, v) in enumerate(zip(dst, src)):
            v = torch.from_numpy(np.array(v))
            if v.dtype != t.dtype or v.shape != t.shape:
                raise ValueError(
                    f"{where}: leaf {i} is {v.dtype} {tuple(v.shape)} for "
                    f"{t.dtype} {tuple(t.shape)}")
            t.copy_(v)


def _tensor_tree(tree: Any, like: Any) -> Any:
    """A numpy tree as tensors on the device of the tree ``like``'s
    leaves, in their dtype, taking gradients where they take them."""
    return tree_map(
        lambda a, t: torch.tensor(np.asarray(a), dtype=t.dtype,
                                  device=t.device).requires_grad_(
                                      t.requires_grad), tree, like)


def learner_state(algo) -> Dict[str, Any]:
    """The learner's state as numpy trees in the JAX algorithm's layout,
    keyed by the JAX algorithm's attribute names (``"params"``: the
    learned parameters)."""
    out = {"params": to_numpy(_params(algo, "params"))}
    for name in algo._learner_trees:
        out[name] = to_numpy(getattr(algo, name))
    for name, of in algo._learner_opts.items():
        out[name] = to_numpy(_opt_state(algo, name, of))
    for name in algo._learner_values:
        out[name] = getattr(algo, name)
    return out


def load_learner_state(algo, state: Dict[str, Any]) -> None:
    """Copy ``state`` (:func:`learner_state`'s layout, from either
    package) into ``algo``'s learner, on its device; every name the
    algorithm declares must be there, and every shape and dtype must
    match its own. optax's named tuples (``jax.tree.map(np.asarray,
    state)`` of the JAX algorithm's) are read as tuples."""
    params = _tensor_tree(state["params"], _params(algo, "params"))
    if algo._owns_params:
        algo.params = params
    else:
        algo.local_policy.params = params
    for name in algo._learner_trees:
        setattr(algo, name, _tensor_tree(state[name], getattr(algo, name)))
    for name, of in algo._learner_opts.items():
        _copy_leaves(_opt_state(algo, name, of), state[name], name)
    for name in algo._learner_values:
        setattr(algo, name, state[name])
    sync = getattr(algo, "_after_load", None)
    if sync is not None:
        sync()
