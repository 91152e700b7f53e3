"""An RLlib algorithm's learner state, in the JAX package's layout.

``Algorithm.save`` stores only the policy's weights, in both packages. The
value-based and actor-critic learners keep the rest on the algorithm
object: DQN its target network and Adam state, SAC its twin critics,
their targets, the temperature ``log_alpha`` and three Adam states, TD3
its critics, both targets and two Adam states, the on-policy learners
their optimizer state, ES its flat parameter vector. Each algorithm names
these attributes, with the JAX algorithm's names, in ``_learner_trees``
(parameter trees), ``_learner_opts`` (optimizer states, each with the
attribute of the parameters it steps; ``"params"`` is the policy's) and
``_learner_values`` (counters and scalars).

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


def _params(algo, name: str) -> Any:
    return algo.local_policy.params if name == "params" else getattr(
        algo, name)


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
    policy's parameters)."""
    out = {"params": to_numpy(algo.local_policy.params)}
    for name in algo._learner_trees:
        out[name] = to_numpy(getattr(algo, name))
    for name, of in algo._learner_opts.items():
        out[name] = to_numpy(optim.to_optax_state(
            _dotted(getattr(algo, name)), _groups(_params(algo, of))))
    for name in algo._learner_values:
        out[name] = getattr(algo, name)
    return out


def load_learner_state(algo, state: Dict[str, Any]) -> None:
    """Copy ``state`` (:func:`learner_state`'s layout, from either
    package) into ``algo``'s learner, on its device; every name the
    algorithm declares must be there, and every shape and dtype must
    match its own."""
    policy = algo.local_policy
    policy.params = _tensor_tree(state["params"], policy.params)
    for name in algo._learner_trees:
        setattr(algo, name, _tensor_tree(state[name], getattr(algo, name)))
    for name, of in algo._learner_opts.items():
        optim.from_optax_state(state[name], _dotted(getattr(algo, name)),
                               _groups(_params(algo, of)))
    for name in algo._learner_values:
        setattr(algo, name, state[name])
    sync = getattr(algo, "_after_load", None)
    if sync is not None:
        sync()
