"""Parameters of the port's models against the JAX package's trees.

The JAX package keeps a model's parameters in a nested tree: dicts, and
for the diffusion UNet lists of dicts (``params["down"][si]["blocks"][i]``).
A stack of identical layers is one subtree whose leaves carry a leading
``[L, ...]`` axis for ``lax.scan`` (``params["layers"]`` in GPT, Llama,
ViT and BERT; ``params["encoder"]`` and ``params["decoder"]`` in T5).

The port's models are ``nn.Module`` trees whose parameter names follow the
JAX tree's path, list indices included, except inside a stack: its layers
are an ``nn.ModuleList`` of separate modules. A model names its stacks in
``jax_stacks``, ``{key of the stacked subtree: attribute of the
ModuleList}``, such as GPT's ``{"layers": "blocks"}``.

A JAX leaf is named by its path joined with dots (``"layers.wq"``,
``"down.0.blocks.1.conv1"``), and its *group* lists the port's tensors
that hold it: the tensor of the same name, or for a stacked leaf one
tensor per layer (``["blocks.0.wq", ..., "blocks.{L-1}.wq"]``). So a leaf
is stacked exactly when its group is not its own name (:func:`stacked`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch import nn

Groups = Dict[str, List[str]]


def stacked(key: str, names: List[str]) -> bool:
    """Whether the JAX leaf ``key`` is stacked over the tensors ``names``."""
    return names != [key]


def leaf_groups(model: nn.Module) -> Groups:
    """The JAX leaves of ``model``, each with the names of the port's
    tensors that hold it, in ``named_parameters`` order: ``"wte"`` →
    ``["wte"]``; a stacked leaf such as ``"layers.wq"`` →
    ``["blocks.0.wq", ..., "blocks.{L-1}.wq"]``, the slices of its leading
    ``[L, ...]`` axis in order."""
    by_attr = {attr: key for key, attr in model.jax_stacks.items()}
    groups: Groups = {}
    for name, _ in model.named_parameters():
        head, _, rest = name.partition(".")
        if head in by_attr:
            leaf = rest.partition(".")[2]
            key = f"{by_attr[head]}.{leaf}"
        else:
            key = name
        groups.setdefault(key, []).append(name)
    return groups


def nest(groups: Groups, leaf: Callable[[str, List[str]], Any]
         ) -> Dict[str, Any]:
    """The JAX package's nested tree of the leaves of ``groups``, each
    ``leaf(key, names)``: dicts by path, and a list where the keys of a
    level are the indices ``0..n-1``."""
    tree: Dict[str, Any] = {}
    for key, names in groups.items():
        *outer, last = key.split(".")
        node = tree
        for part in outer:
            node = node.setdefault(part, {})
        node[last] = leaf(key, names)
    return _lists(tree)


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def lookup(tree: Any, key: str) -> Any:
    """The leaf of the nested ``tree`` at the dotted path ``key``."""
    node = tree
    for part in key.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) \
            else node[part]
    return node


def specs_by_leaf(model: nn.Module, specs: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """Each JAX leaf's PartitionSpec, keyed as :func:`leaf_groups`:
    ``specs`` is the model's ``param_specs``, nested as the JAX tree, in
    which a stacked leaf's spec lacks its layer axis; here it has that
    axis's ``None`` first, as the JAX package's spec of the stacked leaf
    (T5's ``encoder`` and ``decoder`` alike)."""
    out = {}
    for key, names in leaf_groups(model).items():
        spec = lookup(specs, key)
        out[key] = type(spec)(None, *spec) if stacked(key, names) else spec
    return out


def jax_specs(model: nn.Module, specs: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's nested spec tree of ``model``'s parameters (of
    :func:`specs_by_leaf`), shaped as :func:`to_jax_params`' tree."""
    by_leaf = specs_by_leaf(model, specs)
    return nest(leaf_groups(model), lambda key, names: by_leaf[key])


def _assign(param: nn.Parameter, arr, name: str) -> None:
    from ray_tpu_torch.parallel.sharding import local, local_block
    t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                         f"the config's {tuple(param.shape)}")
    local(param).copy_(local_block(t, param))


def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy ``params`` (the JAX package's tree, numpy leaves, stacks on a
    leading ``[L, ...]`` axis) into ``model``'s tensors; returns
    ``model``. Values are copied into each tensor's dtype; a model placed
    on a mesh takes each rank's block."""
    named = dict(model.named_parameters())
    with torch.no_grad():
        for key, names in leaf_groups(model).items():
            arr = lookup(params, key)
            if not stacked(key, names):
                _assign(named[key], arr, key)
                continue
            arr = np.asarray(arr)
            for i, name in enumerate(names):
                _assign(named[name], arr[i], f"{key}[{i}]")
    return model


def to_jax_params(model: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`load_jax_params`: the JAX package's tree of
    ``model``'s parameters with numpy leaves, stacks on a leading ``[L,
    ...]`` axis."""
    named = dict(model.named_parameters())

    def leaf(key, names):
        arrs = [named[n].detach().cpu().numpy() for n in names]
        return np.stack(arrs) if stacked(key, names) else arrs[0]

    return nest(leaf_groups(model), leaf)
