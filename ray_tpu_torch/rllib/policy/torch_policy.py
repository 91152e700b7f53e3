"""TorchPolicy: actor-critic policy as a tree of tensors + functions.

The port of ``ray_tpu/rllib/policy/jax_policy.py`` (``JAXPolicy``): an MLP
torso with policy and value heads (or the catalog's CNN as a shared torso
for image observations), categorical (discrete) or diagonal-gaussian (box)
action distributions, functional in its parameters (``params`` in,
actions or losses out), so a learner differentiates the same functions a
rollout worker samples with.

The parameters are the JAX package's tree (``{"pi": [{"w", "b"}, ...],
"vf": [...], "enc"?, "log_std"?}``) with tensors for leaves;
:func:`from_jax_params` reads a numpy tree of either package, and
``get_weights`` returns one. JAX's PRNG keys become a ``torch.Generator``
(``make_generator``): the sampler draws once from it per step, where the
JAX policy splits its key inside the step's jit. The policy lives on ``device`` (None is the
CUDA card and raises without one); rollout workers ask for the CPU.
Nothing here imports gymnasium: the action space is read from its
attributes (:func:`action_dims`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import jax_dtype, resolve_device
from ray_tpu_torch.rllib.models.catalog import (ModelCatalog, mlp_apply,
                                                mlp_init)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def action_dims(action_space) -> Tuple[bool, int]:
    """(discrete, act_dim) of a space, read as the JAX package reads it
    from ``isinstance(space, gym.spaces.Discrete)``: a discrete space has
    ``n`` and an empty shape (a ``MultiBinary`` has ``n`` and a shape), a
    box its shape's size."""
    discrete = (getattr(action_space, "n", None) is not None
                and tuple(getattr(action_space, "shape", ()) or ()) == ())
    if discrete:
        return True, int(action_space.n)
    return False, int(np.prod(action_space.shape))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map``: ``fn`` on every leaf of a tree of dicts, lists and
    tuples, and on the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _paths(tree: Any, prefix: str = "") -> Any:
    """The tree with each leaf replaced by its path ("pi/0/w")."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_paths(v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return prefix[:-1]


def named_leaves(tree: Any) -> Dict[str, Any]:
    """The leaves by path, in ``jax.tree_util``'s order (dict keys sorted,
    sequences in order): the names the optimizer keys its state by."""
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, (list, tuple)):
        keys = range(len(tree))
    else:
        return {"": tree}
    out = {}
    for k in keys:
        for path, leaf in named_leaves(tree[k]).items():
            out[f"{k}/{path}" if path else str(k)] = leaf
    return out


def unflatten(template: Any, named: Dict[str, Any]) -> Any:
    """``named`` (by path) laid out as the tree ``template``."""
    return tree_map(named.__getitem__, _paths(template))


def to_numpy(tree: Any) -> Any:
    """A tree of tensors as the numpy tree ``jax.tree.map(np.asarray,
    params)`` gives."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def from_jax_params(tree: Any, device=None) -> Any:
    """The reference's numpy parameter tree (pi, vf, enc, log_std; a JAX
    array leaf too) as the port's: float32 tensors on ``device`` that
    require gradients."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32),
                               device=dev).requires_grad_(), tree)


def as_tensor(x, device) -> torch.Tensor:
    """``jnp.asarray`` of a host array, on ``device``: 64-bit types as
    their 32-bit ones."""
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        x.astype(jax_dtype(x.dtype), copy=False))).to(device)


def dist_logp(discrete: bool, logits, actions, log_std=None):
    """Log-probability of ``actions``: categorical over ``logits``, or a
    diagonal gaussian of mean ``logits`` and ``log_std``."""
    if discrete:
        logp_all = torch.log_softmax(logits, -1)
        return torch.gather(logp_all, -1, actions[..., None].long())[..., 0]
    var = torch.exp(2 * log_std)
    return (-0.5 * (((actions - logits) ** 2) / var
                    + 2 * log_std + math.log(2 * math.pi))).sum(-1)


def dist_entropy(discrete: bool, logits, log_std=None):
    """Per-row entropy of the categorical; the gaussian's (one value)."""
    if discrete:
        p = torch.softmax(logits, -1)
        return -(p * torch.log_softmax(logits, -1)).sum(-1)
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum()


def gumbel_argmax(logits, gen: torch.Generator):
    """A categorical sample by the Gumbel-max trick, as
    ``jax.random.categorical`` draws one: one uniform draw from ``gen``."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    tiny = torch.finfo(logits.dtype).tiny
    return (logits - torch.log(-torch.log(u.clamp_min(tiny)))).argmax(-1)


class TorchPolicy:
    """Holds params + functions. Not itself an actor: rollout workers and
    the learner each own one."""

    def __init__(self, obs_dim: int, action_space: Any,
                 hiddens: Sequence[int] = (64, 64), seed: int = 0,
                 obs_space: Any = None,
                 model_config: Optional[Dict[str, Any]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.obs_dim = obs_dim
        self.action_space = action_space
        self.discrete, self.act_dim = action_dims(action_space)
        gen = torch.Generator().manual_seed(seed)
        out = self.act_dim
        # Image observations get the catalog CNN as a SHARED torso with
        # linear pi/vf heads; vector observations keep per-head MLP
        # torsos (as the JAX policy does).
        self._enc_apply = None
        if obs_space is not None and ModelCatalog.is_image_space(obs_space):
            enc_init, self._enc_apply, feat = ModelCatalog.get_encoder(
                obs_space, model_config or {})
            self.params = {
                "enc": enc_init(gen, self.device),
                "pi": mlp_init(gen, [feat, out], self.device),
                "vf": mlp_init(gen, [feat, 1], self.device),
            }
        else:
            self.params = {
                "pi": mlp_init(gen, [obs_dim, *hiddens, out], self.device),
                "vf": mlp_init(gen, [obs_dim, *hiddens, 1], self.device),
            }
        if not self.discrete:
            self.params["log_std"] = torch.zeros(
                self.act_dim, device=self.device, requires_grad=True)

    def make_generator(self, seed: int) -> torch.Generator:
        """A sampling generator on this policy's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- functional core -------------------------------------------------

    def _torso(self, params, obs):
        if self._enc_apply is not None:
            return self._enc_apply(params["enc"], obs)
        return obs if obs.is_floating_point() else obs.float()

    def logits(self, params, obs):
        return mlp_apply(params["pi"], self._torso(params, obs))

    def _value(self, params, obs):
        return mlp_apply(params["vf"], self._torso(params, obs))[..., 0]

    def logp(self, params, obs, actions):
        return dist_logp(self.discrete, self.logits(params, obs), actions,
                         params.get("log_std"))

    def entropy(self, params, obs):
        return dist_entropy(self.discrete, self.logits(params, obs),
                            params.get("log_std"))

    def _sample(self, params, obs, gen: torch.Generator):
        """One draw from ``gen``: Gumbel noise for a categorical, a normal
        for a gaussian."""
        logits = self.logits(params, obs)
        value = self._value(params, obs)
        if self.discrete:
            action = gumbel_argmax(logits, gen)
            logp = torch.log_softmax(logits, -1)[
                torch.arange(obs.shape[0], device=obs.device), action]
            return action, logp, value
        std = torch.exp(params["log_std"])
        noise = torch.randn(logits.shape, generator=gen,
                            device=logits.device)
        action = logits + std * noise
        logp = self.logp(params, obs, action)
        return action, logp, value

    # -- worker-side API -------------------------------------------------

    def compute_actions(self, obs: np.ndarray, gen: torch.Generator
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        with torch.no_grad():
            a, logp, v = self._sample(self.params,
                                      as_tensor(obs, self.device), gen)
        return a.cpu().numpy(), logp.cpu().numpy(), v.cpu().numpy()

    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            v = self._value(self.params, as_tensor(obs, self.device))
        return v.cpu().numpy()

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights, self.device)


def compute_gae(batch: SampleBatch, gamma: float = 0.99,
                lam: float = 0.95, last_value: float = 0.0) -> SampleBatch:
    """GAE(λ) advantages + value targets over one episode fragment
    (reference: rllib/evaluation/postprocessing.py compute_advantages)."""
    rewards = batch[SampleBatch.REWARDS].astype(np.float64)
    values = batch[SampleBatch.VF_PREDS].astype(np.float64)
    terminated = batch[SampleBatch.TERMINATEDS]
    n = len(rewards)
    next_values = np.append(values[1:], last_value)
    deltas = rewards + gamma * next_values * (1 - terminated) - values
    adv = np.zeros(n)
    acc = 0.0
    for t in reversed(range(n)):
        acc = deltas[t] + gamma * lam * (1 - terminated[t]) * acc
        adv[t] = acc
    batch[SampleBatch.ADVANTAGES] = adv.astype(np.float32)
    batch[SampleBatch.VALUE_TARGETS] = (adv + values).astype(np.float32)
    return batch
