"""RLModule: the functional network unit of the new stack.

The port of ``ray_tpu/rllib/core/rl_module.py``: a module is a pair of
pure functions, ``init(gen, device) -> params`` and forwards taking
``params`` explicitly, so a Learner differentiates them and a rollout
worker runs the identical forwards with weights copied to its device.
The parameters are the JAX package's tree with tensors for leaves, read
from a numpy tree of either package by ``torch_policy.from_jax_params``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.models.catalog import mlp_apply, mlp_init
from ray_tpu_torch.rllib.policy.torch_policy import (action_dims,
                                                     dist_entropy, dist_logp,
                                                     gumbel_argmax)


class RLModule:
    """Base class. Subclasses define the param init and the three
    forwards; all are pure (params in, tensors out)."""

    def init(self, gen: torch.Generator, device=None) -> Any:
        raise NotImplementedError

    def forward_train(self, params, batch: Dict[str, Any]
                      ) -> Dict[str, Any]:
        """Outputs needed by the loss (logits, values, logps, ...)."""
        raise NotImplementedError

    def forward_exploration(self, params, obs, gen: torch.Generator):
        """Stochastic actions for rollouts → (actions, extras dict)."""
        raise NotImplementedError

    def forward_inference(self, params, obs):
        """Deterministic actions for serving/eval."""
        raise NotImplementedError


@dataclass
class RLModuleSpec:
    """Analog of the reference's SingleAgentRLModuleSpec: everything
    needed to construct the module on any process."""

    module_class: type
    observation_space: Any = None
    action_space: Any = None
    model_config: Dict[str, Any] = field(default_factory=dict)

    def build(self) -> "RLModule":
        return self.module_class(self.observation_space,
                                 self.action_space, self.model_config)


class MLPActorCriticModule(RLModule):
    """The catalog MLP actor-critic as an RLModule (discrete or box). The
    spaces are read from their attributes (``torch_policy.action_dims``),
    so building one imports no gymnasium."""

    def __init__(self, observation_space, action_space,
                 model_config: Optional[Dict[str, Any]] = None):
        model_config = model_config or {}
        self.hiddens = tuple(model_config.get("fcnet_hiddens", (64, 64)))
        self.obs_dim = int(np.prod(observation_space.shape))
        self.discrete, self.act_dim = action_dims(action_space)

    def init(self, gen, device=None):
        params = {
            "pi": mlp_init(gen, [self.obs_dim, *self.hiddens,
                                 self.act_dim], device),
            "vf": mlp_init(gen, [self.obs_dim, *self.hiddens, 1], device),
        }
        if not self.discrete:
            params["log_std"] = torch.zeros(self.act_dim, device=device,
                                            requires_grad=True)
        return params

    # -- distribution helpers -------------------------------------------

    def _logits(self, params, obs):
        return mlp_apply(params["pi"], obs)

    def _values(self, params, obs):
        return mlp_apply(params["vf"], obs)[..., 0]

    # -- RLModule API ----------------------------------------------------

    def forward_train(self, params, batch):
        obs = batch["obs"]
        logits = self._logits(params, obs)
        log_std = params.get("log_std")
        return {
            "logits": logits,
            "values": self._values(params, obs),
            "logp": dist_logp(self.discrete, logits, batch["actions"],
                              log_std),
            "entropy": dist_entropy(self.discrete, logits, log_std),
        }

    def forward_exploration(self, params, obs, gen):
        logits = self._logits(params, obs)
        if self.discrete:
            actions = gumbel_argmax(logits, gen)
        else:
            std = torch.exp(params["log_std"])
            actions = logits + std * torch.randn(
                logits.shape, generator=gen, device=logits.device)
        return actions, {"values": self._values(params, obs)}

    def forward_inference(self, params, obs):
        logits = self._logits(params, obs)
        return logits.argmax(-1) if self.discrete else logits
