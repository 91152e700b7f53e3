"""QPolicy: epsilon-greedy Q-network policy for value-based algorithms.

The port of ``ray_tpu/rllib/policy/q_policy.py`` (the reference's
rllib/algorithms/dqn, the torch DQNTorchPolicy's action sampler): the
worker holds the online Q parameters and an exploration epsilon (synced
from the learner with the weights, so the schedule is driven centrally);
the learner (``algorithms/dqn.py``) owns the target network and the
double-DQN update.

The parameters are the JAX package's tree (``{"encoder", "head"}``, or
``{"encoder", "adv_head", "value_head"}`` for the dueling streams) with
tensors for leaves, drawn from a ``torch.Generator`` on the host and
placed on ``device`` (None is the CUDA card and raises without one). The
action space is read by its attributes, without gymnasium.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.models.catalog import (ModelCatalog, mlp_apply,
                                                mlp_init)
from ray_tpu_torch.rllib.policy.torch_policy import (action_dims, as_tensor,
                                                     from_jax_params,
                                                     to_numpy)


class QPolicy:
    needs_gae = False

    def __init__(self, obs_space, action_space: Any,
                 model_config: Dict[str, Any] = None, seed: int = 0,
                 device=None):
        discrete, act_dim = action_dims(action_space)
        if not discrete:
            raise ValueError("QPolicy requires a Discrete action space")
        self.device = resolve_device(device)
        self.discrete = True
        self.action_space = action_space
        self.act_dim = act_dim
        model_config = model_config or {}
        enc_init, self._encode, feat_dim = ModelCatalog.get_encoder(
            obs_space, model_config)
        gen = torch.Generator().manual_seed(seed)
        if model_config.get("dueling"):
            # Dueling architecture (reference: dqn dueling=True): separate
            # state-value and advantage streams, combined with the
            # mean-advantage identifiability constraint.
            self.params = {
                "encoder": enc_init(gen, self.device),
                "adv_head": mlp_init(gen, [feat_dim, self.act_dim],
                                     self.device),
                "value_head": mlp_init(gen, [feat_dim, 1], self.device),
            }
        else:
            self.params = {
                "encoder": enc_init(gen, self.device),
                "head": mlp_init(gen, [feat_dim, self.act_dim], self.device),
            }
        self.epsilon = 1.0
        # APEX-style per-worker exploration: a fixed epsilon survives
        # weight broadcasts (set by RolloutWorker when configured).
        self.fixed_epsilon = False

    def make_generator(self, seed: int) -> torch.Generator:
        """An exploration generator on this policy's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- functional core -------------------------------------------------

    def q_values(self, params, obs):
        feats = self._encode(params["encoder"], obs)
        if "value_head" in params:
            value = mlp_apply(params["value_head"], feats)
            adv = mlp_apply(params["adv_head"], feats)
            return value + adv - adv.mean(-1, keepdim=True)
        return mlp_apply(params["head"], feats)

    # -- worker-side API -------------------------------------------------

    def compute_actions(self, obs: np.ndarray, gen: torch.Generator
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Greedy actions, each replaced by a uniform one with probability
        epsilon: two draws from ``gen``."""
        n = obs.shape[0]
        with torch.no_grad():
            greedy = self.q_values(self.params, as_tensor(obs, self.device)
                                   ).argmax(-1)
        explore = torch.rand((n,), generator=gen,
                             device=self.device) < self.epsilon
        random_a = torch.randint(0, self.act_dim, (n,), generator=gen,
                                 device=self.device)
        actions = torch.where(explore, random_a, greedy).cpu().numpy()
        zeros = np.zeros((n,), np.float32)
        return actions, zeros, zeros

    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            q = self.q_values(self.params, as_tensor(obs, self.device))
        return q.max(-1).values.cpu().numpy()

    def get_weights(self):
        return {"params": to_numpy(self.params), "epsilon": self.epsilon}

    def set_weights(self, weights) -> None:
        if isinstance(weights, dict) and "params" in weights:
            self.params = from_jax_params(weights["params"], self.device)
            if not self.fixed_epsilon:
                self.epsilon = float(weights.get("epsilon", self.epsilon))
        else:
            self.params = from_jax_params(weights, self.device)
