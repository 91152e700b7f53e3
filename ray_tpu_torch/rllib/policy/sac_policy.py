"""SACPolicy: squashed-Gaussian actor for soft actor-critic; TD3Policy.

The port of ``ray_tpu/rllib/policy/sac_policy.py`` (the reference's
rllib/algorithms/sac): a tanh-squashed diagonal-Gaussian actor rescaled
to the Box bounds. The twin Q critics, their targets and the temperature
live in the learner (``algorithms/sac.py``).

The JAX policy draws its Gaussian noise from a PRNG key inside the jitted
sample; here :meth:`SACPolicy.sample` takes the standard-normal noise
``eps`` as a tensor, so a learner draws it from its generator and a test
can hand it the JAX key's draws. The parameters are the JAX package's
tree (``{"encoder", "head"}``) on ``device`` (None is the CUDA card and
raises without one). The Box is read by its attributes (``low``,
``high``, ``shape``), without gymnasium.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.models.catalog import (ModelCatalog, mlp_apply,
                                                mlp_init)
from ray_tpu_torch.rllib.policy.torch_policy import (action_dims, as_tensor,
                                                     from_jax_params,
                                                     to_numpy)

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def box_bounds(action_space) -> Tuple[np.ndarray, np.ndarray]:
    """The flat float32 bounds of a Box, read as the JAX package reads
    them after ``isinstance(space, gym.spaces.Box)``: only a Box has
    ``low`` and ``high``."""
    if action_dims(action_space)[0] or not (
            hasattr(action_space, "low") and hasattr(action_space, "high")):
        raise ValueError("SACPolicy requires a Box action space")
    return (np.asarray(action_space.low, np.float32).reshape(-1),
            np.asarray(action_space.high, np.float32).reshape(-1))


class SACPolicy:
    needs_gae = False

    def __init__(self, obs_space, action_space: Any,
                 model_config: Dict[str, Any] = None, seed: int = 0,
                 device=None):
        self.low, self.high = box_bounds(action_space)
        self.device = resolve_device(device)
        self.discrete = False
        self.action_space = action_space
        self.act_dim = action_dims(action_space)[1]
        self.low_t = torch.from_numpy(self.low).to(self.device)
        self.high_t = torch.from_numpy(self.high).to(self.device)
        model_config = model_config or {}
        enc_init, self._encode, feat_dim = ModelCatalog.get_encoder(
            obs_space, model_config)
        gen = torch.Generator().manual_seed(seed)
        self.params = {
            "encoder": enc_init(gen, self.device),
            # One head emitting [mu, log_std].
            "head": mlp_init(gen, [feat_dim, 2 * self.act_dim], self.device),
        }

    def make_generator(self, seed: int) -> torch.Generator:
        """A sampling generator on this policy's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- functional core -------------------------------------------------

    def dist_params(self, params, obs):
        feats = self._encode(params["encoder"], obs)
        out = mlp_apply(params["head"], feats)
        mu, log_std = torch.chunk(out, 2, dim=-1)
        return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def scale(self, a):
        """A tanh-squashed action in [-1, 1] rescaled to the Box."""
        return self.low_t + (a + 1.0) * 0.5 * (self.high_t - self.low_t)

    def sample(self, params, obs, eps):
        """Reparameterized squashed sample at standard-normal noise ``eps``
        (the mean's shape) → (env_action, logp)."""
        mu, log_std = self.dist_params(params, obs)
        std = torch.exp(log_std)
        pre_tanh = mu + std * eps
        a = torch.tanh(pre_tanh)
        # logp with tanh change-of-variables correction.
        gauss_logp = (-0.5 * (eps ** 2 + 2 * log_std
                              + math.log(2 * math.pi))).sum(-1)
        correction = torch.log(1 - a ** 2 + 1e-6).sum(-1)
        logp = gauss_logp - correction
        return self.scale(a), logp

    def logp_and_sample(self, params, obs, eps):
        """Used by the learner's actor/critic losses (the same math)."""
        return self.sample(params, obs, eps)

    def noise(self, obs: torch.Tensor, gen: torch.Generator
              ) -> torch.Tensor:
        """Standard-normal noise for :meth:`sample` on ``obs`` [B, ...]:
        one draw from ``gen``."""
        return torch.randn((obs.shape[0], self.act_dim), generator=gen,
                           device=obs.device)

    # -- worker-side API -------------------------------------------------

    def compute_actions(self, obs: np.ndarray, gen: torch.Generator
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        x = as_tensor(obs, self.device)
        with torch.no_grad():
            a, logp = self.sample(self.params, x, self.noise(x, gen))
        zeros = np.zeros((obs.shape[0],), np.float32)
        return a.cpu().numpy(), logp.cpu().numpy(), zeros

    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        return np.zeros((obs.shape[0],), np.float32)

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights, self.device)


class TD3Policy(SACPolicy):
    """Deterministic actor + fixed Gaussian exploration noise (canonical
    TD3 behavior policy). Reuses SACPolicy's network but ignores the
    log_std head at rollout: TD3's actor loss trains only the mean, so the
    sampled-std path would leave exploration scale untrained."""

    EXPLORATION_SIGMA = 0.1  # fraction of the half action range

    def deterministic(self, params, obs):
        mu, _ = self.dist_params(params, obs)
        return self.scale(torch.tanh(mu))

    def compute_actions(self, obs: np.ndarray, gen: torch.Generator):
        x = as_tensor(obs, self.device)
        with torch.no_grad():
            a = self.deterministic(self.params, x)
        noise = torch.randn(a.shape, generator=gen, device=a.device)
        a = a.cpu().numpy()
        noise = noise.cpu().numpy() * self.EXPLORATION_SIGMA * (
            self.high - self.low) * 0.5
        a = np.clip(a + noise, self.low, self.high)
        zeros = np.zeros((obs.shape[0],), np.float32)
        return a.astype(np.float32), zeros, zeros
