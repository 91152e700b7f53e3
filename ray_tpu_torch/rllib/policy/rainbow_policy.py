"""Rainbow Q-policy: noisy nets + C51 distributional value heads.

The port of ``ray_tpu/rllib/policy/rainbow_policy.py``, the remaining two
Rainbow components (Hessel et al. 2018) on top of the DQN stack's
double-Q / dueling / n-step / prioritized replay (reference:
rllib/algorithms/dqn with num_atoms > 1 + noisy=True):

* **Noisy linear layers** (factorized Gaussian, Fortunato et al. 2017):
  each head layer carries (w_mu, w_sigma, b_mu, b_sigma); a forward pass
  given factorized noise perturbs the weights with it, and exploration
  comes from the noise itself, with no epsilon schedule.
* **C51 categorical distribution** (Bellemare et al. 2017): the head
  emits ``num_atoms`` logits per action over a fixed support
  [v_min, v_max]; Q(s,a) = sum_i p_i * z_i, and the learner minimizes
  cross-entropy against the projected target distribution.

Both compose with dueling: value and advantage streams each produce atom
logits, combined with the mean-advantage constraint per atom.

The JAX policy draws the noise from a PRNG key inside its forward; here
the factorized noise ``(eps_in, eps_out)`` of each head is an argument
(:func:`noisy_apply`), drawn by :meth:`RainbowPolicy.draw_noise` from a
``torch.Generator``, so a test can hand the port the JAX key's draws. The
parameters are the JAX package's tree (``{"encoder", "adv", "val"?}``) on
``device`` (None is the CUDA card and raises without one).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.models.catalog import ModelCatalog
from ray_tpu_torch.rllib.policy.torch_policy import (action_dims, as_tensor,
                                                     from_jax_params,
                                                     to_numpy)

Noise = Tuple[torch.Tensor, torch.Tensor]


def noisy_init(gen: torch.Generator, in_dim: int, out_dim: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Factorized-noisy linear parameters (mu uniform, sigma 0.5/sqrt)."""
    bound = 1.0 / math.sqrt(in_dim)

    def uniform(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (u * (2 * bound) - bound).to(device).requires_grad_()

    sigma = 0.5 / math.sqrt(in_dim)
    return {
        "w_mu": uniform((in_dim, out_dim)),
        "w_sigma": torch.full((in_dim, out_dim), sigma, device=device,
                              requires_grad=True),
        "b_mu": uniform((out_dim,)),
        "b_sigma": torch.full((out_dim,), sigma, device=device,
                              requires_grad=True),
    }


def factorized(z: torch.Tensor) -> torch.Tensor:
    """f(z) = sign(z) sqrt(|z|): standard normals as factorized noise."""
    return torch.sign(z) * torch.sqrt(torch.abs(z))


def noisy_apply(params: Dict[str, Any], x: torch.Tensor,
                noise: Optional[Noise] = None) -> torch.Tensor:
    """noise=None -> deterministic mu-only pass (evaluation).

    ``noise`` is ``(eps_in [B, in], eps_out [B, out])``, factorized
    (:func:`factorized` of standard normals), one row PER BATCH ROW
    (Fortunato et al. eq. 10 in the batched setting): with shared noise, a
    whole gradient step chases one correlated perturbation. The factorized
    form never materializes per-row weight matrices: x (w_sigma o eps_in
    eps_out^T) == ((x o eps_in) w_sigma) o eps_out."""
    mu = x @ params["w_mu"] + params["b_mu"]
    if noise is None:
        return mu
    eps_in, eps_out = noise
    return mu + (((x * eps_in) @ params["w_sigma"]) * eps_out
                 + params["b_sigma"] * eps_out)


class RainbowPolicy:
    """Distributional noisy Q policy (policy_class "rainbow")."""

    needs_gae = False

    def __init__(self, obs_space, action_space: Any,
                 model_config: Dict[str, Any] = None, seed: int = 0,
                 device=None):
        discrete, act_dim = action_dims(action_space)
        if not discrete:
            raise ValueError("RainbowPolicy requires Discrete actions")
        self.device = resolve_device(device)
        self.discrete = True
        self.action_space = action_space
        self.act_dim = act_dim
        model_config = model_config or {}
        self.num_atoms = int(model_config.get("num_atoms", 51))
        self.v_min = float(model_config.get("v_min", -10.0))
        self.v_max = float(model_config.get("v_max", 10.0))
        self.noisy = bool(model_config.get("noisy", True))
        self.dueling = bool(model_config.get("dueling", True))
        # The atoms, rounded once to float32 on the host: every device
        # holds the same values.
        self.support = torch.from_numpy(np.linspace(
            self.v_min, self.v_max, self.num_atoms).astype(np.float32)).to(
                self.device)
        enc_init, self._encode, self.feat_dim = ModelCatalog.get_encoder(
            obs_space, model_config)
        gen = torch.Generator().manual_seed(seed)
        self.params = {
            "encoder": enc_init(gen, self.device),
            "adv": noisy_init(gen, self.feat_dim,
                              self.act_dim * self.num_atoms, self.device)}
        if self.dueling:
            self.params["val"] = noisy_init(gen, self.feat_dim,
                                            self.num_atoms, self.device)
        # Exploration: noisy nets explore via weight noise. epsilon kept
        # for API parity (synced by the DQN learner) but unused when
        # noisy=True.
        self.epsilon = 0.0
        self.fixed_epsilon = self.noisy

    def make_generator(self, seed: int) -> torch.Generator:
        """An exploration (and noise) generator on this policy's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def draw_noise(self, gen: torch.Generator, batch: int
                   ) -> Dict[str, Noise]:
        """Factorized noise for each head ("adv", and "val" when dueling)
        for ``batch`` rows: standard normals from ``gen``, the input's
        then the output's of each head in turn."""
        outs = {"adv": self.act_dim * self.num_atoms, "val": self.num_atoms}
        return {name: tuple(
            factorized(torch.randn((batch, n), generator=gen,
                                   device=self.device))
            for n in (self.feat_dim, outs[name]))
            for name in (("adv", "val") if self.dueling else ("adv",))}

    # -- functional core -------------------------------------------------

    def logits_dist(self, params, obs, noise: Optional[Dict[str, Noise]]
                    = None):
        """-> [B, act_dim, num_atoms] log-probabilities; ``noise``
        (:meth:`draw_noise`'s layout) only where the policy is noisy."""
        feats = self._encode(params["encoder"], obs)
        if not self.noisy:
            noise = None
        adv = noisy_apply(params["adv"], feats,
                          None if noise is None else noise["adv"]).reshape(
            (-1, self.act_dim, self.num_atoms))
        if self.dueling:
            val = noisy_apply(params["val"], feats,
                              None if noise is None else noise["val"]
                              ).reshape((-1, 1, self.num_atoms))
            logits = val + adv - adv.mean(1, keepdim=True)
        else:
            logits = adv
        return torch.log_softmax(logits, -1)

    def q_values(self, params, obs, noise=None):
        """Expected values under the categorical distribution."""
        log_p = self.logits_dist(params, obs, noise)
        return (torch.exp(log_p) * self.support).sum(-1)

    # -- worker-side API -------------------------------------------------

    def compute_actions(self, obs: np.ndarray, gen: torch.Generator
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Greedy actions under fresh noise (noisy), or epsilon-greedy
        ones (two draws from ``gen`` when epsilon > 0)."""
        n = obs.shape[0]
        noise = self.draw_noise(gen, n) if self.noisy else None
        with torch.no_grad():
            q = self.q_values(self.params, as_tensor(obs, self.device),
                              noise)
        actions = q.argmax(-1)
        if not self.noisy and self.epsilon > 0:
            explore = torch.rand((n,), generator=gen,
                                 device=self.device) < self.epsilon
            rand = torch.randint(0, self.act_dim, (n,), generator=gen,
                                 device=self.device)
            actions = torch.where(explore, rand, actions)
        zeros = np.zeros((n,), np.float32)
        return actions.cpu().numpy(), zeros, zeros

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


def project_distribution(next_log_p, rewards, discounts, dones, support,
                         v_min: float, v_max: float):
    """C51 categorical projection (Bellemare et al. 2017, alg. 1):
    shift the support by r + gamma^k * z, clip to [v_min, v_max], and
    distribute each atom's mass onto its two neighboring bins.

    next_log_p: [B, num_atoms] log-probs of the chosen next action.
    Returns [B, num_atoms] target probabilities. Atoms of one row can land
    on the same bin: their masses add (``scatter_add_``)."""
    num_atoms = support.shape[0]
    delta = (v_max - v_min) / (num_atoms - 1)
    # Tz: [B, atoms] target support positions
    tz = rewards[:, None] + (discounts * (1.0 - dones))[:, None] * \
        support[None, :]
    tz = torch.clamp(tz, v_min, v_max)
    b = (tz - v_min) / delta                    # fractional bin index
    lo = torch.floor(b).long()
    hi = torch.ceil(b).long()
    # When b lands exactly on a bin (lo == hi), give it full mass once.
    eq = (lo == hi).to(b.dtype)
    p_next = torch.exp(next_log_p)              # [B, atoms]
    m_lo = p_next * ((hi.to(b.dtype) - b) + eq)
    m_hi = p_next * (b - lo.to(b.dtype))
    target = torch.zeros_like(p_next)
    target.scatter_add_(1, lo, m_lo)
    target.scatter_add_(1, torch.clamp_max(hi, num_atoms - 1), m_hi)
    return target
