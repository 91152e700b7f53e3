"""R2D2 policy: recurrent (LSTM) Q-network with stored hidden states.

The port of ``ray_tpu/rllib/policy/r2d2_policy.py``, the policy half of
R2D2 (Kapturowski et al. 2019; reference: rllib/algorithms/r2d2 + the
torch RNN model stack): an encoder feeds an LSTM whose hidden state
carries across env steps; the Q head (dueling) reads the LSTM output.
Rollout workers step it statefully (the worker calls ``reset_state`` at
episode boundaries and records the PRE-step hidden state into every
transition via ``state_rows``), so the learner can re-run the recurrence
from any stored position: sample a sequence window, seed the LSTM with
the stored state, burn in a few steps without gradient, then TD-train the
remainder (algorithms/r2d2.py).

The cell is the JAX package's, written out (:func:`lstm_step`): gates i,
f, g, o split from one ``[in + hidden, 4 * hidden]`` product, +1 on the
forget gate; ``nn.LSTM`` lays its gates and biases out otherwise. The
JAX ``lax.scan`` over time is a loop over the window's steps, with the
encoder and the heads applied to all steps at once. The parameters are
the JAX package's tree (``{"encoder", "lstm", "adv_head",
"value_head"}``) on ``device`` (None is the CUDA card and raises without
one); the recurrent state between ``compute_actions`` calls is numpy on
the host, as there.
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


def lstm_init(gen: torch.Generator, in_dim: int, hidden: int,
              device=None) -> Dict[str, torch.Tensor]:
    scale = 1.0 / math.sqrt(in_dim + hidden)
    w = torch.randn((in_dim + hidden, 4 * hidden), generator=gen,
                    dtype=torch.float32) * scale
    return {"w": w.to(device).requires_grad_(),
            "b": torch.zeros(4 * hidden, device=device, requires_grad=True)}


def lstm_step(params, h, c, x):
    """One LSTM cell step. x: [B, in], h/c: [B, hidden]. Forget-gate bias
    +1 (standard init: remember by default)."""
    z = torch.cat([x, h], -1) @ params["w"] + params["b"]
    i, f, g, o = torch.chunk(z, 4, -1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def value_rescale(x, eps: float = 1e-3):
    """h(x) = sign(x)(sqrt(|x|+1)-1) + eps*x (R2D2's invertible value
    rescaling for raw-reward training)."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_rescale_inv(x, eps: float = 1e-3):
    inner = torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0
    return torch.sign(x) * ((inner / (2.0 * eps)) ** 2 - 1.0)


class R2D2Policy:
    needs_gae = False

    def __init__(self, obs_space, action_space: Any,
                 model_config: Dict[str, Any] = None, seed: int = 0,
                 device=None):
        discrete, act_dim = action_dims(action_space)
        if not discrete:
            raise ValueError("R2D2Policy requires Discrete actions")
        self.device = resolve_device(device)
        self.discrete = True
        self.action_space = action_space
        self.act_dim = act_dim
        model_config = model_config or {}
        self.hidden = int(model_config.get("lstm_cell_size", 64))
        enc_init, self._encode, feat_dim = ModelCatalog.get_encoder(
            obs_space, model_config)
        gen = torch.Generator().manual_seed(seed)
        self.params = {
            "encoder": enc_init(gen, self.device),
            "lstm": lstm_init(gen, feat_dim, self.hidden, self.device),
            "adv_head": mlp_init(gen, [self.hidden, self.act_dim],
                                 self.device),
            "value_head": mlp_init(gen, [self.hidden, 1], self.device),
        }
        self.epsilon = 1.0
        self.fixed_epsilon = False
        self.reset_state()
        self.state_rows: Dict[str, np.ndarray] = {}

    def make_generator(self, seed: int) -> torch.Generator:
        """An exploration generator on this policy's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- functional core -------------------------------------------------

    def _q_from_h(self, params, h):
        value = mlp_apply(params["value_head"], h)
        adv = mlp_apply(params["adv_head"], h)
        return value + adv - adv.mean(-1, keepdim=True)

    def _step(self, params, obs, h, c):
        feats = self._encode(params["encoder"], obs)
        h, c = lstm_step(params["lstm"], h, c, feats)
        return self._q_from_h(params, h), h, c

    def q_seq(self, params, obs_seq, h0, c0):
        """Run the recurrence over a [B, T, ...] window from (h0, c0).
        Returns q [B, T, A] and the final state."""
        b, t = obs_seq.shape[:2]
        feats = self._encode(params["encoder"],
                             obs_seq.reshape((b * t,) + obs_seq.shape[2:]))
        feats = feats.reshape(b, t, -1)
        h, c, hs = h0, c0, []
        for i in range(t):
            h, c = lstm_step(params["lstm"], h, c, feats[:, i])
            hs.append(h)
        q = self._q_from_h(params, torch.stack(hs, 1).reshape(b * t, -1))
        return q.reshape(b, t, -1), (h, c)

    # -- worker-side API -------------------------------------------------

    def reset_state(self) -> None:
        self._h = np.zeros((1, self.hidden), np.float32)
        self._c = np.zeros((1, self.hidden), np.float32)

    def _advance(self, obs: np.ndarray) -> torch.Tensor:
        """One step from the kept state: the Q values; the state moves on."""
        with torch.no_grad():
            q, h, c = self._step(self.params, as_tensor(obs, self.device),
                                 as_tensor(self._h, self.device),
                                 as_tensor(self._c, self.device))
        self._h = h.cpu().numpy()
        self._c = c.cpu().numpy()
        return q

    def compute_actions(self, obs: np.ndarray, gen: torch.Generator
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Epsilon-greedy actions (two draws from ``gen``), advancing the
        recurrent state."""
        # Record the PRE-step state: replaying the stored sequence from
        # this state reproduces this step's Q values exactly.
        self.state_rows = {"lstm_h": self._h[0].copy(),
                           "lstm_c": self._c[0].copy()}
        n = obs.shape[0]
        greedy = self._advance(obs).argmax(-1)
        explore = torch.rand((n,), generator=gen,
                             device=self.device) < self.epsilon
        rand = torch.randint(0, self.act_dim, (n,), generator=gen,
                             device=self.device)
        actions = torch.where(explore, rand, greedy).cpu().numpy()
        zeros = np.zeros((n,), np.float32)
        return actions, zeros, zeros

    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            q, _, _ = self._step(self.params, as_tensor(obs, self.device),
                                 as_tensor(self._h, self.device),
                                 as_tensor(self._c, self.device))
        return q.max(-1).values.cpu().numpy()

    def compute_greedy(self, obs: np.ndarray) -> int:
        """Greedy eval step (Algorithm.compute_single_action/evaluate
        dispatch): argmax Q, advancing the recurrent state — recurrent
        evaluation is stateful by nature."""
        return int(self._advance(obs).argmax(-1)[0])

    def get_weights(self):
        return {"params": to_numpy(self.params), "epsilon": self.epsilon}

    def set_weights(self, weights) -> None:
        if isinstance(weights, dict) and "params" in weights:
            self.params = from_jax_params(weights["params"], self.device)
            if not self.fixed_epsilon:
                self.epsilon = float(weights.get("epsilon", self.epsilon))
        else:
            self.params = from_jax_params(weights, self.device)
