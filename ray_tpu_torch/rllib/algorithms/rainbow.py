"""Rainbow: the six-component DQN (Hessel et al. 2018).

The port of ``ray_tpu/rllib/algorithms/rainbow.py`` (the reference's DQN
configured with num_atoms > 1 + noisy + dueling + double + n-step +
prioritized replay; rllib/algorithms/dqn exposes Rainbow through those
flags, this preset packages them and adds the C51 cross-entropy loss over
the projected target distribution). Builds on the port's DQN engine:
rollouts, replay, target syncs and the update loop are inherited; only the
loss (:func:`make_rainbow_loss`) and its noise (:meth:`Rainbow.draw_noise`,
from the learner's generator) differ, and the policy is the
noisy-distributional ``RainbowPolicy`` (policy/rainbow_policy.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.policy.rainbow_policy import project_distribution


class RainbowConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or Rainbow)
        self.policy_class_name = "rainbow"
        # The Rainbow recipe: all six components on by default.
        self.double_q = True
        self.dueling = True
        self.prioritized_replay = True
        self.n_step = 3
        self.noisy = True
        self.num_atoms = 51
        self.v_min = -10.0
        self.v_max = 10.0
        # Noisy nets replace epsilon exploration.
        self.epsilon_initial = 0.0
        self.epsilon_final = 0.0

    def training(self, *, noisy=None, num_atoms=None, v_min=None,
                 v_max=None, **kwargs) -> "RainbowConfig":
        super().training(**kwargs)
        for name, val in (("noisy", noisy), ("num_atoms", num_atoms),
                          ("v_min", v_min), ("v_max", v_max)):
            if val is not None:
                setattr(self, name, val)
        return self

    def policy_config(self):
        base = super().policy_config()
        base.update(noisy=self.noisy, num_atoms=self.num_atoms,
                    v_min=self.v_min, v_max=self.v_max)
        return base


def make_rainbow_loss(policy, gamma: float, double_q: bool):
    """The C51 cross-entropy bound to ``policy``: ``loss_fn(params,
    target_params, mb, noise) -> (loss, ce)``, the per-row cross-entropy
    doubling as the priority signal (the standard distributional-PER
    choice).

    Noise only on the ONLINE current-state pass (the gradient path that
    trains the sigmas). The action-selection and target passes run
    mu-only: fresh noise there inflates the max operator's overestimation
    bias."""

    def loss_fn(params, target_params, mb, noise=None):
        log_p = policy.logits_dist(params, mb["obs"], noise)
        actions = mb["actions"].long()
        batch = torch.arange(actions.shape[0], device=actions.device)
        chosen_log_p = log_p[batch, actions]          # [B, atoms]
        with torch.no_grad():
            # Action selection for the target: online net (double) or
            # target net.
            q_sel = policy.q_values(params if double_q else target_params,
                                    mb["new_obs"])
            a_star = q_sel.argmax(-1)
            next_log_p = policy.logits_dist(target_params,
                                            mb["new_obs"])[batch, a_star]
            done = torch.clamp_min(mb["terminateds"].to(log_p.dtype), 0.0)
            disc = mb.get("n_step_discount", gamma)
            target = project_distribution(
                next_log_p, mb["rewards"], disc, done, policy.support,
                policy.v_min, policy.v_max)
        ce = -(target * chosen_log_p).sum(-1)         # [B]
        if "weights" in mb:
            return (mb["weights"] * ce).mean(), ce
        return ce.mean(), ce

    return loss_fn


class Rainbow(DQN):
    _default_config_class = RainbowConfig

    def setup(self, config: RainbowConfig) -> None:
        super().setup(config)
        policy = self.local_policy
        # The noise of the online pass (the JAX learner's key is
        # PRNGKey(seed + 99)).
        self._gen = torch.Generator(device=policy.device).manual_seed(
            config.seed + 99)

    def _build_loss_fn(self, policy, config):
        return make_rainbow_loss(policy, config.gamma, config.double_q)

    def draw_noise(self, batch: int) -> Optional[Dict[str, Any]]:
        """The online pass's factorized noise for ``batch`` rows
        (``RainbowPolicy.draw_noise``), None where the heads are not
        noisy."""
        if not self.config.noisy:
            return None
        return self.local_policy.draw_noise(self._gen, batch)
