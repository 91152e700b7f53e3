"""Policy registry: maps the ``policy_class`` name in a policy config to
an implementation (the port of ``ray_tpu/rllib/policy/__init__.py``).

Every policy lives on ``device`` (None is the CUDA card): "actor_critic"
is :class:`TorchPolicy`, "q" :class:`QPolicy`, "sac" and "td3"
:class:`SACPolicy` and :class:`TD3Policy`. The recurrent and
distributional policies ("r2d2", "rainbow") come with the rest of RLlib
(ROADMAP item 10b): their modules are not in the port yet, and asking for
one raises ``ModuleNotFoundError``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def make_policy(policy_config: Dict[str, Any], obs_space, action_space,
                seed: int = 0, device=None):
    """Instantiate the policy named by policy_config['policy_class']."""
    # Only a Dict space keeps its subspaces in a dict: gymnasium is
    # imported where the space can be one, so a space read by its
    # attributes builds a policy without it.
    if isinstance(getattr(obs_space, "spaces", None), dict):
        import gymnasium as gym
        if isinstance(obs_space, gym.spaces.Dict) and \
                "obs" in obs_space.spaces:
            # The {"obs", "action_mask"} dict convention (AlphaZero envs,
            # reference parametric-action envs): policies encode the inner
            # observation; masks are the algorithm's concern.
            obs_space = obs_space.spaces["obs"]
    name = policy_config.get("policy_class", "actor_critic")
    model_config = {
        "fcnet_hiddens": policy_config.get("fcnet_hiddens", (64, 64)),
        "conv_filters": policy_config.get("conv_filters"),
        "post_fcnet_dim": policy_config.get("post_fcnet_dim", 256),
        "dueling": policy_config.get("dueling", False),
        "noisy": policy_config.get("noisy", True),
        "num_atoms": policy_config.get("num_atoms", 51),
        "lstm_cell_size": policy_config.get("lstm_cell_size", 64),
        "v_min": policy_config.get("v_min", -10.0),
        "v_max": policy_config.get("v_max", 10.0),
    }
    if name == "actor_critic":
        from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy
        return TorchPolicy(
            obs_dim=int(np.prod(obs_space.shape)),
            action_space=action_space,
            hiddens=tuple(model_config["fcnet_hiddens"]),
            seed=seed,
            obs_space=obs_space,
            model_config=model_config,
            device=device)
    if name == "q":
        from ray_tpu_torch.rllib.policy.q_policy import QPolicy
        return QPolicy(obs_space, action_space, model_config, seed=seed,
                       device=device)
    if name == "sac":
        from ray_tpu_torch.rllib.policy.sac_policy import SACPolicy
        return SACPolicy(obs_space, action_space, model_config, seed=seed,
                         device=device)
    if name == "r2d2":
        from ray_tpu_torch.rllib.policy.r2d2_policy import R2D2Policy
        return R2D2Policy(obs_space, action_space, model_config,
                          seed=seed)
    if name == "rainbow":
        from ray_tpu_torch.rllib.policy.rainbow_policy import RainbowPolicy
        return RainbowPolicy(obs_space, action_space, model_config,
                             seed=seed)
    if name == "td3":
        from ray_tpu_torch.rllib.policy.sac_policy import TD3Policy
        return TD3Policy(obs_space, action_space, model_config, seed=seed,
                         device=device)
    raise ValueError(f"Unknown policy_class {name!r}")
