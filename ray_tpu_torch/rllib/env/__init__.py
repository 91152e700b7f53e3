from ray_tpu_torch.rllib.env.external_env import ExternalEnv
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv

__all__ = ["ExternalEnv", "MultiAgentEnv"]
