"""AlgorithmConfig: fluent configuration (reference:
rllib/algorithms/algorithm_config.py — .environment()/.rollouts()/
.training()/.framework()/.resources() chaining, frozen into an Algorithm).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Sequence, Type


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Any = None
        self.env_config: Dict[str, Any] = {}
        # rollouts
        self.num_rollout_workers: int = 2
        # jax platform rollout workers pin THEIR process to ("cpu" —
        # samplers never grab the learner's chip or a remote-TPU
        # tunnel; None = leave the process default alone).
        self.rollout_backend: Optional[str] = "cpu"
        self.num_envs_per_worker = 1
        self.rollout_fragment_length: int = 256
        self.num_cpus_per_worker: float = 1.0
        # training
        self.gamma: float = 0.99
        self.lr: float = 5e-4
        self.train_batch_size: int = 512
        self.fcnet_hiddens: Sequence[int] = (64, 64)
        self.seed: int = 0
        # framework (always jax here; kept for API parity)
        self.framework_str: str = "jax"
        # Where the learner's tensors live: None is the CUDA card (and
        # raises without one), "cpu" must be asked for by name.
        self.device: Any = None
        # policy implementation (rllib/policy/__init__.py registry)
        self.policy_class_name: str = "actor_critic"
        # preprocessing / connectors
        self.observation_filter: str = "NoFilter"
        self.clip_actions: bool = True
        self.conv_filters = None
        self.post_fcnet_dim: int = 256
        # offline data (reference: rllib/offline/)
        self.output: Any = None  # dir path → rollout workers write JSON
        self.input_: Any = None  # dir path → train from offline JSON
        # evaluation
        self.evaluation_interval: int = 0
        self.evaluation_duration: int = 3
        # multi-agent (reference: AlgorithmConfig.multi_agent):
        # policies: {policy_id: (obs_space, act_space) | None (infer from
        # the env's per-agent spaces)}; policy_mapping_fn: agent_id -> pid.
        self.policies: Optional[Dict[str, Any]] = None
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        # algo-specific fields live on subclass-free dicts
        self.extra: Dict[str, Any] = {}

    # -- fluent sections -------------------------------------------------

    def environment(self, env=None, *, env_config: Optional[dict] = None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_backend: Any = "__unset__",
                 **_ignored) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        # Rollout workers are CPU samplers by default (reference: rollout
        # workers on CPU nodes, the learner owns the accelerator); pass
        # rollout_backend=None to let workers take whatever jax default
        # their process has (e.g. big-batch TPU inference rollouts).
        # Sentinel, not None: None is a MEANINGFUL value here, and a
        # later unrelated .rollouts() call must not silently reset it.
        if rollout_backend != "__unset__":
            self.rollout_backend = rollout_backend
        return self

    env_runners = rollouts  # new-stack alias

    def training(self, *, gamma: Optional[float] = None,
                 lr: Optional[float] = None,
                 train_batch_size: Optional[int] = None,
                 model: Optional[dict] = None,
                 **kwargs) -> "AlgorithmConfig":
        if gamma is not None:
            self.gamma = gamma
        if lr is not None:
            self.lr = lr
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if model:
            if "fcnet_hiddens" in model:
                self.fcnet_hiddens = tuple(model["fcnet_hiddens"])
            if "conv_filters" in model:
                self.conv_filters = [list(f)
                                     for f in model["conv_filters"]]
            if "post_fcnet_dim" in model:
                self.post_fcnet_dim = int(model["post_fcnet_dim"])
        self.extra.update(kwargs)
        return self

    def framework(self, framework: str = "jax") -> "AlgorithmConfig":
        if framework not in ("jax", "tf2", "torch"):
            raise ValueError(framework)
        self.framework_str = "jax"  # everything compiles to XLA here
        return self

    def resources(self, *, device: Any = "__unset__",
                  **_ignored) -> "AlgorithmConfig":
        if device != "__unset__":
            self.device = device
        return self

    def debugging(self, *, seed: Optional[int] = None, **_ignored
                  ) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_duration: Optional[int] = None,
                   **_ignored) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def offline_data(self, *, output=None, input_=None,
                     **_ignored) -> "AlgorithmConfig":
        if output is not None:
            self.output = output
        if input_ is not None:
            self.input_ = input_
        return self

    def multi_agent(self, *, policies: Optional[Dict[str, Any]] = None,
                    policy_mapping_fn: Optional[Callable[[str], str]] = None,
                    **_ignored) -> "AlgorithmConfig":
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    @property
    def is_multi_agent(self) -> bool:
        return bool(self.policies)

    def exploration(self, **kwargs) -> "AlgorithmConfig":
        self.extra.update(kwargs)
        return self

    # -- build -----------------------------------------------------------

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("algo_class",)}
        d.update(d.pop("extra"))
        return d

    def build(self, env=None):
        if env is not None:
            self.env = env
        if self.algo_class is None:
            raise ValueError("No algo_class bound to this config")
        return self.algo_class(config=self)

    def env_creator(self) -> Callable:
        env = self.env
        env_config = self.env_config

        def create(cfg):
            merged = {**env_config, **(cfg or {})}
            if callable(env) and not isinstance(env, str):
                return env(merged)
            import gymnasium as gym
            return gym.make(env)

        return create

    def policy_config(self) -> Dict[str, Any]:
        if self.is_multi_agent and self.policy_mapping_fn is None:
            raise ValueError(
                "Multi-agent configs need a policy_mapping_fn: "
                "config.multi_agent(policies=..., "
                "policy_mapping_fn=lambda agent_id: ...)")
        return {
            "policies": self.policies,
            "policy_mapping_fn": self.policy_mapping_fn,
            "gamma": self.gamma,
            "lambda": self.extra.get("lambda", 0.95),
            "fcnet_hiddens": tuple(self.fcnet_hiddens),
            "conv_filters": self.conv_filters,
            "post_fcnet_dim": self.post_fcnet_dim,
            "env_config": self.env_config,
            "policy_class": self.policy_class_name,
            "observation_filter": self.observation_filter,
            "clip_actions": self.clip_actions,
            "output": self.output,
            "num_envs_per_worker": getattr(
                self, "num_envs_per_worker", 1),
            "rollout_backend": getattr(self, "rollout_backend", "cpu"),
        }
