"""Small multi-agent example envs for tests and tuned examples
(reference: rllib/examples/env/ — two-step game, coordination tasks)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv

try:
    from gymnasium import spaces
except ImportError:  # pragma: no cover
    spaces = None


class CoordinationGameEnv(MultiAgentEnv):
    """Cooperative context matching (QMIX's home turf): each round both
    agents observe the same one-hot context and must BOTH play the action
    equal to the context index to score — the team earns 1.0 only on
    joint success, split evenly, so credit assignment runs through the
    team reward. ``rounds`` rounds per episode; optimal team return =
    rounds; uniform-random = rounds / actions^2."""

    def __init__(self, config: Optional[dict] = None):
        config = dict(config or {})
        self.rounds = int(config.get("rounds", 10))
        self.n_contexts = int(config.get("n_contexts", 2))
        self.n_actions = int(config.get("n_actions", 3))
        self._seed = int(config.get("seed", 0))
        self.agent_ids = {"a0", "a1"}
        self._rng = np.random.default_rng(self._seed)
        if spaces is not None:
            self.observation_space = spaces.Box(
                0.0, 1.0, (self.n_contexts,), np.float32)
            self.action_space = spaces.Discrete(self.n_actions)
        self._t = 0
        self._ctx = 0

    def _obs(self):
        onehot = np.zeros(self.n_contexts, np.float32)
        onehot[self._ctx] = 1.0
        return {"a0": onehot.copy(), "a1": onehot.copy()}

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._ctx = int(self._rng.integers(self.n_contexts))
        return self._obs(), {}

    def step(self, action_dict):
        match = all(int(action_dict[aid]) == self._ctx
                    for aid in ("a0", "a1"))
        r = 0.5 if match else 0.0
        self._t += 1
        done = self._t >= self.rounds
        self._ctx = int(self._rng.integers(self.n_contexts))
        obs = self._obs()
        rewards = {"a0": r, "a1": r}
        terms = {"a0": done, "a1": done, "__all__": done}
        truncs = {"a0": False, "a1": False, "__all__": False}
        return obs, rewards, terms, truncs, {}


class CooperativeNavEnv(MultiAgentEnv):
    """Continuous cooperative navigation (MADDPG's home turf — the
    "simple spread" task of the MPE suite the reference's MADDPG README
    points at): ``n_agents`` point masses must cover ``n_agents``
    landmarks in the 2D unit box. The team reward (shared equally) is
    minus the sum over landmarks of the distance to the CLOSEST agent —
    maximized only when the agents divide the landmarks among
    themselves, which requires coordinating through the joint state.
    Observations: own position ++ all landmark offsets ++ other agents'
    positions. Actions: Box(2,) velocity in [-1, 1], integrated with
    ``dt``."""

    def __init__(self, config: Optional[dict] = None):
        config = dict(config or {})
        self.n_agents = int(config.get("n_agents", 2))
        self.horizon = int(config.get("horizon", 25))
        self.dt = float(config.get("dt", 0.15))
        self.agent_ids = {f"a{i}" for i in range(self.n_agents)}
        self._ids = sorted(self.agent_ids)
        obs_dim = 2 + 2 * self.n_agents + 2 * (self.n_agents - 1)
        if spaces is not None:
            # Landmark offsets span [-3, 3]: positions clip at +-2 and
            # landmarks spawn in [-1, 1].
            self.observation_space = spaces.Box(
                -3.0, 3.0, (obs_dim,), np.float32)
            self.action_space = spaces.Box(-1.0, 1.0, (2,), np.float32)
        self._rng = np.random.default_rng(config.get("seed", 0))
        self._pos = None
        self._landmarks = None
        self._t = 0

    def _obs(self):
        out = {}
        for i, aid in enumerate(self._ids):
            others = np.delete(self._pos, i, axis=0)
            out[aid] = np.concatenate(
                [self._pos[i], (self._landmarks - self._pos[i]).ravel(),
                 others.ravel()]).astype(np.float32)
        return out

    def _team_reward(self) -> float:
        d = np.linalg.norm(
            self._landmarks[:, None, :] - self._pos[None, :, :], axis=-1)
        return float(-d.min(axis=1).sum())

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = self._rng.uniform(-1, 1, (self.n_agents, 2))
        self._landmarks = self._rng.uniform(-1, 1, (self.n_agents, 2))
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        for i, aid in enumerate(self._ids):
            a = np.clip(np.asarray(action_dict[aid], np.float64), -1, 1)
            self._pos[i] = np.clip(self._pos[i] + self.dt * a, -2, 2)
        self._t += 1
        done = self._t >= self.horizon
        r = self._team_reward() / self.n_agents
        obs = self._obs()
        rewards = {aid: r for aid in self._ids}
        terms = {aid: done for aid in self._ids}
        terms["__all__"] = done
        truncs = {aid: False for aid in self._ids}
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, {}


class ClonableCartPole:
    """Sparse-reward CartPole with ``get_state``/``set_state`` — the
    clonable-env contract AlphaZero's MCTS needs (reference:
    rllib/algorithms/alpha_zero README + its test task
    examples/env/cartpole_sparse_rewards.py). Reward accumulates
    silently and pays out ONLY at termination (the episode score) — the
    board-game shape AlphaZero's undiscounted backup expects; the
    algorithm's ranked-rewards transform then maps that score to +-1.
    Observations are the prescribed dict {"obs", "action_mask"} (every
    move legal here)."""

    def __init__(self, config: Optional[dict] = None):
        import gymnasium as gym
        config = dict(config or {})
        # UNWRAPPED: gym's TimeLimit wrapper counts every step — MCTS
        # simulations would burn the episode budget and set_state cannot
        # restore the wrapper's counter. AlphaZeroConfig.max_episode_steps
        # bounds self-play episodes instead.
        self._env = gym.make("CartPole-v1").unwrapped
        self.action_space = self._env.action_space
        # The DECLARED space matches the emitted dict (the reference
        # declares a Dict space for its sparse-rewards CartPole too).
        self.observation_space = spaces.Dict({
            "obs": self._env.observation_space,
            "action_mask": spaces.Box(0.0, 1.0, (self.action_space.n,),
                                      np.float32),
        })
        self._steps = 0
        self._running = 0.0

    def _obs(self, raw):
        return {"obs": np.asarray(raw, np.float32),
                "action_mask": np.ones(self.action_space.n, np.float32)}

    def reset(self, *, seed=None, options=None):
        raw, info = self._env.reset(seed=seed, options=options)
        self._steps = 0
        self._running = 0.0
        return self._obs(raw), info

    def step(self, action):
        raw, r, term, trunc, info = self._env.step(int(action))
        self._steps += 1
        self._running += float(r)
        score = self._running if term else 0.0
        return self._obs(raw), score, term, trunc, info

    def get_state(self):
        env = self._env.unwrapped
        return (np.array(env.state, np.float64), self._steps,
                self._running, env.steps_beyond_terminated)

    def set_state(self, state):
        arr, steps, running, beyond = state
        env = self._env.unwrapped
        env.state = tuple(arr.tolist())
        # Restored states may predate a simulated termination — without
        # this, post-restore steps hit gym's already-terminated warning
        # path and return 0 reward.
        env.steps_beyond_terminated = beyond
        self._steps = steps
        self._running = running

    def episode_score(self) -> float:
        """Accumulated-but-unpaid score (AlphaZero reads this when its
        step budget ends an episode before the env does)."""
        return self._running

    def close(self):
        self._env.close()


class PointGoalEnv:
    """1D point-mass reach-the-goal task: obs = [pos], Box action moves
    the point, reward = -|pos - goal|, 30-step episodes. goal defaults
    to the origin; a HIDDEN nonzero goal (env_config {"goal": g},
    deliberately absent from the observation) turns it into a meta-RL
    task family — the policy must adapt from REWARDS (MAML's home
    turf). The world model is learnable in a few hundred steps, which
    also makes this the CI-affordable learning gate for model-based
    algorithms (Dreamer) whose sample cost on classic-control tasks
    far exceeds a test budget; random ~= -60/episode (goal 0),
    competent ~= -40 or better."""

    def __init__(self, config: Optional[dict] = None):
        from gymnasium import spaces as _spaces
        config = dict(config or {})
        self.goal = float(config.get("goal", 0.0))
        self.horizon = int(config.get("horizon", 30))
        self.observation_space = _spaces.Box(-5.0, 5.0, (1,), np.float32)
        self.action_space = _spaces.Box(-1.0, 1.0, (1,), np.float32)
        self._rng = np.random.default_rng(config.get("seed", 0))
        self.pos = 0.0
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.pos = float(self._rng.uniform(-3, 3))
        self._t = 0
        return np.array([self.pos], np.float32), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1), -1, 1)[0])
        self.pos = float(np.clip(self.pos + a, -5, 5))
        self._t += 1
        return (np.array([self.pos], np.float32),
                -abs(self.pos - self.goal),
                False, self._t >= self.horizon, {})

    def reward_fn(self, state, action, next_state) -> float:
        """Known reward over (s, a, s') — the contract model-based
        algorithms (MBMPO) need to roll imagined trajectories without
        the env (the reference likewise pairs MBMPO with envs exposing
        reward functions)."""
        return -abs(float(np.asarray(next_state).reshape(-1)[0])
                    - self.goal)

    def close(self):
        pass


class TwoPlayerRepeatedRPS(MultiAgentEnv):
    """Two-player repeated rock-paper-scissors — the competitive
    self-play testbed for league training (AlphaStar's match shape at
    CI scale). Each round both agents pick {0,1,2}; rewards are the
    zero-sum payoff; observations are one-hot encodings of BOTH last
    moves (own, opponent's) so a policy can learn to exploit an
    opponent's conditional biases. Episodes run ``rounds`` rounds."""

    agent_ids = {"p0", "p1"}

    def __init__(self, config: Optional[dict] = None):
        import gymnasium.spaces as _spaces
        config = dict(config or {})
        self.rounds = int(config.get("rounds", 8))
        self.observation_space = _spaces.Box(0.0, 1.0, (6,), np.float32)
        self.action_space = _spaces.Discrete(3)
        self._t = 0
        self._last = {"p0": None, "p1": None}

    def _obs_for(self, me: str, other: str) -> np.ndarray:
        obs = np.zeros(6, np.float32)
        if self._last[me] is not None:
            obs[self._last[me]] = 1.0
            obs[3 + self._last[other]] = 1.0
        return obs

    def reset(self, *, seed=None, options=None):
        self._t = 0
        self._last = {"p0": None, "p1": None}
        return ({"p0": self._obs_for("p0", "p1"),
                 "p1": self._obs_for("p1", "p0")}, {})

    def step(self, action_dict):
        a0 = int(action_dict["p0"])
        a1 = int(action_dict["p1"])
        # 0 beats 2, 1 beats 0, 2 beats 1 (rock/paper/scissors cycle).
        if a0 == a1:
            r0 = 0.0
        elif (a0 - a1) % 3 == 1:
            r0 = 1.0
        else:
            r0 = -1.0
        self._last = {"p0": a0, "p1": a1}
        self._t += 1
        done = self._t >= self.rounds
        obs = {"p0": self._obs_for("p0", "p1"),
               "p1": self._obs_for("p1", "p0")}
        return (obs, {"p0": r0, "p1": -r0},
                {"__all__": done, "p0": done, "p1": done},
                {"__all__": False, "p0": False, "p1": False}, {})
