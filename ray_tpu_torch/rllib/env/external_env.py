"""ExternalEnv: environments that drive THEMSELVES instead of being
stepped.

Analog of the reference's rllib/env/external_env.py:22 — the agent loop
lives in the environment (a simulator, a website, a game server), and the
framework answers its action queries instead of calling reset()/step().
The episode API (start_episode / get_action / log_action / log_returns /
end_episode) runs on the environment's own thread; a queue-pair per
episode hands observations to the sampler and actions back.

TPU-first integration: rather than a dedicated poll/send sampler stack,
:class:`GymAdapter` exposes the queue protocol as a plain reset()/step()
environment, so external envs ride the SAME vectorized samplers (and
batched-inference path) every other env uses — RolloutWorker detects an
ExternalEnv and wraps it automatically.
"""

from __future__ import annotations

import queue
import threading
import uuid
from typing import Any, Dict, Optional

__all__ = ["ExternalEnv", "GymAdapter"]


class _EpisodeDone(Exception):
    pass


class _ExternalEnvEpisode:
    """One running episode: observation/action handoff + reward ledger
    (reference: external_env.py:244 _ExternalEnvEpisode)."""

    def __init__(self, episode_id: str, training_enabled: bool = True):
        self.episode_id = episode_id
        self.training_enabled = training_enabled
        # env thread -> sampler: (obs, reward_since_last, done)
        self.obs_q: "queue.Queue" = queue.Queue(maxsize=1)
        # sampler -> env thread: action
        self.action_q: "queue.Queue" = queue.Queue(maxsize=1)
        self.pending_reward = 0.0
        self.done = False
        self.logged_action: Optional[Any] = None

    def push_obs(self, obs, done: bool = False) -> None:
        reward = self.pending_reward
        self.pending_reward = 0.0
        self.done = self.done or done
        self.obs_q.put((obs, reward, done, self.logged_action))
        self.logged_action = None

    def wait_action(self, timeout: Optional[float] = None):
        return self.action_q.get(timeout=timeout)


class ExternalEnv(threading.Thread):
    """Subclass and implement :meth:`run` with your agent loop
    (reference: external_env.py:22). Example::

        class MySim(ExternalEnv):
            def run(self):
                while True:
                    eid = self.start_episode()
                    obs = self.sim.reset()
                    done = False
                    while not done:
                        action = self.get_action(eid, obs)
                        obs, reward, done = self.sim.step(action)
                        self.log_returns(eid, reward)
                    self.end_episode(eid, obs)
    """

    def __init__(self, action_space=None, observation_space=None,
                 max_concurrent: int = 100):
        super().__init__(daemon=True)
        self.action_space = action_space
        self.observation_space = observation_space
        self._episodes: Dict[str, _ExternalEnvEpisode] = {}
        self._max_concurrent = max_concurrent
        self._lock = threading.Lock()
        # Episodes with an observation waiting for an action.
        self._ready: "queue.Queue" = queue.Queue()

    # -- episode API (called from the env's run() thread) ----------------

    def run(self) -> None:
        raise NotImplementedError(
            "Subclasses of ExternalEnv must implement run() — the "
            "environment's own agent loop.")

    def start_episode(self, episode_id: Optional[str] = None,
                      training_enabled: bool = True) -> str:
        episode_id = episode_id or uuid.uuid4().hex
        with self._lock:
            if episode_id in self._episodes:
                raise ValueError(f"episode {episode_id} already started")
            if len(self._episodes) >= self._max_concurrent:
                raise RuntimeError(
                    f"too many concurrent episodes (max "
                    f"{self._max_concurrent})")
            self._episodes[episode_id] = _ExternalEnvEpisode(
                episode_id, training_enabled)
        return episode_id

    def get_action(self, episode_id: str, observation):
        """Block until the policy answers with an action."""
        ep = self._get(episode_id)
        ep.push_obs(observation)
        self._ready.put(ep)
        return ep.wait_action()

    def log_action(self, episode_id: str, observation, action) -> None:
        """Record an action the CALLER chose (off-policy data)."""
        ep = self._get(episode_id)
        ep.logged_action = action
        ep.push_obs(observation)
        self._ready.put(ep)
        ep.wait_action()  # sampler echoes the logged action back

    def log_returns(self, episode_id: str, reward: float,
                    info: Optional[dict] = None) -> None:
        self._get(episode_id).pending_reward += float(reward)

    def end_episode(self, episode_id: str, observation) -> None:
        ep = self._get(episode_id)
        ep.push_obs(observation, done=True)
        self._ready.put(ep)
        with self._lock:
            self._episodes.pop(episode_id, None)

    def _get(self, episode_id: str) -> _ExternalEnvEpisode:
        with self._lock:
            ep = self._episodes.get(episode_id)
        if ep is None:
            raise KeyError(
                f"episode {episode_id} is not running (not started with "
                "a name, or already ended)")
        return ep


class GymAdapter:
    """Exposes an ExternalEnv through reset()/step() so the standard
    (vectorized, batched-inference) samplers drive it unchanged — the
    queue protocol inverted back into a pull interface. One adapter
    serves episodes strictly sequentially; concurrency comes from
    num_envs_per_worker adapters over one shared ExternalEnv."""

    def __init__(self, external: ExternalEnv):
        self._external = external
        self._episode: Optional[_ExternalEnvEpisode] = None
        self._last_obs = None
        self.action_space = external.action_space
        self.observation_space = external.observation_space
        if not external.is_alive():
            try:
                external.start()
            except RuntimeError:
                pass  # another adapter already started the thread

    def _next_ready(self, timeout: float = 60.0) -> _ExternalEnvEpisode:
        return self._external._ready.get(timeout=timeout)

    def reset(self, seed=None, **_kw):
        # The env thread decides when episodes begin; reset == wait for
        # the next observation that needs an action.
        ep = self._next_ready()
        obs, _reward, done, _logged = ep.obs_q.get(timeout=60)
        if done:
            # Zero-step episode; recurse to the next real one.
            return self.reset()
        self._episode = ep
        self._last_obs = obs
        return obs, {}

    def step(self, action):
        ep = self._episode
        if ep is None:
            raise RuntimeError("step() before reset()")
        ep.action_q.put(action)
        nxt = self._next_ready()
        obs, reward, done, logged = nxt.obs_q.get(timeout=60)
        if nxt is not ep:
            # A different episode surfaced (concurrent episodes on one
            # adapter): truncate OURS — with our own last observation as
            # the terminal obs (a foreign episode's obs in NEXT_OBS would
            # pollute the value bootstrap) — and re-queue the surfaced
            # one for the next reset().
            nxt.obs_q.put((obs, reward, done, logged))
            self._external._ready.put(nxt)
            self._episode = None
            return self._last_obs, 0.0, False, True, {}
        if done:
            self._episode = None
            return obs, reward, True, False, {}
        self._last_obs = obs
        return obs, reward, False, False, {"logged_action": logged}
