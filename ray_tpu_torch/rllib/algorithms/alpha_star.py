"""AlphaStar: league-based self-play training.

The port of ``ray_tpu/rllib/algorithms/alpha_star.py`` (the reference's
rllib/algorithms/alpha_star/ alpha_star.py + league_builder.py
AlphaStarLeagueBuilder): a LEAGUE of policies trains by playing matches
against each other in a two-player zero-sum MultiAgentEnv:

* **main**: plays PFSP matches against frozen league snapshots (and
  self-play); snapshots itself into the league when its league win-rate
  crosses ``win_rate_threshold_for_new_snapshot``.
* **main exploiters**: train against the learning main; snapshot and
  reset when they beat it reliably.
* **league exploiters**: train against PFSP over the whole league;
  snapshot when they beat the league.

PFSP (prioritized fictitious self-play) weights opponents by how HARD
they are for the learner, (1 - win_rate)^2, drawn from the algorithm's
numpy generator. Every learning policy is a :class:`TorchPolicy` on
``config.device`` (the CUDA card unless the config asks for the CPU) with
its own Adam state, stepped by PPO's update (``ppo.PPO._sgd``); frozen
snapshots are numpy trees loaded into one evaluator policy when played.
Matches run on the driver, each action drawn on the policies' device from
one generator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import compute_gae

_ROW_KEYS = (SampleBatch.OBS, SampleBatch.NEXT_OBS, SampleBatch.ACTIONS,
             SampleBatch.REWARDS, SampleBatch.TERMINATEDS,
             SampleBatch.TRUNCATEDS, SampleBatch.ACTION_LOGP,
             SampleBatch.VF_PREDS, SampleBatch.EPS_ID)


class AlphaStarConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or AlphaStar)
        self.num_rollout_workers = 0
        # League composition (reference: league_builder.py knobs).
        self.num_main_exploiters = 1
        self.num_league_exploiters = 1
        self.win_rate_threshold_for_new_snapshot = 0.7
        self.prob_league_exploiter_match = 0.33
        self.prob_main_exploiter_match = 0.33
        self.prob_exploiter_vs_learning_main = 0.5
        self.matches_per_iteration = 16
        self.win_rate_ema = 0.15
        self.max_league_size = 12

    def league(self, *, num_main_exploiters=None,
               num_league_exploiters=None,
               win_rate_threshold_for_new_snapshot=None,
               prob_league_exploiter_match=None,
               prob_main_exploiter_match=None,
               prob_exploiter_vs_learning_main=None,
               matches_per_iteration=None, win_rate_ema=None,
               max_league_size=None, **_ignored) -> "AlphaStarConfig":
        for name, val in locals().items():
            if name not in ("self", "_ignored") and val is not None:
                setattr(self, name, val)
        return self


class AlphaStar(PPO):
    """League self-play on a two-player zero-sum MultiAgentEnv whose
    agents are ``p0``/``p1``."""

    _default_config_class = AlphaStarConfig
    _own_rollout_actors = True  # matches run on the driver's league loop
    # The learned parameters are every learning policy's, by policy id;
    # each has its PPO Adam state.
    _owns_params = True
    _learner_trees = ()
    _learner_opts = {"_opt_states": "params"}
    _learner_values = ()

    @property
    def params(self) -> Dict[str, Any]:
        return {pid: p.params for pid, p in self.learning.items()}

    @params.setter
    def params(self, trees: Dict[str, Any]) -> None:
        for pid, tree in trees.items():
            self.learning[pid].params = tree

    def setup(self, config: AlphaStarConfig) -> None:
        env = self._env_creator(config.env_config or {})
        if not {"p0", "p1"} <= set(getattr(env, "agent_ids", set())):
            raise ValueError(
                "AlphaStar needs a two-player MultiAgentEnv with agents "
                "'p0' and 'p1'")
        self._match_env = env
        obs_space = env.observation_space
        act_space = env.action_space
        pcfg = config.policy_config()

        def new_policy(seed):
            return make_policy(pcfg, obs_space, act_space, seed=seed,
                               device=config.device)

        # Learning side of the league.
        self.learning: Dict[str, Any] = {"main": new_policy(config.seed)}
        for i in range(config.num_main_exploiters):
            self.learning[f"main_exploiter_{i}"] = new_policy(
                config.seed + 101 + i)
        for i in range(config.num_league_exploiters):
            self.learning[f"league_exploiter_{i}"] = new_policy(
                config.seed + 202 + i)
        # One PPO update per learner (every policy has the same network
        # shape), each with its Adam state.
        self._updates = {}
        self._opt_states = {}
        for pid, policy in self.learning.items():
            self._updates[pid], self._opt_states[pid] = \
                self._build_update(policy, config)
        # Frozen league: starts with a snapshot of the initial main.
        self.league: Dict[str, Any] = {
            "main_v0": self.learning["main"].get_weights()}
        self._frozen_policy = new_policy(config.seed + 999)  # evaluator
        # EMA win-rates per (learner, opponent-name) pair.
        self.win_rates: Dict[Tuple[str, str], float] = {}
        self._snapshot_counter = {"main": 0}
        self._rng = np.random.default_rng(config.seed)
        self._gen = self.learning["main"].make_generator(
            config.seed ^ 0xA57A)

    # -- matchmaking -----------------------------------------------------

    def _pfsp_pick(self, learner: str,
                   candidates: List[str]) -> str:
        """Prioritized fictitious self-play: weight opponents by how
        often they BEAT the learner — (1 - p_win)^2."""
        weights = np.array([
            (1.0 - self.win_rates.get((learner, c), 0.5)) ** 2 + 1e-3
            for c in candidates])
        return candidates[int(self._rng.choice(
            len(candidates), p=weights / weights.sum()))]

    def _pick_opponent(self, learner: str) -> Tuple[str, bool]:
        """Returns (opponent_name, opponent_is_learning)."""
        cfg: AlphaStarConfig = self.config
        snapshots = list(self.league)
        if learner.startswith("main_exploiter"):
            # Main exploiters hunt the LEARNING main (sometimes its
            # snapshots, so they generalize a little).
            if self._rng.random() < cfg.prob_exploiter_vs_learning_main:
                return "main", True
            mains = [s for s in snapshots if s.startswith("main_v")]
            return self._pfsp_pick(learner, mains or snapshots), False
        if learner.startswith("league_exploiter"):
            return self._pfsp_pick(learner, snapshots), False
        # The main: mostly PFSP vs league, sometimes pure self-play.
        r = self._rng.random()
        if r < cfg.prob_league_exploiter_match + \
                cfg.prob_main_exploiter_match:
            return self._pfsp_pick(learner, snapshots), False
        return "main", True

    def _opponent_policy(self, name: str, is_learning: bool):
        if is_learning:
            return self.learning[name]
        self._frozen_policy.set_weights(self.league[name])
        return self._frozen_policy

    # -- match loop ------------------------------------------------------

    def _play_match(self, learner_pid: str, learner_policy,
                    opponent_policy) -> Tuple[SampleBatch, float]:
        """One episode, learner as a random side; returns the learner's
        transition batch and its total (zero-sum) score."""
        cfg: AlphaStarConfig = self.config
        env = self._match_env
        side = "p0" if self._rng.random() < 0.5 else "p1"
        other = "p1" if side == "p0" else "p0"
        pols = {side: learner_policy, other: opponent_policy}
        rows = {k: [] for k in _ROW_KEYS}
        obs, _ = env.reset()
        score = 0.0
        eps_id = int(self._rng.integers(1 << 31))
        done = False
        while not done:
            actions = {}
            meta = None
            for agent, pol in pols.items():
                if agent not in obs:
                    continue
                arr = np.asarray(obs[agent], np.float32)
                action, logp, value = pol.compute_actions(arr[None],
                                                          self._gen)
                act = action[0]
                actions[agent] = (int(act) if pol.discrete
                                  else np.asarray(act))
                if agent == side:
                    meta = (arr, act, float(logp[0]), float(value[0]))
            nxt, rewards, terms, truncs, _ = env.step(actions)
            done = bool(terms.get("__all__") or truncs.get("__all__"))
            if meta is not None:
                arr, act, logp, value = meta
                reward = float(rewards.get(side, 0.0))
                score += reward
                rows[SampleBatch.OBS].append(arr)
                rows[SampleBatch.NEXT_OBS].append(
                    np.asarray(nxt.get(side, arr), np.float32))
                rows[SampleBatch.ACTIONS].append(act)
                rows[SampleBatch.REWARDS].append(np.float32(reward))
                rows[SampleBatch.TERMINATEDS].append(np.float32(done))
                rows[SampleBatch.TRUNCATEDS].append(np.float32(0.0))
                rows[SampleBatch.ACTION_LOGP].append(np.float32(logp))
                rows[SampleBatch.VF_PREDS].append(np.float32(value))
                rows[SampleBatch.EPS_ID].append(eps_id)
            obs = nxt
        batch = SampleBatch({k: np.asarray(v) for k, v in rows.items()})
        batch = compute_gae(batch, cfg.gamma, cfg.lambda_, 0.0)
        return batch, score

    def _note_result(self, learner: str, opponent: str,
                     score: float) -> None:
        cfg: AlphaStarConfig = self.config
        won = 1.0 if score > 0 else (0.5 if score == 0 else 0.0)
        key = (learner, opponent)
        prev = self.win_rates.get(key, 0.5)
        self.win_rates[key] = (1 - cfg.win_rate_ema) * prev + \
            cfg.win_rate_ema * won

    # -- league building -------------------------------------------------

    def _league_win_rate(self, learner: str) -> float:
        rates = [r for (lp, _op), r in self.win_rates.items()
                 if lp == learner]
        return float(np.mean(rates)) if rates else 0.5

    def _build_league(self) -> List[str]:
        """Snapshot learners that beat their opposition: main adds a copy
        and keeps learning; exploiters add a copy and RESET (fresh
        weights and a fresh Adam state)."""
        cfg: AlphaStarConfig = self.config
        added = []
        for pid, policy in self.learning.items():
            if len(self.league) >= cfg.max_league_size:
                break  # cap holds even when several learners qualify
            if self._league_win_rate(pid) < \
                    cfg.win_rate_threshold_for_new_snapshot:
                continue
            base = "main" if pid == "main" else pid
            self._snapshot_counter[base] = \
                self._snapshot_counter.get(base, 0) + 1
            name = f"{base}_v{self._snapshot_counter[base]}"
            self.league[name] = policy.get_weights()
            added.append(name)
            for key in [k for k in self.win_rates if k[0] == pid]:
                del self.win_rates[key]  # fresh slate vs new opposition
            if pid != "main":
                fresh = make_policy(
                    cfg.policy_config(),
                    self._match_env.observation_space,
                    self._match_env.action_space,
                    seed=int(self._rng.integers(1 << 30)), device="cpu")
                policy.set_weights(fresh.get_weights())
                self._opt_states[pid] = self._build_update(
                    policy, cfg)[1]
        return added

    # -- Trainable -------------------------------------------------------

    def learn_on_batch(self, pid: str, batch: SampleBatch
                       ) -> Dict[str, float]:
        """PPO's minibatch SGD of learner ``pid`` on its (GAE-complete)
        batch, on the learner's device; returns the last metrics."""
        self._opt_states[pid], metrics = self._sgd(
            self.learning[pid], self._updates[pid], self._opt_states[pid],
            batch, self.config)
        return metrics

    def training_step(self) -> Dict[str, Any]:
        cfg: AlphaStarConfig = self.config
        results: Dict[str, Any] = {}
        for pid, policy in self.learning.items():
            parts, scores = [], []
            for _ in range(cfg.matches_per_iteration):
                opp, opp_learning = self._pick_opponent(pid)
                batch, score = self._play_match(
                    pid, policy, self._opponent_policy(opp, opp_learning))
                if len(batch):
                    parts.append(batch)
                scores.append(score)
                if opp != pid:
                    # Matches against the LEARNING main count too; only
                    # pure self-play is uninformative.
                    self._note_result(pid, opp, score)
            if not parts:
                continue
            batch = SampleBatch.concat_samples(parts)
            self._timesteps_total += len(batch)
            metrics = self.learn_on_batch(pid, batch)
            results[f"{pid}/mean_score"] = float(np.mean(scores))
            results[f"{pid}/league_win_rate"] = self._league_win_rate(pid)
            for k, v in metrics.items():
                results[f"{pid}/{k}"] = v
        added = self._build_league()
        results["league_size"] = len(self.league)
        results["league_added"] = added
        results["win_rates"] = {f"{a} vs {b}": round(r, 3)
                                for (a, b), r in self.win_rates.items()}
        return results

    def win_rate_vs(self, snapshot: str, episodes: int = 50) -> float:
        """Evaluation: learning main's empirical win-rate against a
        frozen league snapshot."""
        wins = 0.0
        for _ in range(episodes):
            _, score = self._play_match(
                "main", self.learning["main"],
                self._opponent_policy(snapshot, False))
            wins += 1.0 if score > 0 else (0.5 if score == 0 else 0.0)
        return wins / episodes

    def get_weights(self):
        """save()/restore() round-trip the WHOLE league state: every
        learner's weights, the frozen snapshots and the win matrix."""
        return {
            "learning": {pid: p.get_weights()
                         for pid, p in self.learning.items()},
            "league": self.league,
            "win_rates": dict(self.win_rates),
            "snapshot_counter": dict(self._snapshot_counter),
        }

    def set_weights(self, state: Dict[str, Any]) -> None:
        for pid, w in state["learning"].items():
            if pid in self.learning:
                self.learning[pid].set_weights(w)
        self.league = dict(state["league"])
        self.win_rates = dict(state["win_rates"])
        self._snapshot_counter = dict(state["snapshot_counter"])
