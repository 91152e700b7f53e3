"""SlateQ: reinforcement learning for slate-based recommendation.

The port of ``ray_tpu/rllib/algorithms/slateq.py`` (the reference's
rllib/algorithms/slateq; Ie et al. 2019, "SlateQ: A Tractable
Decomposition for Reinforcement Learning with Recommendation Sets"): the
combinatorial slate action space is made tractable by decomposing the
slate's value under a conditional-logit user-choice model into per-item
long-term values:

    Q(s, A) = sum_{i in A} P(click i | s, A) * Q_item(s, i)

Two networks are learned jointly from logged interactions:
  * a **choice model** ``v(s, doc)`` trained by cross-entropy on which
    slate item the user actually clicked (the no-click option is a
    constant-logit outside option, matching the env's ground truth), and
  * an **item-level Q** ``Q_item(s, doc)`` trained by TD: on a click of
    doc ``d``, target ``r + gamma * max_A' Q(s', A')`` where the max
    enumerates all candidate slates using the decomposition (exact for
    the default 10-choose-3 = 120 slates; the reference's policy likewise
    scores all slates, slateq_tf_policy.py).

Collection is in-algorithm on the host (epsilon-greedy over the
decomposed argmax slate, from a numpy generator) because slates of
distinct indices do not fit the shared rollout workers' Discrete/Box
policy contract — same stance as QMIX's joint collection (qmix.py). Both
networks, their target copy and the optimizer live on ``config.device``
(the CUDA card unless the config asks for the CPU). The optimizer is the
JAX package's ``optax.multi_transform`` of two Adams (the item Q's at
``lr``, the choice model's at ``lr_choice_model``): here one Adam state
per label, each over its own subtree, which ``learner_state`` lays out
as optax's partition state. :meth:`SlateQ.learn_on_batch` is one update.
"""

from __future__ import annotations

from itertools import combinations
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.learner_state import target_copy
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.models.catalog import mlp_apply, mlp_init
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import (as_tensor,
                                                     from_jax_params,
                                                     to_numpy)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

# The replay columns the loss reads.
_COLUMNS = ("user", "docs", "slate", "pick", "rewards", "dones",
            "next_user", "next_docs")


class SlateQConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or SlateQ)
        self.lr = 1e-3
        self.lr_choice_model = 1e-3  # reference SlateQConfig knob
        self.train_batch_size = 64
        self.replay_buffer_capacity = 20_000
        self.num_steps_sampled_before_learning_starts = 500
        self.num_train_batches_per_iteration = 64
        self.target_network_update_freq = 200
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 3000
        self.rollout_steps_per_iteration = 500
        self.fcnet_hiddens_per_candidate = (64, 32)  # reference knob

    def training(self, *, lr_choice_model=None,
                 replay_buffer_capacity=None,
                 num_steps_sampled_before_learning_starts=None,
                 num_train_batches_per_iteration=None,
                 target_network_update_freq=None, epsilon_timesteps=None,
                 rollout_steps_per_iteration=None,
                 fcnet_hiddens_per_candidate=None,
                 **kwargs) -> "SlateQConfig":
        super().training(**kwargs)
        for name, val in (
                ("lr_choice_model", lr_choice_model),
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("num_steps_sampled_before_learning_starts",
                 num_steps_sampled_before_learning_starts),
                ("num_train_batches_per_iteration",
                 num_train_batches_per_iteration),
                ("target_network_update_freq", target_network_update_freq),
                ("epsilon_timesteps", epsilon_timesteps),
                ("rollout_steps_per_iteration",
                 rollout_steps_per_iteration),
                ("fcnet_hiddens_per_candidate",
                 fcnet_hiddens_per_candidate)):
            if val is not None:
                setattr(self, name, val)
        return self


class SlateQ(Algorithm):
    _default_config_class = SlateQConfig
    _own_rollout_actors = True
    _owns_params = True
    _learner_trees = ("_target",)
    _learner_opts = {"_opt_state": {"choice": "params/choice",
                                    "q": "params/q"}}
    _learner_values = ("_grad_steps",)

    def setup(self, config: SlateQConfig) -> None:
        env = self._env_creator(config.env_config)
        self._env = env
        self.C = env.num_candidates
        self.k = env.slate_size
        self.T = env.num_topics
        self.doc_dim = self.T + 1
        self.no_click_score = env.no_click_score
        #: all unordered slates, [S, k] — the exact argmax domain.
        self.slates = np.asarray(
            list(combinations(range(self.C), self.k)), np.int32)
        self.device = resolve_device(config.device)
        self._slates = torch.from_numpy(self.slates).long().to(self.device)

        per_cand = list(config.fcnet_hiddens_per_candidate)
        in_dim = self.T + self.doc_dim  # user ++ one doc's features
        gen = torch.Generator().manual_seed(config.seed)
        self.params = {
            "q": mlp_init(gen, [in_dim, *per_cand, 1], self.device),
            "choice": mlp_init(gen, [in_dim, *per_cand, 1], self.device),
        }
        self._target = target_copy(self.params)
        self._optimizers = {"q": optim.adam(config.lr),
                            "choice": optim.adam(config.lr_choice_model)}
        self._opt_state = {
            label: init_optimizer(opt, {label: self.params[label]})
            for label, opt in self._optimizers.items()}
        self._rng = np.random.default_rng(config.seed)
        self._buffer = ReplayBuffer(config.replay_buffer_capacity,
                                    seed=config.seed)
        self._grad_steps = 0
        self._obs, _ = env.reset(seed=config.seed)
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    # -- the networks ----------------------------------------------------

    @staticmethod
    def per_item(net, user, docs):
        """user [B,T], docs [B,C,doc_dim] -> [B,C] scalars."""
        u = user[:, None, :].expand(user.shape[0], docs.shape[1],
                                    user.shape[1])
        return mlp_apply(net, torch.cat([u, docs], -1))[..., 0]

    def slate_values(self, params, user, docs):
        """Decomposed Q(s, A) for every slate A -> [B, S]."""
        q = self.per_item(params["q"], user, docs)        # [B, C]
        v = self.per_item(params["choice"], user, docs)   # [B, C]
        qs = q[:, self._slates]                           # [B, S, k]
        vs = v[:, self._slates]                           # [B, S, k]
        logits = torch.cat(
            [vs, torch.full(vs.shape[:-1] + (1,), self.no_click_score,
                            dtype=vs.dtype, device=vs.device)], -1)
        p = torch.softmax(logits, -1)[..., :-1]           # click probs
        return (p * qs).sum(-1)                           # [B, S]

    def _loss(self, params, mb):
        user, docs = mb["user"], mb["docs"]
        # Choice-model cross-entropy on observed clicks (null = k).
        v = self.per_item(params["choice"], user, docs)   # [B, C]
        slate = mb["slate"].long()
        vslate = torch.gather(v, -1, slate)               # [B, k]
        logits = torch.cat(
            [vslate, torch.full((v.shape[0], 1), self.no_click_score,
                                dtype=v.dtype, device=v.device)], -1)
        logp = torch.log_softmax(logits, -1)
        pick = mb["pick"][:, 0].long()                    # k == null
        choice_loss = -torch.gather(logp, -1, pick[:, None])[:, 0].mean()
        # Item-level TD on the clicked doc only (no click => no
        # item-level credit, per the paper's decomposition).
        q = self.per_item(params["q"], user, docs)
        clicked_doc = torch.gather(
            slate, -1, torch.clamp_max(pick, self.k - 1)[:, None])
        q_taken = torch.gather(q, -1, clicked_doc)[:, 0]
        with torch.no_grad():
            next_best = self.slate_values(
                self._target, mb["next_user"], mb["next_docs"]).max(
                    -1).values
            target = mb["rewards"][:, 0] + self.config.gamma * \
                (1.0 - mb["dones"][:, 0]) * next_best
        clicked = (pick < self.k).to(q.dtype)
        td = (q_taken - target) * clicked
        q_loss = (td ** 2).sum() / torch.clamp_min(clicked.sum(), 1.0)
        return q_loss + choice_loss, {"q_loss": q_loss,
                                      "choice_loss": choice_loss}

    def learn_on_batch(self, mb: Dict[str, Any]) -> Tuple[float, float]:
        """One step of both Adams on a replay minibatch (numpy columns, as
        the buffer samples them) on the learner's device, and every
        ``target_network_update_freq`` steps the hard target sync.
        Returns the item-Q and the choice-model losses."""
        device_mb = {k: as_tensor(v, self.device) for k, v in mb.items()
                     if k in _COLUMNS}
        grads, metrics = loss_grads(self._loss, self.params, device_mb)
        for label, opt in self._optimizers.items():
            own = {n: g for n, g in grads.items()
                   if n.startswith(label + "/")}
            self._opt_state[label] = apply_grads(
                opt, {label: self.params[label]}, self._opt_state[label],
                own)
        self._grad_steps += 1
        if self._grad_steps % self.config.target_network_update_freq == 0:
            self._target = target_copy(self.params)
        return float(metrics["q_loss"]), float(metrics["choice_loss"])

    # -- acting ----------------------------------------------------------

    def _epsilon(self) -> float:
        c: SlateQConfig = self.config
        frac = min(1.0, self._timesteps_total / max(c.epsilon_timesteps, 1))
        return c.epsilon_initial + frac * (c.epsilon_final
                                           - c.epsilon_initial)

    def compute_slate(self, obs: np.ndarray, epsilon: float = 0.0
                      ) -> np.ndarray:
        """The decomposition-argmax slate (epsilon-greedy over it)."""
        if self._rng.random() < epsilon:
            return self._rng.choice(self.C, self.k, replace=False)
        user, docs = self._env.split_obs(np.asarray(obs, np.float32))
        with torch.no_grad():
            values = self.slate_values(
                self.params, as_tensor(user[None], self.device),
                as_tensor(docs[None], self.device))
        return self.slates[int(values.argmax(-1)[0])]

    def training_step(self) -> Dict[str, Any]:
        config: SlateQConfig = self.config
        eps = self._epsilon()
        for _ in range(config.rollout_steps_per_iteration):
            user, docs = self._env.split_obs(self._obs)
            slate = self.compute_slate(self._obs, eps)
            nxt, r, term, trunc, info = self._env.step(slate)
            nuser, ndocs = self._env.split_obs(nxt)
            clicked = info.get("clicked", -1)  # slate POSITION, -1=null
            pick = clicked if clicked >= 0 else self.k
            self._episode_reward += r
            row = {"user": user, "docs": docs,
                   "slate": np.asarray(slate, np.int32),
                   "pick": np.asarray([pick], np.int32),
                   "rewards": np.asarray([r], np.float32),
                   "dones": np.asarray([float(term)], np.float32),
                   "next_user": nuser, "next_docs": ndocs}
            self._buffer.add(SampleBatch(
                {k: np.asarray(v)[None] for k, v in row.items()}))
            self._timesteps_total += 1
            if term or trunc:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self._env.reset()
            else:
                self._obs = nxt

        q_losses, c_losses = [], []
        if len(self._buffer) >= max(
                config.num_steps_sampled_before_learning_starts,
                config.train_batch_size):
            for _ in range(config.num_train_batches_per_iteration):
                ql, cl = self.learn_on_batch(
                    self._buffer.sample(config.train_batch_size))
                q_losses.append(ql)
                c_losses.append(cl)

        window = self._episode_rewards[-100:]
        return {
            "q_loss": float(np.mean(q_losses)) if q_losses else
            float("nan"),
            "choice_loss": float(np.mean(c_losses)) if c_losses else
            float("nan"),
            "epsilon": eps,
            "episode_reward_mean": (float(np.mean(window)) if window
                                    else float("nan")),
            "episodes_total": len(self._episode_rewards),
        }

    def get_weights(self):
        return {"slateq_params": to_numpy(self.params),
                "slateq_target": to_numpy(self._target)}

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights["slateq_params"], self.device)
        self._target = target_copy(from_jax_params(
            weights["slateq_target"], self.device))

    def stop(self) -> None:
        close = getattr(self._env, "close", None)
        if callable(close):
            close()
