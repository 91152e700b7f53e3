"""Dreamer (V1): learning behaviors by latent imagination.

The port of ``ray_tpu/rllib/algorithms/dreamer.py`` (the reference's
rllib/algorithms/dreamer; Hafner et al. 2020): a recurrent state-space
world model (RSSM) is trained on replayed sequences, and the policy is
trained entirely INSIDE the model: the actor unrolls imagined
trajectories through the learned dynamics and maximizes lambda-returns of
predicted rewards, backpropagating through the reparameterized latent
transitions; the value function supplies the bootstrap.

Pieces (all Gaussian, the V1 formulation; MLP encoder and decoder for
vector observations, as in the JAX package):
  * RSSM: deterministic GRU path ``h_t = f(h_{t-1}, [z_{t-1}, a_{t-1}])``
    with stochastic state ``z_t``: prior ``p(z_t | h_t)`` for imagination,
    posterior ``q(z_t | h_t, enc(o_t))`` for filtering.
  * World-model loss: reconstruction MSE + reward MSE +
    max(KL(q || p), free_nats).
  * Behavior: tanh-Gaussian actor and value MLP on ``[h, z]``; imagined
    H-step rollouts from every posterior state; TD(lambda) returns; the
    actor ascends them, the value regresses them (detached).

One update takes three gradients over three parameter sets in the JAX
package's order (world model, then the actor through the stepped model,
then the critic against the stepped actor), each with its own optax Adam,
on ``config.device`` (the CUDA card unless the config asks for the CPU).
Each ``jax.lax.scan`` is a loop over time. The JAX update draws its
normals inside the jit; here they are drawn on the host (a CPU
``torch.Generator``, :meth:`Dreamer.draw_noise`) and passed in, so the
same noise reaches every device. Box action spaces only, read by their
``low``/``high`` attributes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.models.catalog import mlp_apply, mlp_init
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import (action_dims, as_tensor,
                                                     from_jax_params,
                                                     to_numpy)


class DreamerConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or Dreamer)
        self.lr = 6e-4              # world model
        self.actor_lr = 8e-5
        self.critic_lr = 8e-5
        self.deter_dim = 128        # GRU state
        self.stoch_dim = 16         # z
        self.hidden_dim = 128       # MLPs
        self.batch_size = 32        # sequences per world-model batch
        self.seq_len = 16
        self.imagine_horizon = 12
        self.free_nats = 1.0
        self.kl_coeff = 1.0
        self.lambda_ = 0.95
        self.explore_noise = 0.3
        self.num_train_batches_per_iteration = 40
        self.rollout_steps_per_iteration = 400
        self.prefill_steps = 1000   # random steps before learning
        self.replay_capacity_steps = 50_000
        #: env steps per policy decision (rewards sum across the repeat).
        self.action_repeat = 2

    def training(self, *, actor_lr=None, critic_lr=None, deter_dim=None,
                 stoch_dim=None, hidden_dim=None, seq_len=None,
                 imagine_horizon=None, free_nats=None, kl_coeff=None,
                 explore_noise=None, prefill_steps=None,
                 action_repeat=None,
                 rollout_steps_per_iteration=None,
                 num_train_batches_per_iteration=None,
                 **kwargs) -> "DreamerConfig":
        super().training(**kwargs)
        for name, val in (
                ("actor_lr", actor_lr), ("critic_lr", critic_lr),
                ("deter_dim", deter_dim), ("stoch_dim", stoch_dim),
                ("hidden_dim", hidden_dim), ("seq_len", seq_len),
                ("imagine_horizon", imagine_horizon),
                ("free_nats", free_nats), ("kl_coeff", kl_coeff),
                ("explore_noise", explore_noise),
                ("prefill_steps", prefill_steps),
                ("action_repeat", action_repeat),
                ("rollout_steps_per_iteration",
                 rollout_steps_per_iteration),
                ("num_train_batches_per_iteration",
                 num_train_batches_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self


# -- the model, functional in its parameters ---------------------------------

def gru(p, h, x):
    gx = mlp_apply(p["gru_x"], x)
    gh = mlp_apply(p["gru_h"], h)
    xr, xu, xc = torch.chunk(gx, 3, dim=-1)
    hr, hu, hc = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    cand = torch.tanh(xc + r * hc)
    return u * h + (1 - u) * cand


def _stats(raw):
    mean, std = torch.chunk(raw, 2, dim=-1)
    return mean, F.softplus(std) + 0.1


def prior_of(p, h):
    return _stats(mlp_apply(p["prior"], h))


def post_of(p, h, emb):
    return _stats(mlp_apply(p["post"], torch.cat([h, emb], -1)))


def rssm_observe(p, obs_seq, act_seq, noise):
    """obs [B,T,obs], act [B,T,act] (a_t taken AFTER o_t), ``noise``
    [T,B,Z] standard normals -> posterior features [B,T,D+Z] and the KL
    terms [B,T]."""
    B, T = obs_seq.shape[:2]
    D = p["gru_h"][0]["w"].shape[0]
    emb = mlp_apply(p["enc"], obs_seq)
    h = obs_seq.new_zeros((B, D))
    feats, kls = [], []
    for t in range(T):
        pm, ps = prior_of(p, h)
        qm, qs = post_of(p, h, emb[:, t])
        zq = qm + qs * noise[t]
        kls.append((torch.log(ps / qs)
                    + (qs ** 2 + (qm - pm) ** 2) / (2 * ps ** 2)
                    - 0.5).sum(-1))
        feats.append(torch.cat([h, zq], -1))
        h = gru(p, h, torch.cat([zq, act_seq[:, t]], -1))
    return torch.stack(feats, 1), torch.stack(kls, 1)


def actor_sample(ap, feat, eps):
    mean, std = _stats(mlp_apply(ap, feat))
    return torch.tanh(mean + std * eps)


def imagine(p, ap, feat0, noise):
    """Roll the PRIOR forward under the actor from [N,D+Z] starts, with
    ``noise`` {"act": [H,N,A], "z": [H,N,Z]}; differentiable through z
    (reparameterized) for the actor gradient -> [N,H,D+Z]."""
    D = p["gru_h"][0]["w"].shape[0]
    h, z = feat0[..., :D], feat0[..., D:]
    feats = []
    for eps_a, eps_z in zip(noise["act"], noise["z"]):
        a = actor_sample(ap, torch.cat([h, z], -1), eps_a)
        h = gru(p, h, torch.cat([z, a], -1))
        pm, ps = prior_of(p, h)
        z = pm + ps * eps_z
        feats.append(torch.cat([h, z], -1))
    return torch.stack(feats, 1)


def lambda_returns(rew, values, gamma: float, lam: float):
    """rew/values [B,H] along imagined states s_0..s_{H-1}:
    G_t = r_t + gamma*((1-lam)*V(s_{t+1}) + lam*G_{t+1}),
    seeded G_{H-1} = r_{H-1} + gamma*V(s_{H-1})."""
    H = rew.shape[1]
    ret = rew[:, -1] + gamma * values[:, -1]
    rets = [ret]
    for idx in range(H - 2, -1, -1):
        ret = rew[:, idx] + gamma * (
            (1 - lam) * values[:, idx + 1] + lam * ret)
        rets.append(ret)
    return torch.stack(rets[::-1], 1)


class Dreamer(Algorithm):
    _default_config_class = DreamerConfig
    _own_rollout_actors = True
    _owns_params = True
    _learner_trees = ("actor_params", "critic_params")
    _learner_opts = {"_wm_state": "params", "_actor_state": "actor_params",
                     "_critic_state": "critic_params"}
    _learner_values = ()

    def setup(self, config: DreamerConfig) -> None:
        from ray_tpu_torch.rllib.utils.replay_buffers import (
            SequenceReplayBuffer)

        env = self._env_creator(config.env_config)
        space = env.action_space
        if action_dims(space)[0] or not hasattr(space, "low"):
            raise ValueError(
                "Dreamer supports Box action spaces (the reference is "
                "likewise continuous-control only)")
        self._env = env
        self.device = resolve_device(config.device)
        self.obs_dim = int(np.prod(env.observation_space.shape))
        self.act_dim = int(np.prod(space.shape))
        self._act_lo = np.asarray(space.low, np.float32)
        self._act_hi = np.asarray(space.high, np.float32)
        D, Z, H = config.deter_dim, config.stoch_dim, config.hidden_dim
        A, dev = self.act_dim, self.device

        gen = torch.Generator().manual_seed(config.seed)
        self.params = {
            "enc": mlp_init(gen, [self.obs_dim, H, H], dev),
            # GRU over input [z, a] with state h.
            "gru_x": mlp_init(gen, [Z + A, 3 * D], dev),
            "gru_h": mlp_init(gen, [D, 3 * D], dev),
            "prior": mlp_init(gen, [D, H, 2 * Z], dev),
            "post": mlp_init(gen, [D + H, H, 2 * Z], dev),
            "dec": mlp_init(gen, [D + Z, H, H, self.obs_dim], dev),
            "rew": mlp_init(gen, [D + Z, H, 1], dev),
        }
        self.actor_params = mlp_init(gen, [D + Z, H, H, 2 * A], dev)
        self.critic_params = mlp_init(gen, [D + Z, H, H, 1], dev)
        self._wm_opt = optim.adam(config.lr)
        self._actor_opt = optim.adam(config.actor_lr)
        self._critic_opt = optim.adam(config.critic_lr)
        self._wm_state = init_optimizer(self._wm_opt, self.params)
        self._actor_state = init_optimizer(self._actor_opt,
                                           self.actor_params)
        self._critic_state = init_optimizer(self._critic_opt,
                                            self.critic_params)
        self._D, self._Z = D, Z
        # The update's and the filter's normals, drawn on the host.
        self._noise_gen = torch.Generator().manual_seed(config.seed + 5)
        self._buffer = SequenceReplayBuffer(
            capacity_episodes=max(
                config.replay_capacity_steps // 50, 64),
            seed=config.seed)
        self._rng = np.random.default_rng(config.seed)
        self._episode_rewards: List[float] = []
        self._reset_episode_state()

    def _reset_episode_state(self) -> None:
        self._obs, _ = self._env.reset()
        self._h = np.zeros(self._D, np.float32)
        self._z = np.zeros(self._Z, np.float32)
        self._a_prev = np.zeros(self.act_dim, np.float32)
        self._episode_reward = 0.0
        self._episode_rows: List[dict] = []

    # -- the update ------------------------------------------------------

    def draw_noise(self, batch: int, seq_len: int
                   ) -> Dict[str, Any]:
        """One update's standard normals on the host: the filter's
        posterior samples ("observe", [T,B,Z]) and, for the actor's and
        the critic's imagination from the B*T posterior states, the
        action and latent draws of each step ({"act": [H,N,A], "z":
        [H,N,Z]})."""
        config: DreamerConfig = self.config
        H, N = config.imagine_horizon, batch * seq_len

        def normal(*shape):
            return torch.randn(shape, generator=self._noise_gen)

        out: Dict[str, Any] = {"observe": normal(seq_len, batch, self._Z)}
        for part in ("actor", "critic"):
            out[part] = {"act": normal(H, N, self.act_dim),
                         "z": normal(H, N, self._Z)}
        return out

    def _wm_loss(self, p, mb, noise):
        config: DreamerConfig = self.config
        feats, kls = rssm_observe(p, mb["obs"], mb["actions"], noise)
        recon = mlp_apply(p["dec"], feats)
        rew = mlp_apply(p["rew"], feats)[..., 0]
        m = mb["mask"]
        denom = torch.clamp(m.sum(), min=1.0)
        recon_loss = (((recon - mb["obs"]) ** 2).mean(-1) * m).sum() / denom
        rew_loss = (((rew - mb["rewards"]) ** 2) * m).sum() / denom
        kl = torch.clamp((kls * m).sum() / denom, min=config.free_nats)
        return (recon_loss + rew_loss + config.kl_coeff * kl,
                {"recon_loss": recon_loss, "reward_loss": rew_loss,
                 "kl": kl, "feats": feats})

    def _imagined(self, ap, cp, starts, noise):
        """The imagined features, predicted rewards, values and
        lambda-returns from ``starts`` under the actor ``ap``."""
        config: DreamerConfig = self.config
        imag = imagine(self.params, ap, starts, noise)
        rew = mlp_apply(self.params["rew"], imag)[..., 0]
        values = mlp_apply(cp, imag)[..., 0]
        return imag, lambda_returns(rew, values, config.gamma,
                                    config.lambda_)

    def _actor_loss(self, ap, starts, noise):
        _, rets = self._imagined(ap, self.critic_params, starts, noise)
        return -rets.mean(), {}

    def _critic_loss(self, cp, starts, noise):
        with torch.no_grad():
            imag, rets = self._imagined(self.actor_params, cp, starts,
                                        noise)
        return ((mlp_apply(cp, imag)[..., 0] - rets) ** 2).mean(), {}

    def learn_on_batch(self, mb: Dict[str, np.ndarray],
                       noise: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, float]:
        """One update on a replayed minibatch of sequences (numpy
        ``obs``, ``actions``, ``rewards``, ``mask``, [B,T,...]) with
        ``noise`` (:meth:`draw_noise`'s layout, drawn when None): the
        world model's step; the actor's through the stepped model from
        the (detached) posterior states; the critic's against the stepped
        actor."""
        dev = self.device
        device_mb = {k: as_tensor(mb[k], dev)
                     for k in ("obs", "actions", "rewards", "mask")}
        B, T = device_mb["obs"].shape[:2]
        if noise is None:
            noise = self.draw_noise(B, T)
        noise = {k: (v.to(dev) if isinstance(v, torch.Tensor)
                     else {n: t.to(dev) for n, t in v.items()})
                 for k, v in noise.items()}

        wg, wm = loss_grads(
            lambda p, b: self._wm_loss(p, b, noise["observe"]), self.params,
            device_mb)
        starts = wm.pop("feats").reshape(B * T, -1)
        self._wm_state = apply_grads(self._wm_opt, self.params,
                                     self._wm_state, wg)
        ag, am = loss_grads(
            lambda ap, s: self._actor_loss(ap, s, noise["actor"]),
            self.actor_params, starts)
        self._actor_state = apply_grads(self._actor_opt, self.actor_params,
                                        self._actor_state, ag)
        cg, cm = loss_grads(
            lambda cp, s: self._critic_loss(cp, s, noise["critic"]),
            self.critic_params, starts)
        self._critic_state = apply_grads(self._critic_opt,
                                         self.critic_params,
                                         self._critic_state, cg)
        return {"wm_loss": float(wm["total_loss"]),
                "recon_loss": float(wm["recon_loss"]),
                "reward_loss": float(wm["reward_loss"]),
                "kl": float(wm["kl"]),
                "actor_loss": float(am["total_loss"]),
                "critic_loss": float(cm["total_loss"])}

    # -- acting ----------------------------------------------------------

    def _filter_and_act(self, obs, eps_z, eps_a):
        """Advance (h, z) with the posterior on ``obs`` and sample the
        actor there: the new h, z and the squashed action."""
        dev = self.device
        p = self.params
        with torch.no_grad():
            h = torch.from_numpy(self._h[None]).to(dev)
            z = torch.from_numpy(self._z[None]).to(dev)
            a_prev = torch.from_numpy(self._a_prev[None]).to(dev)
            h = gru(p, h, torch.cat([z, a_prev], -1))
            emb = mlp_apply(p["enc"], as_tensor(
                np.asarray(obs, np.float32).reshape(1, -1), dev))
            qm, qs = post_of(p, h, emb)
            z = qm + qs * eps_z.to(dev)
            a = actor_sample(self.actor_params, torch.cat([h, z], -1),
                             eps_a.to(dev))
            return (h[0].cpu().numpy(), z[0].cpu().numpy(),
                    a[0].cpu().numpy())

    def compute_single_action(self, obs, explore: bool = False,
                              policy_id=None):
        eps_z = torch.randn((1, self._Z), generator=self._noise_gen)
        eps_a = torch.randn((1, self.act_dim), generator=self._noise_gen)
        self._h, self._z, a = self._filter_and_act(obs, eps_z, eps_a)
        if explore:
            a = np.clip(a + self.config.explore_noise *
                        self._rng.standard_normal(a.shape), -1, 1)
        return self._act_lo + (a + 1.0) * 0.5 * (self._act_hi -
                                                 self._act_lo)

    def evaluate(self) -> Dict[str, Any]:
        """Noise-free episodes on a fresh env with a fresh filter state
        (the base evaluate would thread the collection episode's
        recurrent state into evaluation)."""
        saved = (self._env, self._obs, self._h, self._z, self._a_prev,
                 self._episode_reward, self._episode_rows)
        eval_env = self._env_creator(self.config.env_config)
        rewards = []
        try:
            for e in range(3):
                self._env = eval_env
                self._obs, _ = eval_env.reset(seed=10_000 + e)
                self._h = np.zeros(self._D, np.float32)
                self._z = np.zeros(self._Z, np.float32)
                self._a_prev = np.zeros(self.act_dim, np.float32)
                total, done = 0.0, False
                while not done:
                    a = self.compute_single_action(self._obs)
                    self._obs, r, term, trunc, _ = eval_env.step(
                        np.asarray(a, np.float32))
                    norm = 2.0 * (a - self._act_lo) / np.maximum(
                        self._act_hi - self._act_lo, 1e-8) - 1.0
                    self._a_prev = np.asarray(norm,
                                              np.float32).reshape(-1)
                    total += float(r)
                    done = term or trunc
                rewards.append(total)
        finally:
            close = getattr(eval_env, "close", None)
            if callable(close):
                close()
            (self._env, self._obs, self._h, self._z, self._a_prev,
             self._episode_reward, self._episode_rows) = saved
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episodes_this_eval": len(rewards)}

    def training_step(self) -> Dict[str, Any]:
        config: DreamerConfig = self.config
        for _ in range(config.rollout_steps_per_iteration):
            if self._timesteps_total < config.prefill_steps:
                action = self._env.action_space.sample()
            else:
                action = self.compute_single_action(self._obs,
                                                    explore=True)
            norm_a = 2.0 * (action - self._act_lo) / np.maximum(
                self._act_hi - self._act_lo, 1e-8) - 1.0
            r, term, trunc = 0.0, False, False
            for _ in range(max(config.action_repeat, 1)):
                nxt, r_i, term, trunc, _ = self._env.step(
                    np.asarray(action, np.float32))
                r += float(r_i)
                if term or trunc:
                    break
            self._episode_rows.append({
                "obs": np.asarray(self._obs, np.float32).reshape(-1),
                "actions": np.asarray(norm_a, np.float32).reshape(-1),
                "rewards": np.float32(r),
                "terminateds": np.float32(term)})
            self._episode_reward += float(r)
            self._timesteps_total += 1
            self._obs = nxt
            self._a_prev = np.asarray(norm_a, np.float32).reshape(-1)
            if term or trunc:
                rows = self._episode_rows
                batch = SampleBatch({
                    k: np.stack([row[k] for row in rows])
                    for k in rows[0]})
                batch["eps_id"] = np.full(
                    len(rows), len(self._episode_rewards), np.int64)
                self._buffer.add(batch)
                self._episode_rewards.append(self._episode_reward)
                self._reset_episode_state()

        metrics: Dict[str, Any] = {}
        if self._timesteps_total >= config.prefill_steps and \
                len(self._buffer) >= config.batch_size * config.seq_len:
            for _ in range(config.num_train_batches_per_iteration):
                mb = self._buffer.sample(config.batch_size,
                                         seq_len=config.seq_len)
                metrics = self.learn_on_batch(mb)

        window = self._episode_rewards[-100:]
        metrics.update({
            "episode_reward_mean": (float(np.mean(window)) if window
                                    else float("nan")),
            "episodes_total": len(self._episode_rewards),
        })
        return metrics

    def get_weights(self):
        return {"wm": to_numpy(self.params),
                "actor": to_numpy(self.actor_params),
                "critic": to_numpy(self.critic_params)}

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights["wm"], self.device)
        self.actor_params = from_jax_params(weights["actor"], self.device)
        self.critic_params = from_jax_params(weights["critic"],
                                             self.device)

    def stop(self) -> None:
        close = getattr(self._env, "close", None)
        if callable(close):
            close()
