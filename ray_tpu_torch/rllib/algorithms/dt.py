"""DT: Decision Transformer — offline RL as sequence modeling.

The port of ``ray_tpu/rllib/algorithms/dt.py`` (the reference's
rllib/algorithms/dt; Chen et al. 2021): logged episodes become sequences
of (return-to-go, observation, action) token triples; a small causal
transformer is trained to predict each action from the tokens before it.
At evaluation time the agent CONDITIONS on a high target return and
decrements it by the observed rewards as the episode unfolds.

Offline-only like bc.py: set ``config.offline_data(input_=<dir>)`` with
JsonWriter output. Discrete action spaces train with cross-entropy; Box
action spaces with MSE on tanh-squashed predictions. The transformer is
the JAX package's, written out in torch ops: learned timestep
embeddings, pre-LN blocks (LayerNorm's biased variance, eps 1e-5),
attention as a product and a softmax with a causal and padding mask over
the 3K-token interleaving (masked scores set to -1e9), GELU in its tanh
form, its parameter tree the JAX package's. It runs on ``config.device``
(the CUDA card unless the config asks for the CPU) with optax's Adam; the
minibatches are sliced on the host from a numpy generator, as the JAX
package slices them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel import optim
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (apply_grads, init_optimizer,
                                              loss_grads)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.policy.torch_policy import (action_dims, as_tensor,
                                                     from_jax_params,
                                                     to_numpy)


class DTConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DT)
        self.lr = 1e-3
        self.train_batch_size = 64
        self.num_rollout_workers = 0   # offline: WorkerSet stays empty
        self.num_train_batches_per_iteration = 50
        self.context_len = 20          # K timesteps = 3K tokens
        self.embed_dim = 64
        self.n_layers = 2
        self.n_heads = 4
        self.max_ep_len = 1000         # timestep-embedding table size
        #: return-to-go the evaluator conditions on (reference: DTConfig
        #: target_return); None = max return seen in the dataset.
        self.target_return = None
        self.rtg_scale = 100.0         # normalizes RTG token magnitudes

    def training(self, *, context_len=None, embed_dim=None, n_layers=None,
                 n_heads=None, target_return=None, rtg_scale=None,
                 num_train_batches_per_iteration=None, max_ep_len=None,
                 **kwargs) -> "DTConfig":
        super().training(**kwargs)
        for name, val in (("context_len", context_len),
                          ("embed_dim", embed_dim),
                          ("n_layers", n_layers), ("n_heads", n_heads),
                          ("target_return", target_return),
                          ("rtg_scale", rtg_scale),
                          ("max_ep_len", max_ep_len),
                          ("num_train_batches_per_iteration",
                           num_train_batches_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _ln(p, x):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["g"] + p["b"]


def init_params(gen: torch.Generator, obs_dim: int, act_dim: int,
                embed_dim: int, n_layers: int, max_ep_len: int,
                device) -> Dict[str, Any]:
    """The JAX package's tree: dense weights and the timestep table
    N(0, 0.02^2) (drawn on the host from ``gen``), zero biases, unit
    LayerNorm gains."""
    D = embed_dim

    def normal(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(
            device).requires_grad_()

    def const(value, n):
        return torch.full((n,), value, dtype=torch.float32,
                          device=device, requires_grad=True)

    def dense(din, dout):
        return {"w": normal(din, dout), "b": const(0.0, dout)}

    def ln():
        return {"g": const(1.0, D), "b": const(0.0, D)}

    params = {"embed_rtg": dense(1, D), "embed_obs": dense(obs_dim, D),
              "embed_act": dense(act_dim, D),
              "embed_t": normal(max_ep_len, D), "head": dense(D, act_dim),
              "ln_f": ln(), "blocks": []}
    for _ in range(n_layers):
        params["blocks"].append({
            "ln1": ln(), "ln2": ln(), "qkv": dense(D, 3 * D),
            "proj": dense(D, D), "fc1": dense(D, 4 * D),
            "fc2": dense(4 * D, D)})
    return params


def make_forward(n_heads: int):
    """``forward(p, rtg, obs, act, timesteps, pad_mask)``: rtg [B,K,1],
    obs [B,K,obs_dim], act [B,K,act_in], timesteps [B,K] int, pad_mask
    [B,K] -> action predictions [B,K,act_dim] read at each observation
    token (which sees rtg_t, obs_t and everything before, not act_t)."""

    def block(p, x, mask):
        B, T, D = x.shape
        h = _ln(p["ln1"], x)
        qkv = _dense(p["qkv"], h).reshape(B, T, 3, n_heads, D // n_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(
            D // n_heads)
        att = torch.where(mask, att, torch.full_like(att, -1e9))
        att = torch.softmax(att, -1)
        out = torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, D)
        x = x + _dense(p["proj"], out)
        h = _ln(p["ln2"], x)
        h = F.gelu(_dense(p["fc1"], h), approximate="tanh")
        return x + _dense(p["fc2"], h)

    def forward(p, rtg, obs, act, timesteps, pad_mask):
        B, K, _ = obs.shape
        te = p["embed_t"][timesteps.long()]
        tok_r = _dense(p["embed_rtg"], rtg) + te
        tok_o = _dense(p["embed_obs"], obs) + te
        tok_a = _dense(p["embed_act"], act) + te
        # Interleave [r_0,o_0,a_0, r_1,o_1,a_1, ...] -> [B,3K,D].
        x = torch.stack([tok_r, tok_o, tok_a], dim=2).reshape(B, 3 * K, -1)
        m = torch.repeat_interleave(pad_mask, 3, dim=-1).to(torch.bool)
        causal = torch.ones((3 * K, 3 * K), dtype=torch.bool,
                            device=x.device).tril()
        mask = causal[None, None] & m[:, None, None, :]
        for bp in p["blocks"]:
            x = block(bp, x, mask)
        x = _ln(p["ln_f"], x)
        obs_tokens = x.reshape(B, K, 3, -1)[:, :, 1]       # o_t slots
        return _dense(p["head"], obs_tokens)

    return forward


class DT(Algorithm):
    _default_config_class = DTConfig
    _owns_params = True
    _learner_trees = ()
    _learner_opts = {"_opt_state": "params"}
    _learner_values = ()

    def __init__(self, config=None, **kwargs):
        cfg = config or self.get_default_config()
        if not cfg.input_:
            raise ValueError(
                "DT is offline-only: set config.offline_data(input_=<dir "
                "of JSON experience files written by JsonWriter>)")
        super().__init__(config=config, **kwargs)

    def setup(self, config: DTConfig) -> None:
        from ray_tpu_torch.rllib.offline.json_reader import JsonReader

        pol = self.local_policy
        self.device = pol.device
        self._obs_dim = pol.obs_dim
        space = pol.action_space
        self._discrete, self._act_dim = action_dims(space)

        # Slice the dataset into episodes once, up front.
        batch = JsonReader(config.input_).read_all()
        obs = np.asarray(batch[SampleBatch.OBS], np.float32)
        acts = np.asarray(batch[SampleBatch.ACTIONS])
        if not self._discrete:
            # Normalize logged Box actions to [-1, 1] — the range
            # tanh(pred) is fit against; evaluate_env maps back.
            lo = np.asarray(space.low, np.float32).reshape(-1)
            hi = np.asarray(space.high, np.float32).reshape(-1)
            acts = 2.0 * (np.asarray(acts, np.float32).reshape(
                len(acts), -1) - lo) / np.maximum(hi - lo, 1e-8) - 1.0
        rews = np.asarray(batch[SampleBatch.REWARDS], np.float32)
        eps = np.asarray(batch[SampleBatch.EPS_ID])
        self._episodes: List[Dict[str, np.ndarray]] = []
        for e in np.unique(eps):
            idx = np.where(eps == e)[0]
            r = rews[idx]
            rtg = np.cumsum(r[::-1])[::-1].copy()  # returns-to-go
            self._episodes.append({
                "obs": obs[idx], "actions": acts[idx], "rtg": rtg,
                "timesteps": np.arange(len(idx)) % config.max_ep_len})
        self._dataset_max_return = max(
            float(ep["rtg"][0]) for ep in self._episodes)

        self.params = init_params(
            torch.Generator().manual_seed(config.seed), self._obs_dim,
            self._act_dim, config.embed_dim, config.n_layers,
            config.max_ep_len, self.device)
        self._forward = make_forward(config.n_heads)
        self._optimizer = optim.adam(config.lr)
        self._opt_state = init_optimizer(self._optimizer, self.params)
        self._rng = np.random.default_rng(config.seed)

    def _loss(self, params, mb):
        preds = self._forward(params, mb["rtg"], mb["obs"], mb["act_in"],
                              mb["timesteps"], mb["mask"])
        m = mb["mask"]
        denom = torch.clamp(m.sum(), min=1.0)
        if self._discrete:
            logp = torch.log_softmax(preds, -1)
            picked = torch.gather(logp, -1,
                                  mb["actions"][..., None].long())[..., 0]
            return -(picked * m).sum() / denom, {}
        err = ((torch.tanh(preds) - mb["actions"]) ** 2).mean(-1)
        return (err * m).sum() / denom, {}

    def _sample_minibatch(self, config: DTConfig) -> Dict[str, np.ndarray]:
        """A minibatch of context windows on the host (numpy), drawn as
        the JAX package draws it."""
        K = config.context_len
        B = config.train_batch_size
        rows = {"rtg": [], "obs": [], "actions": [], "act_in": [],
                "timesteps": [], "mask": []}
        # Episodes weighted by length (reference DT samples timesteps
        # uniformly over the dataset).
        lens = np.asarray([len(ep["obs"]) for ep in self._episodes],
                          np.float64)
        p = lens / lens.sum()
        for _ in range(B):
            ep = self._episodes[self._rng.choice(len(self._episodes), p=p)]
            T = len(ep["obs"])
            end = int(self._rng.integers(1, T + 1))
            start = max(0, end - K)
            sl = slice(start, end)
            n = end - start
            pad = K - n

            def padk(x, extra=()):
                out = np.zeros((K,) + tuple(extra), np.float32)
                v = np.asarray(x, np.float32)
                out[pad:] = v.reshape((n,) + tuple(extra))
                return out

            rows["rtg"].append(padk(ep["rtg"][sl] / config.rtg_scale,
                                    (1,)))
            rows["obs"].append(padk(ep["obs"][sl], (self._obs_dim,)))
            a = ep["actions"][sl]
            # a_t rides in its own token AFTER o_t in the interleave, so
            # the causal mask alone keeps it out of a_t's own prediction.
            if self._discrete:
                rows["actions"].append(padk(a))
                onehot = np.zeros((K, self._act_dim), np.float32)
                onehot[np.arange(pad, K), np.asarray(a, int)] = 1.0
                rows["act_in"].append(onehot)
            else:
                av = padk(a, (self._act_dim,))
                rows["actions"].append(av)
                rows["act_in"].append(av)
            ts = np.zeros(K, np.int32)
            ts[pad:] = ep["timesteps"][sl]
            rows["timesteps"].append(ts)
            m = np.zeros(K, np.float32)
            m[pad:] = 1.0
            rows["mask"].append(m)
        out = {k: np.stack(v) for k, v in rows.items()}
        if self._discrete:
            out["actions"] = out["actions"].astype(np.int32)
        return out

    def learn_on_batch(self, mb: Dict[str, np.ndarray]) -> float:
        """One Adam step on a host minibatch (:meth:`_sample_minibatch`'s
        layout) on the learner's device; returns the loss."""
        device_mb = {k: as_tensor(v, self.device) for k, v in mb.items()}
        grads, metrics = loss_grads(self._loss, self.params, device_mb)
        self._opt_state = apply_grads(self._optimizer, self.params,
                                      self._opt_state, grads)
        return float(metrics["total_loss"])

    def training_step(self) -> Dict[str, Any]:
        config: DTConfig = self.config
        losses = []
        for _ in range(config.num_train_batches_per_iteration):
            mb = self._sample_minibatch(config)
            self._timesteps_total += config.train_batch_size
            losses.append(self.learn_on_batch(mb))
        return {"loss": float(np.mean(losses)),
                "dataset_max_return": self._dataset_max_return,
                "num_batches": len(losses)}

    # -- return-conditioned rollout --------------------------------------

    def evaluate_env(self, env, target_return: float = None,
                     episodes: int = 5, seed: int = 0) -> float:
        """Roll out with return-to-go conditioning (the DT inference
        procedure): prompt with the target, decrement by observed
        rewards each step."""
        config: DTConfig = self.config
        if target_return is None:
            target_return = (config.target_return
                             if config.target_return is not None
                             else self._dataset_max_return)
        K = config.context_len
        total = 0.0
        for e in range(episodes):
            obs, _ = env.reset(seed=seed + e)
            rtg = [float(target_return)]
            obs_hist = [np.asarray(obs, np.float32).reshape(-1)]
            act_hist: List[Any] = []
            done = False
            t = 0
            while not done:
                n = min(len(obs_hist), K)
                pad = K - n
                rtg_w = np.zeros((K, 1), np.float32)
                rtg_w[pad:, 0] = np.asarray(rtg[-n:]) / config.rtg_scale
                obs_w = np.zeros((K, self._obs_dim), np.float32)
                obs_w[pad:] = np.stack(obs_hist[-n:])
                # Window timesteps t-n+1..t: every action but the final
                # one is known; the final a_t slot stays zero.
                act_w = np.zeros((K, self._act_dim), np.float32)
                prev = act_hist[-(n - 1):] if n > 1 else []
                for i, a in enumerate(prev):
                    if self._discrete:
                        act_w[pad + i, int(a)] = 1.0
                    else:
                        act_w[pad + i] = a
                ts = np.zeros(K, np.int32)
                ts[pad:] = [min(t - n + 1 + i, config.max_ep_len - 1)
                            for i in range(n)]
                m = np.zeros(K, np.float32)
                m[pad:] = 1.0
                with torch.no_grad():
                    preds = self._forward(
                        self.params, *(as_tensor(x[None], self.device)
                                       for x in (rtg_w, obs_w, act_w, ts,
                                                 m)))
                pred = preds[0, -1].cpu().numpy()
                if self._discrete:
                    action = int(pred.argmax())
                    hist_entry: Any = action
                else:
                    # Model space is the normalized [-1, 1] cube; map to
                    # env bounds only for stepping.
                    norm = np.tanh(pred)
                    space = self.local_policy.action_space
                    lo = np.asarray(space.low, np.float32)
                    hi = np.asarray(space.high, np.float32)
                    action = lo + (norm + 1.0) * 0.5 * (hi - lo)
                    hist_entry = norm
                obs, r, term, trunc, _ = env.step(action)
                done = term or trunc
                total += float(r)
                t += 1
                act_hist.append(hist_entry)
                obs_hist.append(np.asarray(obs, np.float32).reshape(-1))
                rtg.append(rtg[-1] - float(r))
        return total / episodes

    def get_weights(self):
        return {"dt_params": to_numpy(self.params)}

    def set_weights(self, weights) -> None:
        self.params = from_jax_params(weights["dt_params"], self.device)
