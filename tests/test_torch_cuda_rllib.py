"""RLlib's learner on the card.

Needs a CUDA card (marker ``cuda``) and skips where there is none. The
file imports neither JAX, ``ray_tpu`` nor gymnasium (the spaces are plain
objects with the attributes the port reads), so it runs on a host that
has only PyTorch, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda_rllib.py

``TorchPolicy``'s forwards (logits, values, log-probabilities, entropy)
and one PPO update, and one ``PPOLearner.update``, on the card against
the same on the CPU from the same parameters, in fp32 with TF32 off. Then
``QPolicy``'s, ``SACPolicy``'s and ``TD3Policy``'s forwards, and one
update of each other learner (DQN with prioritized 3-step rows, SAC, CQL,
TD3, A2C, PG, IMPALA, APPO, BC, MARWIL, ES's theta step) on the card
against the CPU from the same learner state (``learner_state``), batch
and noise; each learner built without a device is on the card. Then
``RainbowPolicy``'s (noisy and not) and ``R2D2Policy``'s forwards, and one
update of Rainbow (noisy heads on and off), R2D2, QMIX, MADDPG and SlateQ,
the same way. Then the learning gates of AlphaZero, CRR, DDPPO, Dreamer,
DT, MAML and MBMPO (marked ``slow`` too, as their CPU mirrors are) with
their learners on the card, on ``chip_smoke.py``'s numpy environments.
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.algorithms import (a2c, appo, bc, cql, dqn, es,
                                            impala, maddpg, marwil, pg, ppo,
                                            qmix, r2d2, rainbow, sac, slateq,
                                            td3)
from ray_tpu_torch.rllib.algorithms.learner_state import (flat_leaves,
                                                          learner_state,
                                                          load_learner_state)
from ray_tpu_torch.rllib.offline import JsonWriter
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.sac_policy import SACPolicy, TD3Policy
from ray_tpu_torch.rllib.policy.q_policy import QPolicy
from ray_tpu_torch.rllib.policy.r2d2_policy import R2D2Policy
from ray_tpu_torch.rllib.policy.rainbow_policy import (RainbowPolicy,
                                                       factorized)
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.core import (LearnerConfig, MLPActorCriticModule,
                                      PPOLearner, RLModuleSpec)
from ray_tpu_torch.rllib.policy.torch_policy import (TorchPolicy, as_tensor,
                                                     named_leaves)

pytestmark = pytest.mark.cuda

# fp32 on the card against the CPU: summation order only.
FWD_TOL = 1e-5
# After Adam steps (Adam divides by |g|).
STEP_TOL = 1e-5

# One SAC or CQL update on the card against the CPU: 1e-4, as
# chip_smoke.py's RLLIB_SGD_TOL. The actor head is scaled so that no row
# saturates tanh: there the log-probability's log(1 - a^2 + 1e-6) turns
# the card's and the CPU's last ulp of tanh into ~1e-1 (tests/
# test_torch_rllib_q.py's HEAD_SCALE).
UPDATE_TOL = 1e-4
HEAD_SCALE = 0.25

OBS = types.SimpleNamespace(shape=(4,))
DISCRETE = types.SimpleNamespace(n=2, shape=())
BOX = types.SimpleNamespace(shape=(2,))
OBS3 = types.SimpleNamespace(shape=(3,))
TORQUE = types.SimpleNamespace(shape=(1,), low=np.full(1, -2.0, np.float32),
                               high=np.full(1, 2.0, np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(n, discrete, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": (rng.integers(0, 2, n) if discrete
                        else rng.normal(size=(n, 2)).astype(np.float32)),
            "old_logp": rng.normal(-0.7, 0.1, n).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": rng.normal(size=n).astype(np.float32)}


def _close(a, b, tol):
    np.testing.assert_allclose(a.detach().cpu().numpy(),
                               b.detach().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("space", [DISCRETE, BOX], ids=["discrete", "box"])
def test_policy_forwards_on_the_card_match_the_cpu(cuda, space):
    pols = [TorchPolicy(4, space, (32, 32), seed=1, device=d)
            for d in ("cpu", cuda)]
    assert all(t.device.type == "cuda" for t in
               [pols[1].params["pi"][0]["w"], pols[1].params["vf"][0]["b"]])
    mb = _batch(64, space is DISCRETE)
    outs = []
    for pol in pols:
        obs = as_tensor(mb["obs"], pol.device)
        acts = as_tensor(mb["actions"], pol.device)
        outs.append([pol.logits(pol.params, obs), pol._value(pol.params, obs),
                     pol.logp(pol.params, obs, acts),
                     pol.entropy(pol.params, obs)])
    for a, b in zip(*outs):
        _close(a, b, FWD_TOL)


@pytest.mark.parametrize("space", [DISCRETE, BOX], ids=["discrete", "box"])
def test_one_ppo_update_on_the_card_matches_the_cpu(cuda, space):
    cfg = ppo.PPOConfig().training(lr=1e-3)
    weights, metrics = [], []
    for device in ("cpu", cuda):
        pol = TorchPolicy(4, space, (32, 32), seed=2, device=device)
        update, state = ppo.PPO._build_update(None, pol, cfg)
        mb = {k: as_tensor(v, pol.device)
              for k, v in _batch(128, space is DISCRETE, seed=3).items()}
        _, state, m = update(pol.params, state, mb)
        weights.append(pol.params)
        metrics.append(m)
    for k in metrics[0]:
        _close(metrics[1][k], metrics[0][k], FWD_TOL)
    for name in ("pi", "vf"):
        for a, b in zip(weights[1][name], weights[0][name]):
            _close(a["w"], b["w"], STEP_TOL)
            _close(a["b"], b["b"], STEP_TOL)


def test_one_learner_update_on_the_card_matches_the_cpu(cuda):
    spec = RLModuleSpec(MLPActorCriticModule, OBS, DISCRETE,
                        {"fcnet_hiddens": (16,)})
    batch = _batch(64, True, seed=4)
    batch["logp_old"] = batch.pop("old_logp")
    learners = [PPOLearner(spec, LearnerConfig(lr=1e-2, device=d)).build()
                for d in ("cpu", None)]
    assert learners[1].device.type == "cuda"
    got = [lr.update(batch) for lr in learners]
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=FWD_TOL,
                                   atol=FWD_TOL)
    w_cpu, w_card = (lr.get_weights() for lr in learners)
    for a, b in zip(w_card["pi"] + w_card["vf"], w_cpu["pi"] + w_cpu["vf"]):
        for key in ("w", "b"):
            np.testing.assert_allclose(a[key], b[key], rtol=STEP_TOL,
                                       atol=STEP_TOL)


# -- the value-based, actor-critic, offline and evolution learners -----------

def test_q_and_sac_policy_forwards_on_the_card_match_the_cpu(cuda):
    obs = _batch(64, True, seed=5)["obs"]
    for make in (lambda d: QPolicy(OBS, DISCRETE, {"fcnet_hiddens": (32,),
                                                  "dueling": True}, 1, d),
                 lambda d: QPolicy(OBS, DISCRETE, {"fcnet_hiddens": (32,)},
                                   1, d)):
        outs = []
        for device in ("cpu", cuda):
            pol = make(device)
            outs.append(pol.q_values(pol.params, as_tensor(obs, device)))
        assert outs[1].device.type == "cuda"
        _close(outs[1], outs[0], FWD_TOL)
    eps = torch.randn((64, 1), generator=torch.Generator().manual_seed(0))
    outs = []
    for device in ("cpu", cuda):
        pol = SACPolicy(OBS3, TORQUE, {"fcnet_hiddens": (32, 32)}, 1, device)
        x = as_tensor(obs[:, :3], device)
        a, logp = pol.sample(pol.params, x, eps.to(device) * 0.1)
        outs.append([a, logp, *pol.dist_params(pol.params, x),
                     TD3Policy.deterministic(pol, pol.params, x)])
    for a, b in zip(*outs):
        _close(a, b, FWD_TOL)


def _bare(cls, config, obs_space, act_space, device):
    """An algorithm without its runtime or workers, on ``device``."""
    algo = object.__new__(cls)
    algo.config = config
    algo.local_policy = make_policy(config.policy_config(), obs_space,
                                    act_space, seed=config.seed,
                                    device=device)
    algo.iteration = 1
    algo._timesteps_total = 0
    algo.is_multi_agent = False
    algo._env_creator = lambda _c: types.SimpleNamespace(
        observation_space=obs_space)
    algo.setup(config)
    return algo


def _rows(n, seed, kind):
    rng = np.random.default_rng(seed)
    ends = rng.random(n) < 0.05
    cols = {"obs": rng.normal(size=(n, 4 if kind == "cartpole" else 3)),
            "actions": (rng.integers(0, 2, n) if kind == "cartpole"
                        else rng.uniform(-2, 2, (n, 1))),
            "rewards": rng.normal(size=n), "terminateds": ends * 1.0,
            "truncateds": np.zeros(n), "eps_id": np.cumsum(ends),
            "action_logp": rng.normal(-0.7, 0.1, n),
            "advantages": rng.normal(size=n),
            "value_targets": rng.normal(size=n)}
    cols["new_obs"] = rng.normal(size=cols["obs"].shape)
    return SampleBatch({k: np.asarray(v, np.float32)
                        if np.asarray(v).dtype == np.float64 else v
                        for k, v in cols.items()})


def _case(name, tmp_path):
    """(config, spaces, learn(algo) -> metrics) of each learner."""
    small = {"fcnet_hiddens": [32, 32]}
    if name in ("dqn", "sac", "cql", "td3"):
        kind = "cartpole" if name == "dqn" else "pendulum"
        batch = _rows(256, 1, kind)
        if name == "dqn":
            from ray_tpu_torch.rllib.utils.replay_buffers import (
                n_step_transform)
            batch = n_step_transform(batch, 3, 0.99)
        if name == "cql":
            writer = JsonWriter(str(tmp_path))
            writer.write(batch)
            writer.close()
        cfg = {"dqn": lambda: dqn.DQNConfig().training(
                   prioritized_replay=True, n_step=3, dueling=True,
                   target_network_update_freq=1, tau=0.5, model=small),
               "sac": lambda: sac.SACConfig().training(model=small),
               "cql": lambda: cql.CQLConfig().training(
                   model=small, num_ood_actions=3).offline_data(
                       input_=str(tmp_path)),
               "td3": lambda: td3.TD3Config().training(
                   model=small, policy_delay=1)}[name]().debugging(seed=3)
        spaces = (OBS, DISCRETE) if name == "dqn" else (OBS3, TORQUE)

        def learn(algo):
            if name != "cql":
                algo._buffer.add(SampleBatch(dict(batch)))
            mb = (algo._buffer.sample(64, beta=0.4) if name == "dqn"
                  else algo._buffer.sample(64))
            # The same noise on both devices, drawn on the host.
            gen = torch.Generator().manual_seed(9)
            device = algo.local_policy.device
            if name in ("sac", "cql"):
                noise = {k: torch.randn((64, 1), generator=gen).to(device)
                         for k in ("target", "actor")}
                if name == "cql":
                    noise["rand"] = torch.rand((3, 64, 1), generator=gen)
                    noise["cur"] = torch.randn((3, 64, 1), generator=gen)
                    noise["next"] = torch.randn((3, 64, 1), generator=gen)
                    noise = {k: v.to(device) for k, v in noise.items()}
                return algo.learn_on_batch(mb, noise)
            if name == "td3":
                out = algo.learn_on_batch(mb, torch.randn(
                    (64, 1), generator=gen).to(device))
                return {k: v for k, v in out.items() if k != "td"}
            loss, _ = algo.learn_on_batch(mb)
            return {"loss": loss}

        return cfg, spaces, learn
    if name == "es":
        cfg = es.ESConfig().training(model={"fcnet_hiddens": [16]},
                                     noise_table_size=4096).debugging(seed=3)

        def learn(algo):
            rng = np.random.default_rng(4)
            dim = algo._theta.numel()
            grad, _ = algo.learn_on_returns(
                rng.integers(0, 4096 - dim, 6), rng.normal(size=6).astype(
                    np.float32), rng.normal(size=6).astype(np.float32))
            return {"grad_norm": float(np.linalg.norm(grad))}

        return cfg, (OBS, DISCRETE), learn
    cls = {"a2c": a2c.A2CConfig, "pg": pg.PGConfig,
           "impala": impala.ImpalaConfig, "appo": appo.APPOConfig,
           "bc": bc.BCConfig, "marwil": marwil.MARWILConfig}[name]
    batch = _rows(256, 2, "cartpole")
    batch["returns"] = batch["value_targets"]
    cfg = cls().training(lr=1e-3, model=small).debugging(seed=3)
    if name in ("bc", "marwil"):  # offline-only: their readers need files
        writer = JsonWriter(str(tmp_path))
        writer.write(batch)
        writer.close()
        cfg = cfg.offline_data(input_=str(tmp_path))

    def learn(algo):
        out = algo.learn_on_batch(SampleBatch(
            {k: np.array(v) for k, v in batch.items()}))
        return out if isinstance(out, dict) else {"loss": np.asarray(out)}

    return cfg, (OBS, DISCRETE), learn


LEARNERS = {"dqn": dqn.DQN, "sac": sac.SAC, "cql": cql.CQL, "td3": td3.TD3,
            "a2c": a2c.A2C, "pg": pg.PG, "impala": impala.Impala,
            "appo": appo.APPO, "bc": bc.BC, "marwil": marwil.MARWIL}


@pytest.mark.parametrize("name", sorted(LEARNERS) + ["es"])
def test_one_update_on_the_card_matches_the_cpu(cuda, tmp_path, name,
                                                 monkeypatch):
    if name == "es":  # no evaluator actors: the theta step alone
        monkeypatch.setattr(es.ray_tpu_torch, "put", lambda x: x)
        monkeypatch.setattr(es.ray_tpu_torch, "remote",
                            lambda cls: types.SimpleNamespace(
                                options=lambda **_k: types.SimpleNamespace(
                                    remote=lambda *a, **k: None)))
    cfg, spaces, learn = _case(name, tmp_path)
    cls = es.ES if name == "es" else LEARNERS[name]
    algos = [_bare(cls, cfg, *spaces, d) for d in ("cpu", None)]
    assert all(t.device.type == "cuda" for t in
               named_leaves(algos[1].local_policy.params).values())
    if name in ("sac", "cql"):
        head = algos[0].local_policy.params["head"]
        for layer in head:
            for t in layer.values():
                t.detach().mul_(HEAD_SCALE)
    load_learner_state(algos[1], learner_state(algos[0]))
    got = [learn(a) for a in algos]
    for k in got[0]:
        np.testing.assert_allclose(np.asarray(got[1][k], np.float64),
                                   np.asarray(got[0][k], np.float64),
                                   rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                   err_msg=k)
    card, cpu = learner_state(algos[1]), learner_state(algos[0])
    for key in cpu:
        for a, b in zip(named_leaves(card[key]).values(),
                        named_leaves(cpu[key]).values()):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                       err_msg=key)



# -- Rainbow, R2D2, QMIX, MADDPG and SlateQ --------------------------------

def test_rainbow_and_r2d2_forwards_on_the_card_match_the_cpu(cuda):
    """Rainbow's atom log-probabilities and Q values with noisy heads (the
    same host-drawn noise) and without; R2D2's Q values and final state
    over a window from a stored state."""
    obs = _batch(16, True, seed=6)["obs"]
    gen = torch.Generator().manual_seed(1)
    for noisy in (True, False):
        outs, noise = [], None
        for device in ("cpu", cuda):
            pol = RainbowPolicy(OBS, DISCRETE, {
                "fcnet_hiddens": (32,), "noisy": noisy, "num_atoms": 21,
                "v_min": 0.0, "v_max": 50.0}, 1, device)
            if noisy and noise is None:
                noise = pol.draw_noise(gen, 16)
            moved = None if not noisy else {
                k: tuple(t.to(device) for t in v) for k, v in noise.items()}
            x = as_tensor(obs, device)
            outs.append([pol.logits_dist(pol.params, x, moved),
                         pol.q_values(pol.params, x, moved)])
        assert outs[1][0].device.type == "cuda"
        for a, b in zip(*outs):
            _close(a, b, FWD_TOL)
    rng = np.random.default_rng(7)
    seq = rng.normal(size=(8, 6, 4)).astype(np.float32)
    h0, c0 = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    outs = []
    for device in ("cpu", cuda):
        pol = R2D2Policy(OBS, DISCRETE, {"fcnet_hiddens": (32,),
                                         "lstm_cell_size": 16}, 1, device)
        q, (h, c) = pol.q_seq(pol.params, as_tensor(seq, device),
                              as_tensor(h0, device), as_tensor(c0, device))
        outs.append([q, h, c])
    for a, b in zip(*outs):
        _close(a, b, FWD_TOL)


class _Agents:
    """Two agents as QMix and MADDPG read their environment at setup."""

    def __init__(self, obs_dim, action_space):
        self._obs = {a: np.zeros(obs_dim, np.float32) for a in ("a0", "a1")}
        self._obs_space = types.SimpleNamespace(shape=(obs_dim,))
        self._act_space = action_space

    def reset(self, seed=None):
        return dict(self._obs), {}

    def observation_space_for(self, agent_id):
        return self._obs_space

    def action_space_for(self, agent_id):
        return self._act_space


SLATES = types.SimpleNamespace(num_candidates=10, slate_size=3, num_topics=5,
                               no_click_score=1.0,
                               reset=lambda seed=None: (np.zeros(60), {}))


def _own(cls, config, env, device):
    """A learner with parameters of its own (QMix, MADDPG, SlateQ)
    without its runtime, on ``device``."""
    algo = object.__new__(cls)
    algo.config = config.resources(device=device)
    algo.local_policy = None
    algo.iteration = 1
    algo._timesteps_total = 0
    algo.is_multi_agent = False
    algo._env_creator = lambda _c: env
    algo.setup(algo.config)
    return algo


def _more_case(name):
    """(build(device) -> algo, learn(algo) -> metrics) of each learner,
    the batches and noise drawn on the host from seeds."""
    rng = np.random.default_rng(11)
    small = {"fcnet_hiddens": [32, 32]}
    if name in ("rainbow", "rainbow-noisy", "r2d2"):
        rows = _rows(512, 3, "cartpole")
        if name == "r2d2":
            cls, cfg = r2d2.R2D2, r2d2.R2D2Config().training(
                model=small, lstm_cell_size=16, burn_in=3, seq_len=8,
                target_network_update_freq=1, tau=0.5)
            for k in ("lstm_h", "lstm_c"):
                rows[k] = rng.normal(0, 0.3, (512, 16)).astype(np.float32)
        else:
            cls, cfg = rainbow.Rainbow, rainbow.RainbowConfig().training(
                model=small, noisy=name == "rainbow-noisy", num_atoms=21,
                v_min=-5.0, v_max=5.0, target_network_update_freq=1,
                tau=0.5)
        cfg = cfg.debugging(seed=3)
        # The online pass's factorized noise (adv, val heads), on the host.
        gen = torch.Generator().manual_seed(5)
        noise = {head: tuple(factorized(torch.randn((64, n), generator=gen))
                             for n in (32, out))
                 for head, out in (("adv", 2 * 21), ("val", 21))}

        def build(device):
            algo = _bare(cls, cfg, OBS, DISCRETE, device)
            algo._buffer.add(SampleBatch(dict(rows)))
            return algo

        def learn(algo):
            if name == "r2d2":
                return {"loss": algo.learn_on_batch(
                    algo._buffer.sample(16, 8))[0]}
            device = algo.local_policy.device
            return {"loss": algo.learn_on_batch(
                algo._buffer.sample(64, beta=0.4),
                {k: tuple(t.to(device) for t in v)
                 for k, v in noise.items()} if cfg.noisy else None)[0]}

        return build, learn
    if name == "qmix":
        cfg = qmix.QMixConfig().training(
            model={"fcnet_hiddens": [32]}, mixing_embed_dim=16,
            target_network_update_freq=1).debugging(seed=3)
        obs = rng.normal(size=(2, 32, 2, 3)).astype(np.float32)
        mb = {"obs": obs[0], "new_obs": obs[1],
              "actions": rng.integers(0, 3, (32, 2)),
              "rewards": rng.normal(size=32).astype(np.float32),
              "dones": (rng.random(32) < 0.2).astype(np.float32),
              "state": obs[0].reshape(32, -1),
              "new_state": obs[1].reshape(32, -1)}
        env = _Agents(3, types.SimpleNamespace(n=3, shape=()))
        return (lambda d: _own(qmix.QMix, cfg, env, d),
                lambda algo: {"loss": algo.learn_on_batch(mb)})
    if name == "maddpg":
        cfg = maddpg.MADDPGConfig().training(
            model={"fcnet_hiddens": [32]}, tau=0.1).debugging(seed=3)
        mb = {"rewards": rng.normal(size=(64, 2)).astype(np.float32),
              "dones": (rng.random((64, 1)) < 0.1).astype(np.float32)}
        for j in range(2):
            for k in ("obs", "new_obs"):
                mb[f"{k}_{j}"] = rng.normal(size=(64, 6)).astype(np.float32)
            mb[f"act_{j}"] = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
        env = _Agents(6, types.SimpleNamespace(
            shape=(2,), low=np.full(2, -1.0, np.float32),
            high=np.full(2, 1.0, np.float32)))
        return (lambda d: _own(maddpg.MADDPG, cfg, env, d),
                lambda algo: dict(zip(("critic_loss", "actor_loss"),
                                      algo.learn_on_batch(mb))))
    cfg = slateq.SlateQConfig().training(
        lr_choice_model=3e-3, target_network_update_freq=1).debugging(seed=3)
    user = rng.dirichlet(np.full(5, 0.5), (2, 32)).astype(np.float32)
    docs = rng.random((2, 32, 10, 6)).astype(np.float32)
    mb = {"user": user[0], "docs": docs[0], "next_user": user[1],
          "next_docs": docs[1],
          "slate": np.stack([rng.choice(10, 3, replace=False)
                             for _ in range(32)]).astype(np.int32),
          "pick": rng.integers(0, 4, (32, 1)).astype(np.int32),
          "rewards": rng.random((32, 1)).astype(np.float32),
          "dones": (rng.random((32, 1)) < 0.2).astype(np.float32)}
    return (lambda d: _own(slateq.SlateQ, cfg, SLATES, d),
            lambda algo: dict(zip(("q_loss", "choice_loss"),
                                  algo.learn_on_batch(mb))))


def _learned(algo):
    return algo.params if algo._owns_params else algo.local_policy.params


@pytest.mark.parametrize("name", ["rainbow", "rainbow-noisy", "r2d2", "qmix",
                                  "maddpg", "slateq"])
def test_one_more_update_on_the_card_matches_the_cpu(cuda, name):
    """One update of each on the card against the CPU from the same
    learner state (``learner_state``: SlateQ's two Adams as optax's
    multi_transform state, MADDPG's per-agent lists), batch and noise;
    built without a device, each learner is on the card."""
    build, learn = _more_case(name)
    algos = [build("cpu"), build(None)]
    assert all(t.device.type == "cuda"
               for t in named_leaves(_learned(algos[1])).values())
    load_learner_state(algos[1], learner_state(algos[0]))
    got = [learn(a) for a in algos]
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=UPDATE_TOL,
                                   atol=UPDATE_TOL, err_msg=k)
    card, cpu = learner_state(algos[1]), learner_state(algos[0])
    for key in cpu:
        for a, b in zip(flat_leaves(card[key]), flat_leaves(cpu[key])):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                       err_msg=key)


# -- the learning gates of AlphaZero, CRR, DDPPO, Dreamer, DT, MAML, MBMPO ----

_CHIP_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def stand_ins():
    """``chip_smoke.py``'s environments in numpy (the card's machine has
    no gymnasium), loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_stand_ins",
                                                  _CHIP_SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def cluster():
    import ray_tpu_torch
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()


def _tuned_learns(name, env):
    """``run_tuned_example`` with the tuned example's environment swapped
    for ``env`` and its learner on the card: (passed, best reward)."""
    from ray_tpu_torch.rllib.tuned_examples import TUNED_EXAMPLES
    ex = TUNED_EXAMPLES[name]
    algo = ex.build_config().environment(env).resources(device=None).build()
    best = float("-inf")
    try:
        for _ in range(ex.max_iters):
            last = algo.train().get("episode_reward_mean", float("nan"))
            if last == last and last > best:
                best = last
            if best >= ex.stop_reward:
                break
    finally:
        algo.stop()
    return best >= ex.stop_reward, best


@pytest.mark.slow
def test_tuned_alphazero_learns_on_the_card(cuda, cluster, stand_ins):
    """tests/test_rllib_alphazero_crr_ddppo.py's gate on the card, on the
    numpy clonable CartPole."""
    passed, best = _tuned_learns("cartpole-alphazero",
                                 stand_ins._ClonableCartPole)
    assert passed, best


@pytest.mark.slow
def test_crr_learns_from_mixed_data_on_the_card(cuda, cluster, stand_ins,
                                                tmp_path):
    """A good CartPole policy (eval >= 150) out of half-random logged data
    (the gate's 50 episodes, written from the numpy CartPole)."""
    from ray_tpu_torch.rllib import CRRConfig
    stand_ins._rllib_offline_cartpole(str(tmp_path), stand_ins._CartPole,
                                      episodes=50)
    algo = (CRRConfig().environment(stand_ins._CartPole)
            .offline_data(input_=str(tmp_path)).debugging(seed=0)).build()
    assert algo.local_policy.device.type == "cuda"
    best = 0.0
    for i in range(40):
        algo.train()
        if i % 10 == 9:
            best = max(best, algo.evaluate()["episode_reward_mean"])
            if best >= 150.0:
                break
    algo.stop()
    assert best >= 150.0, best


@pytest.mark.slow
def test_tuned_ddppo_learns_on_the_card(cuda, cluster, stand_ins):
    """The two workers learn on the card, half a card each."""
    passed, best = _tuned_learns("cartpole-ddppo", stand_ins._CartPole)
    assert passed, best


@pytest.mark.slow
def test_tuned_dreamer_learns_on_the_card(cuda, cluster, stand_ins):
    passed, best = _tuned_learns("pointgoal-dreamer", stand_ins._PointGoal)
    assert passed, best


@pytest.mark.slow
def test_dt_return_conditioning_learns_on_the_card(cuda, cluster, stand_ins,
                                                   tmp_path):
    """Conditioning on a high return extracts the good behavior from
    mixed-quality data (the gate's 20 heuristic and 20 random episodes);
    conditioning low tracks the low target."""
    from ray_tpu_torch.rllib import DTConfig
    stand_ins._rllib_offline_cartpole(str(tmp_path), stand_ins._CartPole,
                                      episodes=40)
    algo = (DTConfig().environment(stand_ins._CartPole)
            .offline_data(input_=str(tmp_path))
            .training(lr=1e-3, train_batch_size=64, context_len=20,
                      num_train_batches_per_iteration=50)
            .debugging(seed=0)).build()
    for _ in range(5):
        res = algo.train()
    assert res["loss"] < 0.45
    env = stand_ins._CartPole()
    high = algo.evaluate_env(env, target_return=200.0, episodes=3,
                             seed=100)
    low = algo.evaluate_env(env, target_return=20.0, episodes=3, seed=100)
    algo.stop()
    assert high > 100.0, (high, low)
    assert high > low + 50.0, (high, low)


@pytest.mark.slow
def test_maml_learns_to_adapt_on_the_card(cuda, cluster, stand_ins):
    """After meta-training, one inner step on fresh hidden-goal tasks lands
    at a strong absolute level."""
    from ray_tpu_torch.rllib import MAMLConfig
    algo = (MAMLConfig().environment(stand_ins._PointGoal)
            .training(task_sampler=stand_ins._goal_sampler, inner_lr=0.05,
                      lr=5e-3, inner_steps=3, episodes_per_inner_batch=8,
                      tasks_per_iteration=5)
            .debugging(seed=0)).build()
    posts = [algo.train()["post_adaptation_return"] for _ in range(25)]
    assert np.mean(posts[-5:]) > np.mean(posts[:5]) - 15.0, posts
    rng = np.random.default_rng(123)
    outs = []
    for _ in range(8):
        env = stand_ins._PointGoal({"goal": float(rng.uniform(-2.5, 2.5))})
        outs.append(algo._collect(env, algo.adapt(env), 8)[3])
    algo.stop()
    assert float(np.mean(outs)) > -65.0, outs


@pytest.mark.slow
def test_mbmpo_learns_from_imagination_on_the_card(cuda, cluster,
                                                   stand_ins):
    """Real return climbs from random (~-60) past -25 within 15
    iterations, the ensemble and the policy on the card."""
    from ray_tpu_torch.rllib import MBMPOConfig
    algo = (MBMPOConfig().environment(stand_ins._PointGoal)
            .debugging(seed=0)).build()
    best = -1e9
    for _ in range(15):
        r = algo.train()["episode_reward_mean"]
        if r == r:
            best = max(best, r)
    algo.stop()
    assert best > -25.0, best
