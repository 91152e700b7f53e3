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
and noise; each learner built without a device is on the card.
"""

import types

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.algorithms import (a2c, appo, bc, cql, dqn, es,
                                            impala, marwil, pg, ppo, sac,
                                            td3)
from ray_tpu_torch.rllib.algorithms.learner_state import (learner_state,
                                                          load_learner_state)
from ray_tpu_torch.rllib.offline import JsonWriter
from ray_tpu_torch.rllib.policy import make_policy
from ray_tpu_torch.rllib.policy.sac_policy import SACPolicy, TD3Policy
from ray_tpu_torch.rllib.policy.q_policy import QPolicy
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

