"""RLlib's learner on the card.

Needs a CUDA card (marker ``cuda``) and skips where there is none. The
file imports neither JAX, ``ray_tpu`` nor gymnasium (the spaces are plain
objects with the attributes the port reads), so it runs on a host that
has only PyTorch, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda_rllib.py

``TorchPolicy``'s forwards (logits, values, log-probabilities, entropy)
and one PPO update, and one ``PPOLearner.update``, on the card against
the same on the CPU from the same parameters, in fp32 with TF32 off.
"""

import types

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.algorithms import ppo
from ray_tpu_torch.rllib.core import (LearnerConfig, MLPActorCriticModule,
                                      PPOLearner, RLModuleSpec)
from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy, as_tensor

pytestmark = pytest.mark.cuda

# fp32 on the card against the CPU: summation order only.
FWD_TOL = 1e-5
# After Adam steps (Adam divides by |g|).
STEP_TOL = 1e-5

OBS = types.SimpleNamespace(shape=(4,))
DISCRETE = types.SimpleNamespace(n=2, shape=())
BOX = types.SimpleNamespace(shape=(2,))


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
